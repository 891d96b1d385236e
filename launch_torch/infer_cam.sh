#!/bin/bash
# Grad-CAM mask inference from a snapshot with the PyTorch/CUDA port.
# SNAPSHOT is a suffix the port's trainer wrote under
# snapshots/pascal_voc/$EXP/$RUN_ID, or a .pth path; METHOD is one of
# infer_cam's --method choices.
EXP=${EXP:-tf_wrn38}
RUN_ID=${RUN_ID:-v01}
CFG=${CFG:-configs/voc_resnet38.yaml}
SNAPSHOT=${SNAPSHOT:?set SNAPSHOT=eNNNXsS.SSS or a .pth path}
METHOD=${METHOD:-gradcam}
FILELIST=${FILELIST:-./data/val_voc.txt}
OUTPUT_DIR=${OUTPUT_DIR:-results/cam_$METHOD}
DEVICE=${DEVICE:-cuda}

python -m wseg_tpu_torch.infer_cam --dataset pascal_voc --cfg "$CFG" \
    --exp "$EXP" --run "$RUN_ID" --resume "$SNAPSHOT" --method "$METHOD" \
    --infer-list "$FILELIST" --mask-output-dir "$OUTPUT_DIR" \
    --device "$DEVICE" "$@"
