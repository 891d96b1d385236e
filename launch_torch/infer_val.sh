#!/bin/bash
# Multi-scale mask inference from a snapshot with the PyTorch/CUDA port.
# CFG picks the model's config (configs/voc_resnet50.yaml for the ae
# ResNet-50); SNAPSHOT is a suffix the port's trainer wrote under
# snapshots/pascal_voc/$EXP/$RUN_ID, or a .pth path.  NPROC=N serves on
# N GPUs of this node through torchrun: one replica a GPU, each on its
# share of the image list.
EXP=${EXP:-ae_r50}
RUN_ID=${RUN_ID:-v01}
CFG=${CFG:-configs/voc_resnet50.yaml}
SNAPSHOT=${SNAPSHOT:?set SNAPSHOT=eNNNXsS.SSS or a .pth path}
FILELIST=${FILELIST:-./data/val_voc.txt}
OUTPUT_DIR=${OUTPUT_DIR:-results/$EXP/$RUN_ID}
DEVICE=${DEVICE:-cuda}
# "--" keeps torchrun's parser off the module's flags (on Python 3.12.3
# it reads --run as an abbreviation of its own --run-path)
if [ -n "${NPROC:-}" ]; then
  LAUNCH="python -m torch.distributed.run --standalone --nproc_per_node $NPROC -m --"
else
  LAUNCH="python -m"
fi

$LAUNCH wseg_tpu_torch.infer_val --dataset pascal_voc --cfg "$CFG" \
    --exp "$EXP" --run "$RUN_ID" --resume "$SNAPSHOT" \
    --infer-list "$FILELIST" --mask-output-dir "$OUTPUT_DIR" \
    --device "$DEVICE" "$@"
