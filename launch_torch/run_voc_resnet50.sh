#!/bin/bash
# Train the paper's SoftMaxAE (NET.MODEL ae) on ResNet-50
# with the PyTorch/CUDA port (wseg_tpu_torch) on VOC+SBD.
# SNAPSHOT=eNNNXsS.SSS resumes from that snapshot; DEVICE=cpu runs on
# the CPU (the default, cuda, needs a card).
EXP=${EXP:-ae_r50}
RUN_ID=${RUN_ID:-v01}
DEVICE=${DEVICE:-cuda}

CMD="python -m wseg_tpu_torch.train --dataset pascal_voc \
     --cfg configs/voc_resnet50.yaml --exp $EXP --run $RUN_ID --device $DEVICE"
if [ -n "${SNAPSHOT:-}" ]; then
  EPOCH=$(echo "$SNAPSHOT" | sed -E 's/e0*([0-9]+)Xs.*/\1/')
  CMD="$CMD --resume $SNAPSHOT --start_epoch $EPOCH"
fi

echo "$CMD $*"
$CMD "$@"
