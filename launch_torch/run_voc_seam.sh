#!/bin/bash
# SEAM-style equivariance-regularised training of WRN38 +
# CAM_CASA_WGAP_tf with the PyTorch/CUDA port (wseg_tpu_torch).
# SNAPSHOT=eNNNXsS.SSS resumes from that snapshot; DEVICE=cpu runs on
# the CPU (the default, cuda, needs a card).
EXP=${EXP:-seam_wrn38}
RUN_ID=${RUN_ID:-v01}
DEVICE=${DEVICE:-cuda}

CMD="python -m wseg_tpu_torch.train_SEAM --dataset pascal_voc \
     --cfg configs/voc_resnet38.yaml --exp $EXP --run $RUN_ID --device $DEVICE"
if [ -n "${SNAPSHOT:-}" ]; then
  EPOCH=$(echo "$SNAPSHOT" | sed -E 's/e0*([0-9]+)Xs.*/\1/')
  CMD="$CMD --resume $SNAPSHOT --start_epoch $EPOCH"
fi

echo "$CMD $*"
$CMD "$@"
