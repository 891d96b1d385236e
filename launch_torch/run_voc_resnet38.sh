#!/bin/bash
# Train the flagship WRN38 + CAM_CASA_WGAP_tf model
# with the PyTorch/CUDA port (wseg_tpu_torch) on VOC+SBD.
# SNAPSHOT=eNNNXsS.SSS resumes from that snapshot; DEVICE=cpu runs on
# the CPU (the default, cuda, needs a card).  NPROC=N trains on N GPUs
# of this node through torchrun, one process each (N must divide
# TRAIN.BATCH_SIZE, the global batch).
EXP=${EXP:-tf_wrn38}
RUN_ID=${RUN_ID:-v01}
DEVICE=${DEVICE:-cuda}
# "--" keeps torchrun's parser off the module's flags (on Python 3.12.3
# it reads --run as an abbreviation of its own --run-path)
if [ -n "${NPROC:-}" ]; then
  LAUNCH="python -m torch.distributed.run --standalone --nproc_per_node $NPROC -m --"
else
  LAUNCH="python -m"
fi

CMD="$LAUNCH wseg_tpu_torch.train --dataset pascal_voc \
     --cfg configs/voc_resnet38.yaml --exp $EXP --run $RUN_ID --device $DEVICE"
if [ -n "${SNAPSHOT:-}" ]; then
  EPOCH=$(echo "$SNAPSHOT" | sed -E 's/e0*([0-9]+)Xs.*/\1/')
  CMD="$CMD --resume $SNAPSHOT --start_epoch $EPOCH"
fi

echo "$CMD $*"
$CMD "$@"
