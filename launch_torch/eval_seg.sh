#!/bin/bash
# Score produced masks against GT with the port's eval_seg (host only).
# MASKS is a directory of predicted PNGs, e.g. results/ae_r50/v01_0/crf.
DATA=${DATA:-./data}
FILELIST=${FILELIST:-./data/val_voc.txt}
MASKS=${MASKS:?set MASKS=<dir with predicted PNGs>}

python -m wseg_tpu_torch.eval_seg --data "$DATA" --filelist "$FILELIST" \
    --masks "$MASKS" "$@"
