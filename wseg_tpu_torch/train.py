"""Training entry point of the port (same flags as the root ``train.py``,
plus ``--device``).

    python -m wseg_tpu_torch.train --dataset pascal_voc \\
        --cfg configs/voc_resnet38.yaml --exp EXP --run RUN \\
        [--resume eNNNXsS.SSS] [--set KEY VALUE ...] [--device cuda]

Runs ``TRAIN.NUM_EPOCHS + 1`` epochs from ``--start_epoch`` (or the
resumed epoch), each a train epoch then validation; the best
validation proxy score is checkpointed under ``--snapshot-dir``.
"""

from __future__ import annotations

import sys

import torch

from wseg_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
from wseg_tpu_torch.opts import get_arguments
from wseg_tpu_torch.utils.timer import Timer


def main(argv):
    args = get_arguments(argv)
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    print("Config:\n", cfg)
    # float32 products stay float32 (bfloat16 compute is autocast's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from wseg_tpu_torch.engine.trainer import DecTrainer
    trainer = DecTrainer(args)
    timer = Timer()

    def time_call(func, msg, *a, **kw):
        timer.reset_stage()
        func(*a, **kw)
        print(msg + " {:3.2f}m".format(timer.get_stage_elapsed() / 60.0))

    for epoch in range(trainer.start_epoch,
                       int(cfg.TRAIN.NUM_EPOCHS) + 1):
        print("Epoch >>> ", epoch, flush=True)
        time_call(trainer.train_epoch, "Train epoch: ", epoch)
        time_call(trainer.validation, "Validation /   Val: ", epoch,
                  checkpoint=True)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
