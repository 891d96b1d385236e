"""SEAM training entry point of the port (same flags as the root
``train_SEAM.py``, plus ``--device``).

    python -m wseg_tpu_torch.train_SEAM --dataset pascal_voc \\
        --cfg configs/voc_resnet38.yaml --exp EXP --run RUN \\
        [--resume eNNNXsS.SSS] [--set KEY VALUE ...] [--device cuda]

The port's trainer (``engine/trainer.DecTrainer``) with the SEAM step
(``engine/seam.seam_train_step``): a 0.5x-scale second forward and the
equivariance-regularisation loss.  The mask loss is off while ``epoch <
TRAIN.PRETRAIN`` and the second classification loss and the ER loss
while ``epoch < TRAIN.PRETRAIN + 5``.  Each of the ``TRAIN.NUM_EPOCHS +
1`` epochs validates (and checkpoints the best proxy score) BEFORE it
trains (reference train_SEAM.py:356-365).
"""

from __future__ import annotations

import sys

import torch

from wseg_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
from wseg_tpu_torch.engine.seam import seam_train_step
from wseg_tpu_torch.engine.trainer import DecTrainer
from wseg_tpu_torch.opts import get_arguments
from wseg_tpu_torch.utils.timer import Timer


class SEAMTrainer(DecTrainer):
    """``DecTrainer`` whose train epoch takes SEAM steps (metrics
    flushed every 10 steps, as ``DecTrainer.train_epoch`` does)."""

    def _train_step(self, batch, epoch: int):
        pretrain = int(cfg.TRAIN.PRETRAIN)
        return seam_train_step(
            self.model, self.optimizer, batch,
            0.0 if epoch < pretrain else 1.0,
            0.0 if epoch < pretrain + 5 else 1.0,
            device_jitter=self.device_jitter, grad_clip=self.grad_clip,
            **self.loss_kw)


def main(argv):
    args = get_arguments(argv)
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    print("Config:\n", cfg)
    # float32 products stay float32 (bfloat16 compute is autocast's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    trainer = SEAMTrainer(args)
    timer = Timer()

    def time_call(func, msg, *a, **kw):
        timer.reset_stage()
        func(*a, **kw)
        print(msg + " {:3.2f}m".format(timer.get_stage_elapsed() / 60.0))

    for epoch in range(trainer.start_epoch,
                       int(cfg.TRAIN.NUM_EPOCHS) + 1):
        print("Epoch >>> ", epoch, flush=True)
        time_call(trainer.validation, "Validation /   Val: ", epoch,
                  checkpoint=True)
        time_call(trainer.train_epoch, "Train epoch: ", epoch)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
