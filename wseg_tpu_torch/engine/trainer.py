"""Epoch-level training loop (mirror of ``wseg_tpu/engine/trainer.py``,
the reference DecTrainer).

Builds the loaders, the model (float32 parameters, ``NET.DTYPE``
compute under autocast; ``int8`` is inference-only and raises), the
4-group SGD or Adam and the checkpoint ring; runs the train-epoch /
validation-mAP / checkpoint-best cycle with a loss line every 10 steps.
``--profile-dir`` traces steps 10-20 of the first epoch with
``torch.profiler`` and writes a Chrome trace there.  Left out (absent,
see ROADMAP.md queue A): the device mesh (one device per process) and
the fixed-batch TensorBoard panels and scalars.  The ``ae``
decoder's live BatchNorms update their running statistics in the train
epoch and normalise with them in validation (``.eval()``); they are
buffers of the model's state_dict, so checkpoints and ``--resume``
carry them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wseg_tpu_torch.config import cfg
from wseg_tpu_torch.data.loader import get_dataloader
from wseg_tpu_torch.engine.train_loop import (
    eval_step,
    expected_batch_keys,
    train_step,
)
from wseg_tpu_torch.models import get_model
from wseg_tpu_torch.models.backbones.common import (
    INT8_TRAIN_ERROR,
    seeded_init_,
    set_generator,
    stabilize_scratch_init,
)
from wseg_tpu_torch.optim import make_optimizer
from wseg_tpu_torch.opts import get_device
from wseg_tpu_torch.utils.checkpoints import (
    Checkpoint,
    make_suffix,
    parse_suffix,
)
from wseg_tpu_torch.utils.convert import load_pretrained_backbone
from wseg_tpu_torch.utils.metrics import average_precision
from wseg_tpu_torch.utils.stat_manager import StatManager
from wseg_tpu_torch.utils.timer import Timer


def build_train_model(device, seed: int = 64):
    """The trainer's model on ``device``: pretrained backbone from
    ``NET.PRE_WEIGHTS_PATH`` when that file exists, else seeded weights
    with the residual branches' last convs zeroed (SkipInit, as the JAX
    trainer's ``stabilize_scratch_init``); dropout, channel dropout and
    the stochastic gate draw from one generator on ``device`` seeded
    with ``seed``."""
    model = get_model(cfg.NET, num_classes=21, train=True)
    seeded_init_(model, torch.Generator().manual_seed(seed))
    pre = str(cfg.NET.PRE_WEIGHTS_PATH)
    if pre and os.path.isfile(pre):
        load_pretrained_backbone(model, pre)
    else:
        print("WARNING: no pretrained weights at %r; applying scratch-init "
              "stabilisation (zero residual-branch output convs)" % pre)
        stabilize_scratch_init(model, 0.0)
    model = model.to(device)
    set_generator(model, torch.Generator(device=device).manual_seed(seed))
    return model


# steps of the first epoch that --profile-dir traces (both included)
PROFILE_STEPS = (10, 20)


def start_profile(device) -> torch.profiler.profile:
    """A started ``torch.profiler`` of the host and, on a card, its
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def write_profile(prof, device, profile_dir: str, epoch: int) -> str:
    """Stop ``prof`` and write its Chrome trace into ``profile_dir``."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_epoch{epoch}.json")
    prof.export_chrome_trace(path)
    print("Profiler trace written to", profile_dir, flush=True)
    return path


class DecTrainer:
    def __init__(self, args):
        self.args = args
        if str(getattr(cfg.NET, "DTYPE", "")) == "int8":
            # round() in the quantized convs has zero gradient: the head
            # would learn while the backbone silently receives nothing
            raise ValueError(INT8_TRAIN_ERROR)
        self.device = get_device(args)
        self.start_epoch = int(getattr(args, "start_epoch", 0))

        self.trainloader = get_dataloader(args, cfg, cfg.DATASET.FILENAME)
        self.valloader = get_dataloader(args, cfg, "val_voc")
        self.model = build_train_model(self.device,
                                       int(getattr(args, "random_seed", 64)))
        self.optimizer, self.param_labels = make_optimizer(cfg.NET,
                                                           self.model)
        self.device_jitter = bool(cfg.DATASET.DEVICE_JITTER)
        # global-norm clip of the trainable gradients; 0 (default) = off
        self.grad_clip = float(cfg.NET.GRAD_CLIP)
        self.loss_kw = dict(
            loss_name=str(cfg.NET.LOSS),
            attn_loss_weight=20.0 if getattr(args, "isattention", False)
            else 0.0,
            mask_loss_bce=float(cfg.NET.MASK_LOSS_BCE))

        self.checkpoint = Checkpoint(args.snapshot_dir, max_n=5)
        self.best_score = -1e16
        if getattr(args, "resume", None):
            if self.checkpoint.load(args.resume, self.model, self.optimizer):
                epoch, score = parse_suffix(args.resume)
                self.best_score = score
                if self.start_epoch == 0:
                    self.start_epoch = epoch
                print(f"Resumed from {args.resume} (epoch {epoch})")

    def _device_batch(self, batch, train: bool):
        """The keys the configuration implies, moved to the device (the
        steps raise if one of them is missing)."""
        keys = expected_batch_keys(self.device_jitter, train)
        return {k: batch[k].to(self.device, non_blocking=True)
                for k in keys if k in batch}

    @staticmethod
    def _flush(pending, stat):
        """One device-to-host transfer for the pending metric rows;
        returns the last row."""
        if not pending:
            return {}
        keys = sorted(pending[0])
        vals = torch.stack([m[k].float() for m in pending
                            for k in keys]).cpu().tolist()
        row = {}
        for j in range(len(pending)):
            row = {k: vals[j * len(keys) + i] for i, k in enumerate(keys)}
            for k, v in row.items():
                stat.update_stats(k, v)
        pending.clear()
        return row

    def _train_step(self, batch, epoch: int):
        """One step on device ``batch``: the mask loss off while ``epoch
        < TRAIN.PRETRAIN``."""
        mask_on = 0.0 if epoch < int(cfg.TRAIN.PRETRAIN) else 1.0
        return train_step(self.model, self.optimizer, batch, mask_on,
                          device_jitter=self.device_jitter,
                          grad_clip=self.grad_clip, **self.loss_kw)

    def train_epoch(self, epoch: int):
        self.model.train()
        stat = StatManager()
        timer = Timer("New Epoch: ")
        bs = int(cfg.TRAIN.BATCH_SIZE)
        pending = []
        profile_dir = (getattr(self.args, "profile_dir", "")
                       if epoch == self.start_epoch else "")
        prof = None
        for i, batch in enumerate(self.trainloader):
            if profile_dir and i == PROFILE_STEPS[0]:
                prof = start_profile(self.device)
            pending.append(self._train_step(
                self._device_batch(batch, train=True), epoch))
            if prof is not None and i == PROFILE_STEPS[1]:
                write_profile(prof, self.device, profile_dir, epoch)
                prof = None
            if i % 10 == 0:
                last = self._flush(pending, stat)
                msg = "Epoch[{}] Loss [{:04d}]: ".format(epoch, i)
                for k in sorted(last):
                    msg += "{}: {:.4f} | ".format(k, last[k])
                ips = (i + 1) * bs / timer.get_stage_elapsed()
                print(msg + " | Im/Sec: {:.1f}".format(ips), flush=True)
        if prof is not None:  # an epoch shorter than the traced steps
            write_profile(prof, self.device, profile_dir, epoch)
        self._flush(pending, stat)
        for k in stat.vals:
            print("{}: {:4.3f}".format(k, stat.summarize_key(k)))

    def validation(self, epoch: int, checkpoint: bool = False) -> float:
        self.model.eval()
        stat = StatManager()
        pending, scores, targets = [], [], []
        for i, batch in enumerate(self.valloader):
            db = self._device_batch(batch, train=False)
            metrics, cls = eval_step(self.model, db, **self.loss_kw)
            pending.append(metrics)
            scores.append(cls.float())
            targets.append(batch["labels"].numpy())
            if (i + 1) % 10 == 0:
                self._flush(pending, stat)
        self._flush(pending, stat)
        self.model.train()

        preds = torch.sigmoid(torch.cat(scores)).cpu().numpy()
        targets = np.concatenate(targets)
        mean_ap = float(np.mean(average_precision(targets, preds)))
        print("mAP: {:4.3f}".format(mean_ap))
        if checkpoint and epoch >= int(cfg.TRAIN.PRETRAIN):
            self.checkpoint_best(1.0 - stat.summarize_key("loss"), epoch)
        return mean_ap

    def checkpoint_best(self, score: float, epoch: int) -> bool:
        """Save when the proxy score (1 - validation loss) improves."""
        if score <= self.best_score:
            return False
        self.best_score = score
        suffix = make_suffix(epoch, score)
        self.checkpoint.checkpoint(suffix, self.model, self.optimizer)
        print("Saved checkpoint", suffix)
        return True
