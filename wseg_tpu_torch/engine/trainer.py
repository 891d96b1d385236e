"""Epoch-level training loop (mirror of ``wseg_tpu/engine/trainer.py``,
the reference DecTrainer).

Builds the loaders, the model (float32 parameters, ``NET.DTYPE``
compute under autocast; ``int8`` is inference-only and raises), the
4-group SGD or Adam and the checkpoint ring; runs the train-epoch /
validation-mAP / checkpoint-best cycle with a loss line every 10 steps.
``--profile-dir`` traces steps 10-20 of the first epoch with
``torch.profiler`` and writes a Chrome trace there.  Left out (absent,
see ROADMAP.md queue A): the fixed-batch TensorBoard panels and
scalars.

Under ``torchrun`` (``parallel/dist.py``; the entry points make the
process group) each rank trains on its rows of every global batch of
``TRAIN.BATCH_SIZE`` on its own device, with the gradients averaged and
the live BatchNorms' statistics taken over the ranks; a world size that
does not divide the batch raises (JAX idles the devices left over).
Rank 0 builds the kernels first, and alone prints and writes
checkpoints; every rank validates its share and the metrics, scores and
targets are gathered, so the mAP and the checkpoint score are one
process's.  ``--resume`` loads on every rank onto its device, and
``--profile-dir`` writes one trace per rank.  The ``ae``
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
from wseg_tpu_torch.parallel import dist
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
    with ``seed`` + the process's rank (the weights are the same on
    every rank, the draws are not)."""
    model = get_model(cfg.NET, num_classes=21, train=True)
    seeded_init_(model, torch.Generator().manual_seed(seed))
    pre = str(cfg.NET.PRE_WEIGHTS_PATH)
    if pre and os.path.isfile(pre):
        load_pretrained_backbone(model, pre)
    else:
        dist.print_main(
            "WARNING: no pretrained weights at %r; applying scratch-init "
            "stabilisation (zero residual-branch output convs)" % pre)
        stabilize_scratch_init(model, 0.0)
    model = model.to(device)
    set_generator(model, torch.Generator(device=device).manual_seed(
        seed + dist.rank()))
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
    rank = f"_rank{dist.rank()}" if dist.initialized() else ""
    path = os.path.join(profile_dir, f"trace_epoch{epoch}{rank}.json")
    prof.export_chrome_trace(path)
    print("Profiler trace written to", path, flush=True)
    return path


def batch_divisor_error(batch_size: int, world: int) -> str:
    """The refusal of a world size that does not divide the batch."""
    divisors = [d for d in range(1, batch_size + 1) if batch_size % d == 0]
    return (f"TRAIN.BATCH_SIZE {batch_size} (the global batch) is not "
            f"divisible by the world size {world}: launch a number of "
            f"processes that divides it ({', '.join(map(str, divisors))})")


def merge_rank_validation(parts):
    """One process's validation from every rank's share.

    ``parts[r]`` is rank ``r``'s (rows of each validation batch, the
    metric rows of its non-empty batches, sigmoid scores, targets).
    Returns (``StatManager`` with one row a batch, each metric the mean
    over the global batch's rows, scores, targets) with the rows in one
    process's order: rank ``r``'s rows of batch ``j`` follow rank
    ``r - 1``'s.  One part gives its own rows back exactly (n v / n is
    v for a float32 metric v and a batch's n rows)."""
    stat = StatManager()
    preds, targets = [], []
    row_at = [0] * len(parts)
    off = [0] * len(parts)
    for j in range(len(parts[0][0])):
        sums, total = {}, 0
        for r, (n_rows, rows, p, t) in enumerate(parts):
            n = n_rows[j]
            if not n:
                continue
            for k, v in rows[row_at[r]].items():
                sums[k] = sums.get(k, 0.0) + n * v
            row_at[r] += 1
            total += n
            preds.append(p[off[r]:off[r] + n])
            targets.append(t[off[r]:off[r] + n])
            off[r] += n
        for k, v in sums.items():
            stat.update_stats(k, v / total)
    return stat, np.concatenate(preds), np.concatenate(targets)


class DecTrainer:
    def __init__(self, args):
        self.args = args
        if str(getattr(cfg.NET, "DTYPE", "")) == "int8":
            # round() in the quantized convs has zero gradient: the head
            # would learn while the backbone silently receives nothing
            raise ValueError(INT8_TRAIN_ERROR)
        self.device = get_device(args)
        world = dist.world_size()
        if int(cfg.TRAIN.BATCH_SIZE) % world:
            raise ValueError(batch_divisor_error(int(cfg.TRAIN.BATCH_SIZE),
                                                 world))
        self.start_epoch = int(getattr(args, "start_epoch", 0))

        self.trainloader = get_dataloader(args, cfg, cfg.DATASET.FILENAME)
        self.valloader = get_dataloader(args, cfg, "val_voc")
        self.model = build_train_model(self.device,
                                       int(getattr(args, "random_seed", 64)))
        # the train step's PAMR kernels, built once for all ranks
        dist.build_first(["pamr"], self.device)
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
            dist.barrier()
            if self.checkpoint.load(args.resume, self.model, self.optimizer,
                                    map_location=self.device):
                epoch, score = parse_suffix(args.resume)
                self.best_score = score
                if self.start_epoch == 0:
                    self.start_epoch = epoch
                dist.print_main(f"Resumed from {args.resume} (epoch {epoch})")

    def _device_batch(self, batch, train: bool):
        """The keys the configuration implies, moved to the device (the
        steps raise if one of them is missing)."""
        keys = expected_batch_keys(self.device_jitter, train)
        return {k: batch[k].to(self.device, non_blocking=True)
                for k in keys if k in batch}

    @staticmethod
    def _fetch(pending):
        """One device-to-host transfer for the pending metric rows,
        returned as dicts of floats."""
        if not pending:
            return []
        keys = sorted(pending[0])
        vals = torch.stack([m[k].float() for m in pending
                            for k in keys]).cpu().tolist()
        rows = [{k: vals[j * len(keys) + i] for i, k in enumerate(keys)}
                for j in range(len(pending))]
        pending.clear()
        return rows

    @staticmethod
    def _flush(pending, stat):
        """``_fetch`` the pending metric rows into ``stat``; returns the
        last row."""
        rows = DecTrainer._fetch(pending)
        for row in rows:
            for k, v in row.items():
                stat.update_stats(k, v)
        return rows[-1] if rows else {}

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
        timer = Timer("New Epoch: " if dist.is_main() else "")
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
                # bs is the global batch: images a second of all ranks
                ips = (i + 1) * bs / timer.get_stage_elapsed()
                dist.print_main(msg + " | Im/Sec: {:.1f}".format(ips),
                                flush=True)
        if prof is not None:  # an epoch shorter than the traced steps
            write_profile(prof, self.device, profile_dir, epoch)
        self._flush(pending, stat)
        for k in stat.vals:
            dist.print_main("{}: {:4.3f}".format(k, stat.summarize_key(k)))

    def validation(self, epoch: int, checkpoint: bool = False) -> float:
        """The validation losses and mAP (over every rank's rows); with
        ``checkpoint``, ``checkpoint_best`` of 1 - the loss."""
        self.model.eval()
        n_rows, rows, pending, scores, targets = [], [], [], [], []
        for i, batch in enumerate(self.valloader):
            if batch is None:   # no row of a ragged last batch here
                n_rows.append(0)
                continue
            db = self._device_batch(batch, train=False)
            metrics, cls = eval_step(self.model, db, **self.loss_kw)
            n_rows.append(len(batch["name"]))
            pending.append(metrics)
            scores.append(cls.float())
            targets.append(batch["labels"].numpy())
            if (i + 1) % 10 == 0:
                rows += self._fetch(pending)
        rows += self._fetch(pending)
        self.model.train()

        nc = int(cfg.TEST.NUM_CLASSES) - 1
        preds = (torch.sigmoid(torch.cat(scores)).cpu().numpy() if scores
                 else np.zeros((0, nc), np.float32))
        targets = (np.concatenate(targets) if targets
                   else np.zeros((0, nc), np.float32))
        stat, preds, targets = merge_rank_validation(
            dist.all_gather_objects((n_rows, rows, preds, targets)))
        mean_ap = float(np.mean(average_precision(targets, preds)))
        dist.print_main("mAP: {:4.3f}".format(mean_ap))
        if checkpoint and epoch >= int(cfg.TRAIN.PRETRAIN):
            self.checkpoint_best(1.0 - stat.summarize_key("loss"), epoch)
        return mean_ap

    def checkpoint_best(self, score: float, epoch: int) -> bool:
        """Save when the proxy score (1 - validation loss) improves; in a
        process group rank 0 alone writes (every rank keeps the best
        score)."""
        if score <= self.best_score:
            return False
        self.best_score = score
        if dist.is_main():
            suffix = make_suffix(epoch, score)
            self.checkpoint.checkpoint(suffix, self.model, self.optimizer)
            print("Saved checkpoint", suffix)
        return True
