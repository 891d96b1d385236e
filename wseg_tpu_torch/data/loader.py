"""Batched loading of ``VOCSegmentation`` with ``torch.utils.data``.

Counterpart of ``wseg_tpu/data/loader.py`` + ``get_dataloader``: a
``DataLoader`` with a seeded sampler (shuffled, last partial batch
dropped for training; in order, all of it for validation) and a collate
that yields ``image`` (B, H, W, 3) uint8, ``labels`` (B, C-1) float32,
``jitter`` (B, 9) float32 when the dataset samples device jitter, and
the host-only ``name`` and ``mask``.  Worker processes each reseed the
dataset's augmentation rng from the loader's seeded generator, so
workers never repeat one another's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from wseg_tpu_torch.data.pascal_voc import VOCSegmentation


def collate(samples):
    batch = {
        "image": torch.from_numpy(np.stack([s[0] for s in samples])),
        "labels": torch.from_numpy(
            np.stack([s[1] for s in samples]).astype(np.float32)),
        "name": [s[2] for s in samples],
        "mask": torch.from_numpy(np.stack([s[3] for s in samples])),
    }
    if len(samples[0]) > 4:
        batch["jitter"] = torch.from_numpy(
            np.stack([s[4] for s in samples]).astype(np.float32))
    return batch


def _reseed_worker(worker_id: int) -> None:
    info = torch.utils.data.get_worker_info()
    info.dataset.rng = np.random.RandomState(info.seed % (2 ** 32))


def get_dataloader(args, cfg, split: str):
    """Training loader for ``cfg.DATASET.FILENAME``, validation loader
    for ``val_voc`` (as the JAX ``get_dataloader`` is called)."""
    train = split != "val_voc"
    seed = int(getattr(args, "random_seed", 0))
    dataset = VOCSegmentation(
        cfg.DATASET, split, augment=train, seed=seed,
        device_jitter=bool(getattr(cfg.DATASET, "DEVICE_JITTER", False)))
    gen = torch.Generator().manual_seed(seed)
    sampler = (torch.utils.data.RandomSampler(dataset, generator=gen)
               if train else torch.utils.data.SequentialSampler(dataset))
    workers = max(0, int(getattr(args, "workers", 0) or 0))
    return torch.utils.data.DataLoader(
        dataset, batch_size=int(cfg.TRAIN.BATCH_SIZE),
        sampler=sampler, drop_last=train, num_workers=workers,
        collate_fn=collate, generator=gen,
        worker_init_fn=_reseed_worker if workers else None,
        persistent_workers=False,
        pin_memory=str(getattr(args, "device", "cpu")).startswith("cuda"))
