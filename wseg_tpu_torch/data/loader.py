"""Batched loading of ``VOCSegmentation`` with ``torch.utils.data``.

Counterpart of ``wseg_tpu/data/loader.py`` + ``get_dataloader``: a
``DataLoader`` whose ``GlobalBatchSampler`` draws global batches of
``TRAIN.BATCH_SIZE`` (shuffled by a seeded permutation, last partial
batch dropped for training; in order, all of it for validation) and
yields this rank's rows of each (``parallel.dist.rank_rows``): the
ranks' rows, concatenated in rank order, are one process's batches.
The collate yields ``image`` (B, H, W, 3) uint8, ``labels`` (B, C-1)
float32, ``jitter`` (B, 9) float32 when the dataset samples device
jitter, and the host-only ``name`` and ``mask``; a rank with no row of
a ragged last validation batch gets ``None``.  The augmentation rng is
seeded with ``seed + rank``, and worker processes each reseed it from
the loader's generator (also seeded with ``seed + rank``), so neither
workers nor ranks repeat one another's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from wseg_tpu_torch.data.pascal_voc import VOCSegmentation
from wseg_tpu_torch.parallel import dist


class GlobalBatchSampler(torch.utils.data.Sampler):
    """Global batches of ``batch_size`` indices of ``range(n)``, each
    cut to rank ``rank``'s rows of ``world``.  Every rank draws the same
    permutation from ``generator`` (seeded alike on every rank) when
    ``shuffle``; ``drop_last`` drops a last partial global batch, so
    every rank yields the same number of batches."""

    def __init__(self, n: int, batch_size: int, shuffle: bool,
                 drop_last: bool, generator=None, rank: int = 0,
                 world: int = 1):
        super().__init__()
        self.n, self.batch_size = int(n), int(batch_size)
        self.shuffle, self.drop_last = shuffle, drop_last
        self.generator = generator
        self.rank, self.world = int(rank), int(world)

    def __iter__(self):
        order = (torch.randperm(self.n, generator=self.generator).tolist()
                 if self.shuffle else list(range(self.n)))
        stop = self.n - self.n % self.batch_size if self.drop_last \
            else self.n
        for i in range(0, stop, self.batch_size):
            yield dist.rank_rows(order[i:i + self.batch_size], self.rank,
                                 self.world)

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)


def collate(samples):
    if not samples:
        return None
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
    for ``val_voc`` (as the JAX ``get_dataloader`` is called), yielding
    this rank's rows of each global batch of ``TRAIN.BATCH_SIZE``."""
    train = split != "val_voc"
    seed = int(getattr(args, "random_seed", 0))
    rank, world = dist.rank(), dist.world_size()
    dataset = VOCSegmentation(
        cfg.DATASET, split, augment=train, seed=seed + rank,
        device_jitter=bool(getattr(cfg.DATASET, "DEVICE_JITTER", False)))
    sampler = GlobalBatchSampler(
        len(dataset), int(cfg.TRAIN.BATCH_SIZE), shuffle=train,
        drop_last=train, generator=torch.Generator().manual_seed(seed),
        rank=rank, world=world)
    workers = max(0, int(getattr(args, "workers", 0) or 0))
    return torch.utils.data.DataLoader(
        dataset, batch_sampler=sampler, num_workers=workers,
        collate_fn=collate,
        generator=torch.Generator().manual_seed(seed + rank),
        worker_init_fn=_reseed_worker if workers else None,
        persistent_workers=False,
        pin_memory=str(getattr(args, "device", "cpu")).startswith("cuda"))
