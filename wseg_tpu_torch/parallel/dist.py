"""Multi-process data parallelism: one device per process.

Counterpart of the ``data`` axis of ``wseg_tpu/parallel/mesh.py``.
There, one jitted program shards each global batch over the devices
and XLA all-reduces the gradients.  Here each device has a process of
its own, launched by ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node N``), which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``:

- rank ``r`` of ``W`` takes rows ``[r B / W, (r + 1) B / W)`` of each
  global batch of ``B`` rows (``rank_rows``; the loader's
  ``GlobalBatchSampler`` draws the same rows);
- the trainer all-reduces the gradients in one flat buffer and divides
  by ``W`` (``all_reduce_grads``); the live BatchNorms reduce their
  statistics over the ranks (``models/backbones/common.BatchNorm``);
- a serving process serves its own share of the image list.

Without ``torchrun``'s environment the world is one process and no
process group is made; every helper then does nothing or returns its
input.  The backend is ``nccl`` for a CUDA device and ``gloo`` for the
CPU.  Left out against the JAX mesh: the ``space`` axis (every caller
keeps it at 1), the multi-slice device order and the XLA sharding
helpers.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def launch_env():
    """(rank, world size, local rank) from ``torchrun``'s environment,
    or None outside it."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ.get("RANK", "0"))
    return (rank, int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", str(rank))))


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    return rank() == 0


def print_main(*args, **kwargs) -> None:
    """``print`` on rank 0 only."""
    if is_main():
        print(*args, **kwargs)


def barrier() -> None:
    if initialized():
        dist.barrier()


def init(rank: Optional[int] = None, world: Optional[int] = None,
         backend: Optional[str] = None, device=None,
         init_method: Optional[str] = None) -> bool:
    """Join the process group; returns True if this call made it.

    With no ``rank`` and ``world`` they come from ``torchrun``'s
    environment (``env://`` rendezvous); outside it, and when a group
    already exists, nothing is made.  ``backend`` defaults to ``nccl``
    for a CUDA ``device`` and ``gloo`` otherwise; tests pass an explicit
    ``file://`` ``init_method``."""
    if initialized():
        return False
    if rank is None or world is None:
        env = launch_env()
        if env is None:
            return False
        rank, world = env[0], env[1]
    device = torch.device("cpu" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl" and device.index is not None:
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=int(rank), world_size=int(world), **kw)
    return True


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


@contextmanager
def process_group(device):
    """``init`` from ``torchrun``'s environment for ``device`` around the
    block, and ``destroy`` after it if this made the group."""
    made = init(device=device)
    try:
        yield
    finally:
        if made:
            destroy()


def rank_rows(x, rank_: Optional[int] = None,
              world: Optional[int] = None):
    """This rank's rows ``[r B / W, (r + 1) B / W)`` of the global batch
    ``x`` (a tensor, array or list).  A batch of ``B`` not divisible by
    ``W`` (a ragged last validation batch) is split at ``floor(r B /
    W)``, so a rank may get no row."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    b = len(x)
    return x[r * b // w:(r + 1) * b // w]


def _all_reduce_flat(tensors: Sequence[torch.Tensor]) -> None:
    """Sum every tensor over the ranks in place, with one collective for
    each (dtype, device): the tensors are packed into one flat buffer."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the
    ranks (what ``torch.distributed.nn.functional.all_reduce`` does)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (the gradient of each
    rank's input is the sum of the ranks' output gradients); ``x``
    itself without a group."""
    return _AllReduceSum.apply(x) if initialized() else x


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """Average the gradients of ``params`` over the ranks in place
    (sum, then divide by the world size); a no-op without a group."""
    if not initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    _all_reduce_flat(grads)
    w = world_size()
    for g in grads:
        g.div_(w)


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The means over the ranks of ``tensors`` (new tensors; the inputs
    themselves without a group)."""
    if not initialized():
        return list(tensors)
    out = [t.detach().clone() for t in tensors]
    _all_reduce_flat(out)
    w = world_size()
    return [t.div_(w) for t in out]


def all_gather_objects(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order: ``[obj]``
    without a group.  Goes through host memory under ``gloo`` and the
    current CUDA device under ``nccl``."""
    if not initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def build_first(names: Sequence[str], device) -> None:
    """Build the native libraries ``names`` (``csrc/<name>``) on rank 0
    while the other ranks wait, so that concurrent ranks do not compile
    the same source at once; a no-op without a group or off the card."""
    if not initialized() or torch.device(device).type != "cuda":
        return
    from wseg_tpu_torch import _build

    if is_main():
        with ThreadPoolExecutor(max(1, len(names))) as pool:
            for fut in [pool.submit(_build.build, n) for n in names]:
                fut.result()
    barrier()
