"""PAMR affinity and propagation: CUDA kernel wrappers and plain versions.

Port of the TPU kernels ``wseg_tpu/ops/pamr_pallas.py``:
``pamr_affinity_pallas`` -> ``pamr_affinity_cm`` and
``pamr_propagate_pallas`` -> ``pamr_propagate_cm``; the CUDA source is
``csrc/pamr.cu`` (its header says what bounds each kernel and what the
design does about it).  Both are forward only: PAMR runs on
stop-gradient masks, and the TPU kernels have no backward either.

Tensors are channels-major (B, ., H, W) float32, the layout the kernels
read and write; ``ops/pamr.py`` keeps the NHWC contract around them.
Each wrapper dispatches on the tensor's device: a CPU tensor goes to
the plain version beside it (``*_reference``), a CUDA tensor launches
the kernel (building it on first use) or raises.  ``.launches`` counts
kernel launches.

Taps are ``pamr_taps(dilations)``: for each dilation d, the 8
neighbours of a row-major 3x3 scan without its centre, times d (the
order of ``wseg_tpu/ops/pamr.py::_OFFSETS``).  Edge replication is
coordinate clamping, since no offset exceeds ``max(dilations)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from wseg_tpu_torch import _build

_OFFSETS = ((-1, -1), (-1, 0), (-1, 1),
            (0, -1), (0, 1),
            (1, -1), (1, 0), (1, 1))


def _dilations(dilations: Sequence[int]) -> Tuple[int, ...]:
    dil = tuple(int(d) for d in dilations)
    if not dil or min(dil) <= 0:
        raise ValueError(f"dilations must be positive, got {dilations}")
    return dil


def pamr_taps(dilations: Sequence[int]):
    """[(dy, dx), ...] of the 8 * len(dilations) taps, in kernel order."""
    return [(dy * d, dx * d) for d in _dilations(dilations)
            for dy, dx in _OFFSETS]


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def pamr_affinity_cm_reference(im: torch.Tensor,
                               dilations: Sequence[int]) -> torch.Tensor:
    """Plain torch affinity, as ``wseg_tpu/ops/pamr.py::pamr_affinity``:
    guide (B, K, H, W) -> (B, T, H, W) softmax affinities, sigma per
    channel over the 9 * D taps (centre once per dilation), two-pass
    Bessel-corrected variance."""
    dil = _dilations(dilations)
    im = im.float()
    h, w = im.shape[2], im.shape[3]
    pad = max(dil)
    padded = _edge_pad(im, pad)

    def shift(dy, dx):
        return padded[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    diffs, neigh = [], []
    for d in dil:
        for dy, dx in _OFFSETS:
            n = shift(dy * d, dx * d)
            diffs.append(im - n)
            neigh.append(n)
        neigh.append(im)
    diffs = torch.stack(diffs, dim=1)                    # (B, T, K, H, W)
    neigh = torch.stack(neigh, dim=1)                    # (B, 9D, K, H, W)
    mean = neigh.mean(dim=1, keepdim=True)
    var = torch.sum(torch.square(neigh - mean), dim=1, keepdim=True) / (
        neigh.shape[1] - 1)
    aff = -torch.abs(diffs) / (1e-8 + 0.1 * torch.sqrt(var))
    return torch.softmax(aff.mean(dim=2), dim=1)


def pamr_propagate_cm_reference(aff: torch.Tensor, mask: torch.Tensor,
                                dilations: Sequence[int],
                                num_iter: int) -> torch.Tensor:
    """Plain torch propagation, as ``wseg_tpu/ops/pamr.py::
    pamr_propagate``: ``num_iter`` steps m <- sum_t aff_t * shift_t(m),
    edge-replicated, accumulated in tap order in float32."""
    taps = pamr_taps(dilations)
    aff = aff.float()
    m = mask.float()
    h, w = m.shape[2], m.shape[3]
    pad = max(abs(v) for tap in taps for v in tap)
    for _ in range(int(num_iter)):
        padded = _edge_pad(m, pad)
        acc = torch.zeros_like(m)
        for t, (dy, dx) in enumerate(taps):
            acc = acc + aff[:, t:t + 1] * padded[
                :, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        m = acc
    return m


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("pamr")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.wseg_pamr_affinity.argtypes = [ptr, ptr, ptr, i, i, i, i, ptr]
    lib.wseg_pamr_propagate.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i,
                                        i, ptr]
    for name in ("wseg_pamr_affinity", "wseg_pamr_propagate",
                 "wseg_pamr_max_dilations", "wseg_pamr_propagate_max_plane"):
        getattr(lib, name).restype = ctypes.c_int
    lib.wseg_pamr_max_dilations.argtypes = []
    lib.wseg_pamr_propagate_max_plane.argtypes = []
    return lib


def _check(t: torch.Tensor, name: str) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (B, ., H, W), got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no PAMR kernel for device {t.device}")


def _kernel_args(lib, dil: Tuple[int, ...], *tensors: torch.Tensor):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("PAMR kernel tensors must be contiguous "
                         "channels-major (B, ., H, W)")
    if len(dil) > lib.wseg_pamr_max_dilations():
        raise ValueError(f"{len(dil)} dilations exceed the kernel's "
                         f"{lib.wseg_pamr_max_dilations()}")
    return (ctypes.c_int * len(dil))(*dil)


def pamr_affinity_cm(im: torch.Tensor,
                     dilations: Sequence[int]) -> torch.Tensor:
    """Guide (B, 3, H, W) float32 -> (B, 8 * D, H, W) float32 softmax
    affinities."""
    dil = _dilations(dilations)
    _check(im, "guide")
    if im.device.type == "cpu":
        return pamr_affinity_cm_reference(im, dil)
    _require_cuda(im)
    b, k, h, w = im.shape
    out = torch.empty((b, 8 * len(dil), h, w), dtype=torch.float32,
                      device=im.device)
    with torch.cuda.device(im.device):
        lib = _library()
        dil_c = _kernel_args(lib, dil, im)
        if k != 3:
            raise ValueError(f"the affinity kernel takes 3 guide channels, "
                             f"got {k}")
        if out.numel() == 0:
            return out
        rc = lib.wseg_pamr_affinity(
            im.data_ptr(), out.data_ptr(), ctypes.addressof(dil_c),
            len(dil), b, h, w, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PAMR affinity kernel launch failed: CUDA "
                           f"error {rc}")
    pamr_affinity_cm.launches += 1
    return out


def pamr_propagate_cm(aff: torch.Tensor, mask: torch.Tensor,
                      dilations: Sequence[int],
                      num_iter: int = 10) -> torch.Tensor:
    """aff (B, 8 * D, H, W), mask (B, C, H, W), both float32 ->
    (B, C, H, W) float32 after ``num_iter`` Jacobi steps, one launch."""
    dil = _dilations(dilations)
    _check(aff, "aff")
    _check(mask, "mask")
    b, c, h, w = mask.shape
    if tuple(aff.shape) != (b, 8 * len(dil), h, w):
        raise ValueError(f"aff {tuple(aff.shape)} does not match mask "
                         f"{tuple(mask.shape)} and {len(dil)} dilations")
    if aff.device != mask.device:
        raise ValueError(f"aff on {aff.device}, mask on {mask.device}")
    if int(num_iter) < 0:
        raise ValueError(f"num_iter must be >= 0, got {num_iter}")
    if mask.device.type == "cpu":
        return pamr_propagate_cm_reference(aff, mask, dil, num_iter)
    _require_cuda(mask)
    with torch.cuda.device(mask.device):
        lib = _library()
        dil_c = _kernel_args(lib, dil, aff, mask)
        limit = lib.wseg_pamr_propagate_max_plane()
        if h * w > limit:
            raise ValueError(
                f"a {h}x{w} plane exceeds the propagation kernel's "
                f"shared-memory limit of {limit} pixels (two float32 "
                "planes per block)")
        out = torch.empty_like(mask)
        if mask.numel() == 0:
            return out
        rc = lib.wseg_pamr_propagate(
            aff.data_ptr(), mask.data_ptr(), out.data_ptr(),
            ctypes.addressof(dil_c), len(dil), b, c, h, w, int(num_iter),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PAMR propagation kernel launch failed: CUDA "
                           f"error {rc}")
    pamr_propagate_cm.launches += 1
    return out


pamr_affinity_cm.launches = 0
pamr_propagate_cm.launches = 0
