"""Dense-CRF Gaussian blur: CUDA kernel wrapper and plain version.

``out = correlate1d(correlate1d(x, k, axis=H), k, axis=W)`` with zero
fill, over 2r+1 taps ``k``, channels-major (B, C, H, W) float32.  Port
of the TPU kernel ``wseg_tpu/ops/crf_pallas.py::gauss_blur_pallas_cm``;
the CUDA source is ``csrc/crf_gauss.cu``.

``gauss_blur_cm`` dispatches on the tensor's device: a CPU tensor goes
to ``gauss_blur_cm_reference`` (a slice-sum), a CUDA tensor launches
the kernel (building it on first use) or raises.
``gauss_blur_cm.launches`` counts kernel launches, and ``.kernel_name``
is the kernel's name in profiler traces.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from wseg_tpu_torch import _build


def gauss_blur_cm_reference(x: torch.Tensor, k1d: Sequence[float],
                            r: int) -> torch.Tensor:
    """Plain slice-sum: the H pass over a zero-padded copy, then the W
    pass, taps summed in index order."""
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x, (0, 0, r, r))
    acc = sum(k1d[i] * xp[:, :, i:i + h] for i in range(2 * r + 1))
    xp = F.pad(acc, (r, r))
    return sum(k1d[i] * xp[:, :, :, i:i + w] for i in range(2 * r + 1))


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("crf_gauss")
    fn = lib.wseg_crf_gauss_blur
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wseg_crf_gauss_max_radius.argtypes = []
    lib.wseg_crf_gauss_max_radius.restype = ctypes.c_int
    return lib


def gauss_blur_cm(x: torch.Tensor, k1d: Sequence[float],
                  r: int) -> torch.Tensor:
    """x (B, C, H, W) float32, contiguous; ``k1d`` 2r+1 host floats ->
    (B, C, H, W) float32, zero-padded separable blur."""
    r = int(r)
    k1d = [float(v) for v in k1d]
    if x.dim() != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous channels-major (B, C, H, W)")
    if r < 0 or len(k1d) != 2 * r + 1:
        raise ValueError(f"{len(k1d)} taps for radius {r}, expected "
                         f"{2 * r + 1}")
    if x.device.type == "cpu":
        return gauss_blur_cm_reference(x, k1d, r)
    if x.device.type != "cuda":
        raise ValueError(f"no Gaussian blur kernel for device {x.device}")
    lib = _library()
    if r > lib.wseg_crf_gauss_max_radius():
        raise ValueError(f"radius {r} exceeds the kernel's "
                         f"{lib.wseg_crf_gauss_max_radius()}")
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    taps = (ctypes.c_float * len(k1d))(*k1d)
    with torch.cuda.device(x.device):
        rc = lib.wseg_crf_gauss_blur(
            x.data_ptr(), out.data_ptr(), ctypes.addressof(taps), r, b * c,
            h, w, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Gaussian blur kernel launch failed: CUDA "
                           f"error {rc}")
    gauss_blur_cm.launches += 1
    return out


gauss_blur_cm.launches = 0
gauss_blur_cm.kernel_name = "gauss_blur_kernel"
