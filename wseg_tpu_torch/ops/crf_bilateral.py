"""Dense-CRF bilateral message: CUDA kernel wrapper and plain version.

``out[b, c](y, x) = sum_k w[b, k](y, x) * q[b, c](y + dy_k, x + dx_k)``
with zero fill, channels-major.  Port of the TPU kernel
``wseg_tpu/ops/crf_pallas.py::bilateral_message_pallas_cm``; the CUDA
source is ``csrc/crf_bilateral.cu``.

``bilateral_message_cm`` dispatches on the tensors' device: a CPU
tensor goes to ``bilateral_message_cm_reference``, a CUDA tensor
launches the kernel (building it on first use) or raises.
``bilateral_message_cm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from wseg_tpu_torch import _build

Taps = Tuple[Tuple[int, int], ...]


def bilateral_message_cm_reference(q: torch.Tensor, w: torch.Tensor,
                                   taps: Sequence[Tuple[int, int]]):
    """Plain torch loop over taps: q (B, C, H, W), w (B, T, H, W) ->
    (B, C, H, W) float32, accumulated in float32 in tap order."""
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    qf = q.float()
    h, w_ = q.shape[2], q.shape[3]
    for k, (dy, dx) in enumerate(taps):
        if abs(dy) >= h or abs(dx) >= w_:
            continue
        yd = slice(max(0, -dy), min(h, h - dy))
        ys = slice(max(0, dy), min(h, h + dy))
        xd = slice(max(0, -dx), min(w_, w_ - dx))
        xs = slice(max(0, dx), min(w_, w_ + dx))
        out[:, :, yd, xd] += w[:, k:k + 1, yd, xd].float() * qf[:, :, ys, xs]
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("crf_bilateral")
    fn = lib.wseg_crf_bilateral_message
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("wseg_crf_bilateral_max_channels",
                 "wseg_crf_bilateral_max_taps"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _taps_on(taps: Taps, device: torch.device) -> torch.Tensor:
    return torch.tensor(taps, dtype=torch.int32, device=device).contiguous()


def bilateral_message_cm(q: torch.Tensor, w: torch.Tensor,
                         taps: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """q (B, C, H, W) float32, w (B, T, H, W) bfloat16, T static (dy, dx)
    taps -> (B, C, H, W) float32 message."""
    taps = tuple((int(dy), int(dx)) for dy, dx in taps)
    if q.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected 4-D q and w, got {tuple(q.shape)}, "
                         f"{tuple(w.shape)}")
    b, c, h, w_ = q.shape
    if tuple(w.shape) != (b, len(taps), h, w_):
        raise ValueError(f"weights {tuple(w.shape)} do not match q "
                         f"{tuple(q.shape)} and {len(taps)} taps")
    if q.dtype != torch.float32 or w.dtype != torch.bfloat16:
        raise TypeError(f"expected float32 q and bfloat16 w, got {q.dtype}"
                        f" and {w.dtype}")
    if q.device != w.device:
        raise ValueError(f"q on {q.device}, w on {w.device}")
    if q.device.type == "cpu":
        return bilateral_message_cm_reference(q, w, taps)
    if q.device.type != "cuda":
        raise ValueError(f"no bilateral kernel for device {q.device}")
    if not (q.is_contiguous() and w.is_contiguous()):
        raise ValueError("q and w must be contiguous")
    lib = _library()
    if c > lib.wseg_crf_bilateral_max_channels():
        raise ValueError(f"{c} channels exceed the kernel's "
                         f"{lib.wseg_crf_bilateral_max_channels()}")
    if len(taps) > lib.wseg_crf_bilateral_max_taps():
        raise ValueError(f"{len(taps)} taps exceed the kernel's "
                         f"{lib.wseg_crf_bilateral_max_taps()}")
    out = torch.empty_like(q)
    if not taps or q.numel() == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        taps_dev = _taps_on(taps, q.device)
        rc = lib.wseg_crf_bilateral_message(
            q.data_ptr(), w.data_ptr(), taps_dev.data_ptr(), out.data_ptr(),
            b, c, len(taps), h, w_,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bilateral message kernel launch failed: CUDA "
                           f"error {rc}")
    bilateral_message_cm.launches += 1
    return out


bilateral_message_cm.launches = 0
