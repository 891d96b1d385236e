"""Bilinear resize of NHWC tensors as two interpolation-matrix products.

Same sampling as ``wseg_tpu/ops/resize.py`` (and ``F.interpolate(...,
mode='bilinear')`` on NCHW): ``align_corners=True`` inside the model,
``align_corners=False`` (half-pixel, edge-clamped) for the multi-scale
merge.  The 1-D matrices are numpy constants per shape, cached on the
device they are used on.  ``adaptive_max_pool`` is
``torch.adaptive_max_pool2d`` on NHWC tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """Rows sum to 1; A @ x linearly resamples a length-n_in signal to n_out."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        A[:, 0] = 1.0
        return A
    if n_out == 1:
        A[0, 0] = 1.0
        return A
    if align_corners:
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    else:
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
        src = np.clip(src, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.clip(i0, 0, n_in - 2)
    frac = src - i0
    A[np.arange(n_out), i0] = (1.0 - frac).astype(np.float32)
    A[np.arange(n_out), i0 + 1] += frac.astype(np.float32)
    return A


@functools.lru_cache(maxsize=256)
def _interp_matrix_on(n_in: int, n_out: int, align_corners: bool,
                      device: torch.device) -> torch.Tensor:
    # a normal tensor even when first built under inference_mode
    # (serving), so that training can save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(
            _interp_matrix(n_in, n_out, align_corners)).to(device)


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = True):
    """Bilinear-resize NHWC (or HWC / HW) ``x`` to spatial ``size=(H, W)``.

    Interior math runs in float32, under autocast too; the result is
    cast back to x's dtype.
    """
    h_out, w_out = int(size[0]), int(size[1])
    ndim = x.dim()
    if ndim == 2:
        x = x[None, :, :, None]
    elif ndim == 3:
        x = x[None]
    if x.dim() != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(x.shape)}")
    _, h_in, w_in, _ = x.shape
    out = x.float()
    with torch.autocast(x.device.type, enabled=False):
        if h_in != h_out:
            A_h = _interp_matrix_on(h_in, h_out, align_corners, x.device)
            out = torch.einsum("oh,bhwc->bowc", A_h, out)
        if w_in != w_out:
            A_w = _interp_matrix_on(w_in, w_out, align_corners, x.device)
            out = torch.einsum("ow,bhwc->bhoc", A_w, out)
    out = out.to(x.dtype)
    if ndim == 2:
        return out[0, :, :, 0]
    if ndim == 3:
        return out[0]
    return out


def rescale_as(x: torch.Tensor, y: torch.Tensor, align_corners: bool = True):
    """Resize NHWC ``x`` to the spatial size of NHWC ``y``."""
    return resize_bilinear(x, (y.shape[1], y.shape[2]), align_corners)


def adaptive_max_pool(x: torch.Tensor, size) -> torch.Tensor:
    """Max over the cells [floor(i * n / m), ceil((i + 1) * n / m)) of
    NHWC ``x`` to spatial ``size=(H, W)``, as ``wseg_tpu``'s
    ``adaptive_max_pool``."""
    y = F.adaptive_max_pool2d(x.permute(0, 3, 1, 2),
                              (int(size[0]), int(size[1])))
    return y.permute(0, 2, 3, 1)
