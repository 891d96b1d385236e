"""Dense-CRF mean-field inference (fast sparse-tap approximation).

Mirror of ``wseg_tpu/ops/crf.py``'s ``crf_inference_jax`` /
``_crf_jax_cm``: unary from the probabilities, Gaussian pairwise (sxy 3,
compat 3) as a separable slice-sum, bilateral pairwise (sxy 80, srgb
13, compat 10) sampled on a sparse displacement grid with per-tap
colour weights, symmetric kernel normalisation, ``t`` iterations.

The bilateral message goes through ``ops/crf_bilateral.py`` (the CUDA
kernel on the card, its plain version on the CPU) with the semantics of
the JAX package's Pallas path: one weight stack ``tap_sp[k] *
colour_w[k]`` cast to ``dtype`` and then to bfloat16, the message input
cast to ``dtype`` and read as float32, float32 accumulation, taps
negated (the loop form reads Q at x - d).

Layout: NHWC at ``crf_inference_torch``, channels-major (B, C, H, W)
inside.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm


def _bilateral_taps(sxy: float, spacing_div: float = 2.0,
                    radius_mult: float = 2.0) -> List[Tuple[int, int]]:
    """Displacement taps on a sparse grid covering ~2 sigma."""
    step = max(1, int(round(sxy / spacing_div)))
    r = int(round(radius_mult * sxy))
    offs = list(range(-r, r + 1, step))
    return [(dy, dx) for dy in offs for dx in offs
            if not (dy == 0 and dx == 0)]


def crf_inference_torch(img, probs, t: int = 10,
                        sxy_gaussian: float = 3.0,
                        compat_gaussian: float = 3.0,
                        sxy_bilateral: float = 80.0, srgb: float = 13.0,
                        compat_bilateral: float = 10.0, valid_mask=None,
                        dtype=None, bilateral_stride: int = 1,
                        tap_spacing_div: float = 2.0,
                        full_stride: int = 1, refine_iters: int = 0,
                        q_init=None):
    """Batched mean-field CRF over NHWC ``probs`` (B, H, W, C).

    ``img`` (B, H, W, 3) RGB in [0, 255]; ``valid_mask`` (B, H, W, 1)
    zeroes messages from padded pixels; ``dtype`` is the message
    precision (default float32); ``bilateral_stride`` s evaluates the
    bilateral message on an (H/s, W/s) grid; ``full_stride`` s runs the
    mean field on the (H/s, W/s) grid, its last ``refine_iters``
    iterations at full resolution; ``q_init`` seeds Q.  Semantics as
    ``wseg_tpu``'s ``crf_inference_jax``.  Returns (B, H, W, C) float32.
    """
    def cm(x):
        return None if x is None else x.permute(0, 3, 1, 2)

    q = _crf_torch_cm(cm(img), cm(probs), t=t,
                      sxy_gaussian=sxy_gaussian,
                      compat_gaussian=compat_gaussian,
                      sxy_bilateral=sxy_bilateral, srgb=srgb,
                      compat_bilateral=compat_bilateral,
                      valid_mask=cm(valid_mask), dtype=dtype,
                      bilateral_stride=bilateral_stride,
                      tap_spacing_div=tap_spacing_div,
                      full_stride=full_stride, refine_iters=refine_iters,
                      q_init=cm(q_init))
    return q.permute(0, 2, 3, 1)


def _up2_cm(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 2x half-pixel bilinear upsample along ``axis`` (edge
    clamped): out[2i] = .25 x[i-1] + .75 x[i], out[2i+1] = .75 x[i] +
    .25 x[i+1]."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                    axis)
    even = 0.75 * x + 0.25 * prev
    odd = 0.75 * x + 0.25 * nxt
    st = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def _box_down(x: torch.Tensor, s: int, hp: int, wp: int) -> torch.Tensor:
    """Zero-pad (B, c, H, W) to (hp, wp) and average s x s boxes."""
    b, c, h, w = x.shape
    xp = F.pad(x, (0, wp - w, 0, hp - h))
    return xp.reshape(b, c, hp // s, s, wp // s, s).mean(dim=(3, 5))


def _upsample(x: torch.Tensor, s: int, hp: int, wp: int) -> torch.Tensor:
    """Half-pixel bilinear upsample of (B, c, H/s, W/s) to (hp, wp)."""
    if s == 2:
        return _up2_cm(_up2_cm(x, 2), 3)
    from wseg_tpu_torch.ops.resize import resize_bilinear
    return resize_bilinear(x.permute(0, 2, 3, 1), (hp, wp),
                           align_corners=False).permute(0, 3, 1, 2)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., i, j] = x[..., i + dy, j + dx], zero fill."""
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)))
    return xp[:, :, max(0, dy):max(0, dy) + h, max(0, dx):max(0, dx) + w]


def _crf_torch_cm(img, probs, t, sxy_gaussian, compat_gaussian,
                  sxy_bilateral, srgb, compat_bilateral, valid_mask,
                  dtype, bilateral_stride, tap_spacing_div, full_stride,
                  refine_iters, q_init):
    """Channels-major core: img (B, 3, H, W), probs/q_init (B, C, H, W),
    valid_mask (B, 1, H, W) -> Q (B, C, H, W)."""
    if dtype is None:
        dtype = torch.float32
    B, C, H, W = probs.shape
    dev = probs.device

    fs = int(full_stride)
    if fs > 1:
        Hp_, Wp_ = -(-H // fs) * fs, -(-W // fs) * fs
        if valid_mask is None:
            valid_mask = torch.ones((B, 1, H, W), device=dev)
        vm_s = _box_down(valid_mask, fs, Hp_, Wp_)
        den = torch.clamp(vm_s, min=1e-8)
        img_s = _box_down(img.float() * valid_mask, fs, Hp_, Wp_) / den
        probs_s = _box_down(probs.float() * valid_mask, fs, Hp_, Wp_) / den
        probs_s = probs_s / torch.clamp(probs_s.sum(1, keepdim=True),
                                        min=1e-8)
        r = min(int(refine_iters), t)
        q = _crf_torch_cm(
            img_s, probs_s, t=t - r, sxy_gaussian=sxy_gaussian / fs,
            compat_gaussian=compat_gaussian,
            sxy_bilateral=sxy_bilateral / fs, srgb=srgb,
            compat_bilateral=compat_bilateral,
            valid_mask=(vm_s > 0.0).float(), dtype=dtype,
            bilateral_stride=max(1, int(bilateral_stride) // fs),
            tap_spacing_div=tap_spacing_div, full_stride=1,
            refine_iters=0, q_init=None)
        up = _upsample(q, fs, Hp_, Wp_)[:, :, :H, :W] * valid_mask
        if r == 0:
            return up
        up = up / torch.clamp(up.sum(1, keepdim=True), min=1e-8)
        return _crf_torch_cm(
            img, probs, t=r, sxy_gaussian=sxy_gaussian,
            compat_gaussian=compat_gaussian,
            sxy_bilateral=sxy_bilateral, srgb=srgb,
            compat_bilateral=compat_bilateral, valid_mask=valid_mask,
            dtype=dtype, bilateral_stride=bilateral_stride,
            tap_spacing_div=tap_spacing_div, full_stride=1,
            refine_iters=0, q_init=up)

    img_f = img.float()
    if valid_mask is None:
        valid_mask = torch.ones((B, 1, H, W), device=dev)

    # --- Gaussian kernel: unnormalised separable 1-D weights
    rg = int(round(2.0 * sxy_gaussian))
    x1d = np.arange(-rg, rg + 1, dtype=np.float32)
    k1d = [float(v) for v in
           np.exp(-x1d * x1d / (2.0 * sxy_gaussian * sxy_gaussian))]

    def gauss_filter(x):
        x = x * valid_mask
        xp = F.pad(x, (0, 0, rg, rg))
        acc = sum(k1d[i] * xp[:, :, i:i + H] for i in range(2 * rg + 1))
        xp = F.pad(acc, (rg, rg))
        return sum(k1d[i] * xp[:, :, :, i:i + W]
                   for i in range(2 * rg + 1))

    # --- bilateral: optionally on a strided grid
    s = int(bilateral_stride)
    if s > 1:
        Hp, Wp = -(-H // s) * s, -(-W // s) * s
        vm_b = _box_down(valid_mask, s, Hp, Wp)
        denom = torch.clamp(vm_b, min=1e-8)
        img_b = _box_down(img_f * valid_mask, s, Hp, Wp) / denom
        sxy_b = sxy_bilateral / s
    else:
        vm_b = valid_mask
        img_b = img_f
        sxy_b = sxy_bilateral

    taps = _bilateral_taps(sxy_b, spacing_div=tap_spacing_div)
    tap_sp = [math.exp(-(dy * dy + dx * dx) / (2.0 * sxy_b * sxy_b))
              for dy, dx in taps]
    with record_function("crf.tap_weights"):
        weights = []
        for k, (dy, dx) in enumerate(taps):
            diff = img_b - _shift(img_b, -dy, -dx)
            cw = torch.exp(-torch.sum(diff * diff, 1, keepdim=True)
                           / (2.0 * srgb * srgb))
            cw = (cw * vm_b).to(dtype)
            weights.append((tap_sp[k] * cw).to(dtype))
        # the kernel reads bfloat16 weights whatever ``dtype`` is
        wstack = torch.cat(weights, dim=1).to(torch.bfloat16)
    neg_taps = [(-dy, -dx) for dy, dx in taps]

    def bilateral_filter(x):
        # x arrives pre-masked and rounded to ``dtype``; the per-tap
        # weights already carry the valid mask
        return bilateral_message_cm(x.float().contiguous(), wstack,
                                    neg_taps)

    norm_g = torch.rsqrt(torch.clamp(gauss_filter(valid_mask), min=1e-20))
    norm_b = torch.rsqrt(torch.clamp(bilateral_filter(vm_b.to(dtype)),
                                     min=1e-20))

    if s > 1:
        def bilateral_msg(Q):
            Ql = _box_down(Q * valid_mask, s, Hp, Wp) / denom
            qb = bilateral_filter((Ql * norm_b).to(dtype)) * norm_b
            return _upsample(qb, s, Hp, Wp)[:, :, :H, :W] * valid_mask
    else:
        def bilateral_msg(Q):
            return bilateral_filter(
                (Q * norm_b * valid_mask).to(dtype)) * norm_b

    unary = -torch.log(torch.clamp(probs.float(), min=1e-8))
    self_g = norm_g * norm_g  # centre-tap self contribution
    Q = (q_init if q_init is not None else probs).float()
    for _ in range(t):
        qg = gauss_filter(Q * norm_g) * norm_g - self_g * Q
        qb = bilateral_msg(Q)
        msg = compat_gaussian * qg + compat_bilateral * qb
        Q = torch.softmax(-unary + msg, dim=1)
    return Q
