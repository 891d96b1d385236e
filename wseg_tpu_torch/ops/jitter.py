"""Device colour jitter (brightness / contrast / saturation / hue).

Mirror of ``wseg_tpu/ops/jitter.py``: the loader only samples the
per-image parameters (``sample_colour_jitter``, numpy, the same rng
stream as the host ``MaskColourJitter``) and the train step applies
them on the device, batched, between the uint8 upload and the ImageNet
normalisation.  Brightness, contrast and saturation reproduce PIL's
integer math; hue goes through PIL's quantised uint8 HSV planes in
float arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

PARAM_DIM = 9  # [b, c, s, h, order0..3, applied]


def sample_colour_jitter(rng: np.random.RandomState, p: float = 0.5,
                         brightness: float = 0.3, contrast: float = 0.3,
                         saturation: float = 0.3,
                         hue: float = 0.1) -> np.ndarray:
    """Per-image jitter parameters, drawn as ``MaskColourJitter`` draws
    them (the early exit on the p draw included)."""
    out = np.array([1.0, 1.0, 1.0, 0.0, 0, 1, 2, 3, 0.0], np.float32)
    if rng.rand() >= p:
        return out
    out[0] = rng.uniform(1 - brightness, 1 + brightness)
    out[1] = rng.uniform(1 - contrast, 1 + contrast)
    out[2] = rng.uniform(1 - saturation, 1 + saturation)
    out[3] = rng.uniform(-hue, hue)
    out[4:8] = rng.permutation(4).astype(np.float32)
    out[8] = 1.0
    return out


def _trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL ImagingBlend quantisation: truncation, clipped to u8."""
    return torch.clamp(torch.floor(x), 0.0, 255.0)


def _grey(img: torch.Tensor) -> torch.Tensor:
    """PIL L-mode conversion of an integer-valued RGB float image."""
    l24 = (img[..., 0] * 19595.0 + img[..., 1] * 38470.0 +
           img[..., 2] * 7471.0 + 32768.0)
    return torch.floor(l24 / 65536.0)


def _pick(i: torch.Tensor, choices) -> torch.Tensor:
    """choices[i] elementwise for integer i in [0, len(choices))."""
    out = choices[-1]
    for k in range(len(choices) - 2, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def _adjust_hue(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Hue rotation through PIL's quantised uint8 HSV planes
    (libImaging rgb2hsv / hsv2rgb); ``img`` integer-valued float32
    (B, H, W, 3), ``factor`` (B, 1, 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    cr = maxc - minc
    ok = cr > 0.5
    crs = torch.where(ok, cr, torch.ones_like(cr))
    rc = (maxc - r) / crs
    gc = (maxc - g) / crs
    bc = (maxc - b) / crs
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0 + 1.0, 1.0)
    zero = torch.zeros_like(h)
    uh = torch.where(ok, torch.floor(h * 255.0), zero)
    us = torch.where(ok, torch.floor(cr / maxc * 255.0), zero)

    uh = torch.remainder(uh + torch.round(factor * 255.0), 256.0)
    uh6 = uh * 6.0
    i = torch.floor(uh6 / 255.0)
    f = (uh6 - 255.0 * i) / 255.0
    fs = us / 255.0
    p_ = torch.floor(v * (1.0 - fs) + 0.5)
    q = torch.floor(v * (1.0 - fs * f) + 0.5)
    t = torch.floor(v * (1.0 - fs * (1.0 - f)) + 0.5)
    i = torch.remainder(i.to(torch.int32), 6)
    out = torch.stack([_pick(i, [v, q, p_, p_, t, v]),
                       _pick(i, [t, v, v, q, p_, p_]),
                       _pick(i, [p_, p_, t, v, v, q])], dim=-1)
    return torch.where((us < 0.5)[..., None], v[..., None].expand_as(out),
                       out)


def apply_colour_jitter(img: torch.Tensor, params: torch.Tensor):
    """``img`` (B, H, W, 3) float32, integer values in [0, 255];
    ``params`` (B, 9) from ``sample_colour_jitter``.  Returns the
    jittered image, integer-valued float32 in [0, 255]."""
    params = params.to(device=img.device, dtype=torch.float32)
    bfac = params[:, 0][:, None, None, None]
    cfac = params[:, 1][:, None, None, None]
    sfac = params[:, 2][:, None, None, None]
    hfac = params[:, 3][:, None, None]
    order = params[:, 4:8].to(torch.int32)
    applied = params[:, 8][:, None, None, None]

    out = img
    for pos in range(4):
        k = order[:, pos][:, None, None, None]
        grey = _grey(out)[..., None]
        # contrast blends toward int(mean(L) + 0.5) of the current image
        mean = torch.floor(grey.mean(dim=(1, 2, 3)) + 0.5)[:, None, None,
                                                             None]
        cand_b = _trunc_u8(out * bfac)
        cand_c = _trunc_u8(mean + (out - mean) * cfac)
        cand_s = _trunc_u8(grey + (out - grey) * sfac)
        # a zero hue draw leaves the image as it is, as the host path does
        cand_h = torch.where(
            torch.abs(hfac[..., None]) < 1e-8, out,
            torch.clamp(torch.floor(_adjust_hue(out, hfac) + 0.5), 0.0,
                        255.0))
        out = torch.where(k == 0, cand_b,
                          torch.where(k == 1, cand_c,
                                      torch.where(k == 2, cand_s, cand_h)))
    return torch.where(applied > 0.5, out, img)
