"""Joint image/mask augmentations on the host (PIL + numpy).

Mirror of ``wseg_tpu/data/transforms.py`` for the train and validation
pipelines: random resized crop (cubic for the image, nearest for the
mask), horizontal flip, colour jitter, and the uint8 tail.  Each
transform takes (PIL image, PIL mask, rng, score) and draws from the
numpy ``rng`` exactly as the JAX package's does, so both packages
augment a seeded stream identically.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from PIL import Image, ImageEnhance


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, mask, rng: np.random.RandomState,
                 score=None):
        for t in self.transforms:
            out = t(image, mask, rng, score)
            image, mask = out[0], out[1]
            if len(out) > 2:
                score = out[2]
        if score is None:
            return image, mask
        return image, mask, score


def _rrc_params(w, h, scale, ratio, rng):
    """torchvision RandomResizedCrop.get_params semantics."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch + 1)
            j = rng.randint(0, w - cw + 1)
            return i, j, ch, cw
    # fallback: central crop clamped to the ratio range
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    i = (h - ch) // 2
    j = (w - cw) // 2
    return i, j, ch, cw


class MaskRandResizedCrop:
    def __init__(self, size: int, scale_from: float = 0.9,
                 scale_to: float = 1.0,
                 ratio: Sequence[float] = (3. / 4., 4. / 3.)):
        self.size = (size, size)
        self.scale = (scale_from, scale_to)
        self.ratio = tuple(ratio)

    def __call__(self, image, mask, rng, score=None):
        w, h = image.size
        i, j, ch, cw = _rrc_params(w, h, self.scale, self.ratio, rng)
        box = (j, i, j + cw, i + ch)
        image = image.crop(box).resize(self.size, Image.BICUBIC)
        mask = mask.crop(box).resize(self.size, Image.NEAREST)
        if score is not None:
            score = score.crop(box).resize(self.size, Image.BILINEAR)
        return image, mask, score


class MaskCenterCrop:
    """Deterministic resize-then-center-crop for eval pipelines."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, image, mask, rng, score=None):
        w, h = image.size
        s = self.size / min(w, h)
        nw, nh = int(round(w * s)), int(round(h * s))
        image = image.resize((nw, nh), Image.BICUBIC)
        mask = mask.resize((nw, nh), Image.NEAREST)
        left = (nw - self.size) // 2
        top = (nh - self.size) // 2
        box = (left, top, left + self.size, top + self.size)
        if score is not None:
            score = score.resize((nw, nh), Image.BILINEAR).crop(box)
        return image.crop(box), mask.crop(box), score


class MaskHFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, mask, rng, score=None):
        if rng.rand() < self.p:
            image = image.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
            if score is not None:
                score = score.transpose(Image.FLIP_LEFT_RIGHT)
        return image, mask, score


def _adjust_hue(image: Image.Image, factor: float) -> Image.Image:
    """Shift hue by ``factor`` (in turns), torchvision semantics."""
    if abs(factor) < 1e-8:
        return image
    h, s, v = image.convert("HSV").split()
    h_np = np.asarray(h, np.int16)
    h_np = ((h_np + int(round(factor * 255))) % 256).astype(np.uint8)
    return Image.merge(
        "HSV", (Image.fromarray(h_np, "L"), s, v)).convert("RGB")


class MaskColourJitter:
    def __init__(self, p: float = 0.5, brightness: float = 0.3,
                 contrast: float = 0.3, saturation: float = 0.3,
                 hue: float = 0.1):
        self.p = p
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, image, mask, rng, score=None):
        if rng.rand() >= self.p:
            return image, mask, score
        b = rng.uniform(1 - self.brightness, 1 + self.brightness)
        c = rng.uniform(1 - self.contrast, 1 + self.contrast)
        s = rng.uniform(1 - self.saturation, 1 + self.saturation)
        hshift = rng.uniform(-self.hue, self.hue)
        order = rng.permutation(4)
        params = np.array([b, c, s, hshift, *order, 1.0], np.float32)
        return apply_jitter_params(image, params), mask, score


def apply_jitter_params(image: Image.Image,
                        params: np.ndarray) -> Image.Image:
    """Apply a sampled 9-vector (ops/jitter.py layout) with PIL — the
    byte-exact host path and the oracle for the device-jitter tests."""
    if params[8] < 0.5:
        return image
    b, c, s, hshift = (float(v) for v in params[:4])
    ops = [
        lambda im: ImageEnhance.Brightness(im).enhance(b),
        lambda im: ImageEnhance.Contrast(im).enhance(c),
        lambda im: ImageEnhance.Color(im).enhance(s),
        lambda im: _adjust_hue(im, hshift),
    ]
    for k in params[4:8].astype(np.int64):
        image = ops[int(k)](image)
    return image


class MaskToUint8:
    """PIL -> uint8 HWC, unnormalised: the train and eval steps
    normalise on the device (a quarter of the upload of float32)."""

    def __call__(self, image, mask, rng, score=None):
        arr = np.asarray(image, np.uint8)
        if score is not None:
            score = np.asarray(score, np.float32)
        return arr, mask, score
