"""Multi-scale / multi-crop view generation and mask merging.

Mirror of ``wseg_tpu/data/multiscale.py``.  ``MultiscaleViews`` gives
each scale/flip view's padded bucket shape and window; the device view
path (``build_device``) resamples the pixels on the device
(``ops/view_gen.py``), the host view path (``build``) with PIL's bicubic
resize, as the reference does.  ``merge_multiscale`` and
``merge_crops`` are the reference's host merges (OpenCV's bilinear
resize); ``CropViews`` the sliding-window crops of ``TEST.METHOD:
multicrop``.  Images are (h, w, 3) uint8 numpy arrays; PIL and OpenCV
are imported where pixels are resampled.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from wseg_tpu_torch.data.pascal_voc import MEAN, STD


def _round_up(x: int, align: int) -> int:
    return int(math.ceil(x / align) * align)


def _normalise(arr_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB -> ImageNet-normalised float32."""
    mean = np.asarray(MEAN, np.float32)
    std = np.asarray(STD, np.float32)
    return (np.asarray(arr_u8, np.float32) / 255.0 - mean) / std


class MultiscaleViews:
    """Scale/flip views of one image.  View order matches the reference:
    for each scale, [view, flipped-view] when flip is on.

    ``transfer``: "float32" (``build`` returns normalised views with zero
    padding) or "uint8" (raw resized pixels; the device normalises and
    zeroes the padding)."""

    def __init__(self, scales: Sequence[float], flip: bool,
                 pad_size: Tuple[int, int], pad_per_scale: bool = False,
                 pad_align: int = 128, transfer: str = "float32"):
        if transfer not in ("float32", "uint8"):
            raise ValueError(f"transfer must be 'float32' or 'uint8', got "
                             f"{transfer!r}")
        self.scales = list(scales)
        self.flip = flip
        self.pad_size = tuple(int(p) for p in pad_size)
        self.pad_per_scale = pad_per_scale
        self.pad_align = pad_align
        self.transfer = transfer

    @property
    def num_views(self) -> int:
        return len(self.scales) * (2 if self.flip else 1)

    def view_shapes(self, w: int, h: int) -> List[Tuple[int, int]]:
        """Padded (H, W) per scale."""
        shapes = []
        for s in self.scales:
            if self.pad_per_scale:
                th = _round_up(int(round(h * s)), self.pad_align)
                tw = _round_up(int(round(w * s)), self.pad_align)
                shapes.append((th, tw))
            else:
                shapes.append(self.pad_size)
        return shapes

    def view_windows(self, w: int, h: int):
        """(pads, flips) per flat view id: pads are (top, left, h, w) of
        the centred view inside its padded canvas."""
        pads, flips = [], []
        for s, (ph, pw) in zip(self.scales, self.view_shapes(w, h)):
            tw, th = int(round(w * s)), int(round(h * s))
            pt, pl = max(0, (ph - th) // 2), max(0, (pw - tw) // 2)
            for do_flip in ([False, True] if self.flip else [False]):
                pads.append((pt, pl, th, tw))
                flips.append(do_flip)
        return pads, flips

    def build_device(self, image_u8: np.ndarray, canvas_hw):
        """Place the (h, w, 3) uint8 original at the top-left of a static
        uint8 canvas; every resize/flip/pad then happens on the device.

        Returns (canvas (Hc, Wc, 3) uint8, owin (0, 0, h, w), pads,
        flips).
        """
        h, w = image_u8.shape[:2]
        ch, cw = canvas_hw
        if h > ch or w > cw:
            raise ValueError(f"image {h}x{w} exceeds the {ch}x{cw} canvas")
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:h, :w] = image_u8[..., :3]
        pads, flips = self.view_windows(w, h)
        return canvas, (0, 0, h, w), pads, flips

    def build(self, image_u8: np.ndarray):
        """Host views of an (h, w, 3) uint8 image: PIL bicubic resize per
        scale, flip, zero padding into the scale's bucket.

        Returns (views, pads, flips), lists indexed by flat view id:
        views (Hp, Wp, 3) float32 normalised or uint8 (``transfer``),
        pads (top, left, h, w), flips bool.
        """
        from PIL import Image

        h, w = image_u8.shape[:2]
        image = Image.fromarray(np.ascontiguousarray(image_u8[..., :3]))
        uint8 = self.transfer == "uint8"
        views, pads, flips = [], [], []
        for s, (ph, pw) in zip(self.scales, self.view_shapes(w, h)):
            tw, th = int(round(w * s)), int(round(h * s))
            if th > ph or tw > pw:
                raise ValueError(f"view {th}x{tw} exceeds pad {ph}x{pw}")
            img_s = image.resize((tw, th), Image.BICUBIC)
            pt, pl = (ph - th) // 2, (pw - tw) // 2
            for do_flip in ([False, True] if self.flip else [False]):
                im = (img_s.transpose(Image.FLIP_LEFT_RIGHT) if do_flip
                      else img_s)
                arr = np.asarray(im)
                canvas = np.zeros((ph, pw, 3),
                                  np.uint8 if uint8 else np.float32)
                canvas[pt:pt + th, pl:pl + tw] = (arr if uint8
                                                  else _normalise(arr))
                views.append(canvas)
                pads.append((pt, pl, th, tw))
                flips.append(do_flip)
        return views, pads, flips


def merge_multiscale(masks, pads, flips, labels_fg: np.ndarray,
                     imsize_hw: Tuple[int, int], bg_pow: float = 3.0
                     ) -> np.ndarray:
    """Per-view (Hp, Wp, C) masks -> one (H, W, C) map: cut the padding,
    bilinear resize to the original size (OpenCV, half-pixel sampling),
    unflip, zero the absent classes, mean over views, BG^bg_pow."""
    import cv2

    H, W = imsize_hw
    acc = None
    for m, (pt, pl, h, w), fl in zip(masks, pads, flips):
        cut = np.asarray(m[pt:pt + h, pl:pl + w], np.float32)
        cut = cv2.resize(cut, (W, H), interpolation=cv2.INTER_LINEAR)
        if fl:
            cut = cut[:, ::-1]
        cut[..., 1:] *= labels_fg[None, None, :]
        acc = cut if acc is None else acc + cut
    mean = acc / len(pads)
    mean[..., 0] = np.power(mean[..., 0], bg_pow)
    return mean


def grid_coords(pad_hw, crop_hw, grid_hw) -> Tuple[Tuple[int, int], ...]:
    """Top-left corners of the crop grid over the padded canvas: stride
    ceil(pad / grid), each crop pulled back to end inside the canvas.
    Refuses a crop larger than the canvas and a sparse grid (stride >
    crop), whose uncovered bands the merge would fill with zeros."""
    ph, pw = (int(p) for p in pad_hw)
    ch, cw = (int(c) for c in crop_hw)
    gh, gw = (int(g) for g in grid_hw)
    sh, sw = math.ceil(ph / gh), math.ceil(pw / gw)
    if ch > ph or cw > pw:
        raise ValueError(f"crop {ch}x{cw} exceeds padded canvas {ph}x{pw}")
    if sh > ch or sw > cw:
        raise ValueError(
            f"crop grid is sparse: stride {sh}x{sw} > crop {ch}x{cw} "
            f"(pad {ph}x{pw} / grid {gh}x{gw}) leaves uncovered bands")
    return tuple((min(gi * sh + ch, ph) - ch, min(gj * sw + cw, pw) - cw)
                 for gi in range(gh) for gj in range(gw))


class CropViews:
    """Sliding-window crop views (``TEST.METHOD: multicrop``): a grid of
    CROP_SIZE crops over the image centred in PAD_SIZE, the flipped
    variant first when flip is on (the reference's CropLoader)."""

    def __init__(self, crop_size, grid_size, pad_size, flip: bool):
        self.crop_h, self.crop_w = (int(c) for c in crop_size)
        self.grid_h, self.grid_w = (int(g) for g in grid_size)
        self.pad_size = tuple(int(p) for p in pad_size)
        self.flip = flip
        self.coords = grid_coords(self.pad_size, (self.crop_h, self.crop_w),
                                  (self.grid_h, self.grid_w))

    @property
    def num_views(self):
        return self.grid_h * self.grid_w * (2 if self.flip else 1)

    def window(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """(top, left, h, w) of an image centred in the padded canvas."""
        ph, pw = self.pad_size
        if h > ph or w > pw:
            raise ValueError(f"image {w}x{h} exceeds TEST.PAD_SIZE "
                             f"({pw}x{ph}); the reference CropLoader cannot "
                             "pad it either")
        return (ph - h) // 2, (pw - w) // 2, h, w

    def build(self, image_u8: np.ndarray):
        """Returns (views, coords, flips): float32 normalised crops,
        (s_h, e_h, s_w, e_w, pt, pl) per view, flip flags."""
        h, w = image_u8.shape[:2]
        pt, pl, _, _ = self.window(h, w)
        ph, pw = self.pad_size
        canvas = np.zeros((ph, pw, 3), np.float32)
        canvas[pt:pt + h, pl:pl + w] = _normalise(image_u8[..., :3])
        views, coords, flips = [], [], []
        for s_h, s_w in self.coords:
            e_h, e_w = s_h + self.crop_h, s_w + self.crop_w
            crop = canvas[s_h:e_h, s_w:e_w]
            for do_flip in ([True, False] if self.flip else [False]):
                views.append(np.ascontiguousarray(
                    crop[:, ::-1] if do_flip else crop))
                coords.append((s_h, e_h, s_w, e_w, pt, pl))
                flips.append(do_flip)
        return views, coords, flips


def merge_crops(masks, coords, flips, labels_fg, imsize_hw) -> np.ndarray:
    """Reassemble crop masks onto the image with per-pixel overlap counts;
    the absent classes zeroed after the division, no BG_POW (the
    reference's MergeCrops)."""
    H, W = imsize_hw
    C = masks[0].shape[-1]
    total = np.zeros((H, W, C), np.float32)
    counts = np.zeros((H, W), np.float32)
    for m, (s_h, e_h, s_w, e_w, pt, pl), fl in zip(masks, coords, flips):
        m = np.asarray(m, np.float32)
        if fl:
            m = m[:, ::-1]
        m_h = 0 if s_h > 0 else pt
        m_w = 0 if s_w > 0 else pl
        s_h2, s_w2 = max(0, s_h - pt), max(0, s_w - pl)
        e_h2, e_w2 = min(e_h - pt, H), min(e_w - pl, W)
        total[s_h2:e_h2, s_w2:e_w2] += m[m_h:m_h + e_h2 - s_h2,
                                         m_w:m_w + e_w2 - s_w2]
        counts[s_h2:e_h2, s_w2:e_w2] += 1
    if not np.all(counts > 0):
        raise ValueError("the crop grid leaves image pixels uncovered")
    total /= counts[..., None]
    total[..., 1:] *= labels_fg[None, None, :]
    return total
