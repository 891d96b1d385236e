"""Multi-scale / flip view geometry for the device view path.

Host half of ``wseg_tpu/data/multiscale.py``'s ``MultiscaleViews``:
the padded bucket shape of each scale and the window of each view in
it.  The pixels themselves are resampled on the device
(``ops/view_gen.py``), so nothing here needs an image library.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def _round_up(x: int, align: int) -> int:
    return int(math.ceil(x / align) * align)


class MultiscaleViews:
    """Scale/flip view geometry of one image.  View order matches the
    reference: for each scale, [view, flipped-view] when flip is on."""

    def __init__(self, scales: Sequence[float], flip: bool,
                 pad_size: Tuple[int, int], pad_per_scale: bool = False,
                 pad_align: int = 128):
        self.scales = list(scales)
        self.flip = flip
        self.pad_size = tuple(int(p) for p in pad_size)
        self.pad_per_scale = pad_per_scale
        self.pad_align = pad_align

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
