"""Result writers: label maps -> paletted PNGs (``no_crf/``, ``crf/``,
and a ``vis/`` overlay strip when a GT mask is known).

The device-postprocess part of ``wseg_tpu/engine/writers.py``; PIL is
imported only when a file is written.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from wseg_tpu_torch.data.pascal_voc import get_palette, voc_colormap


def _save_indexed_png(path: str, mask: np.ndarray):
    from PIL import Image

    im = Image.fromarray(np.asarray(mask, np.uint8), mode="P")
    im.putpalette(get_palette())
    im.save(path)


def _mask2rgb(mask: np.ndarray) -> np.ndarray:
    cmap = voc_colormap().astype(np.float32) / 255.0
    return cmap[mask.astype(np.int32) % 256]


def _stem(img_name: str) -> str:
    name = os.path.basename(img_name)
    for ext in (".jpg", ".png"):
        if name.endswith(ext):
            name = name[: -len(ext)]
    return name


class ResultWriter:
    def __init__(self, out_path: str, verbose: bool = True):
        self.root = out_path
        self.verbose = verbose
        for sub in ("no_crf", "crf", "vis"):
            os.makedirs(os.path.join(out_path, sub), exist_ok=True)

    def _overlay(self, mask: np.ndarray, image01: np.ndarray,
                 alpha: float = 0.3) -> np.ndarray:
        return alpha * image01 + (1 - alpha) * _mask2rgb(mask)

    def save_pred(self, img_name: str, image01: Optional[np.ndarray],
                  pred: np.ndarray, pred_crf: Optional[np.ndarray] = None,
                  gt_mask: Optional[np.ndarray] = None):
        """Save label maps computed on the device."""
        name = _stem(img_name)
        _save_indexed_png(os.path.join(self.root, "no_crf", name + ".png"),
                          pred)
        if pred_crf is not None:
            _save_indexed_png(os.path.join(self.root, "crf", name + ".png"),
                              pred_crf)
        if self.verbose and gt_mask is not None and image01 is not None:
            from PIL import Image

            panels = [pred] + ([pred_crf] if pred_crf is not None else []) \
                + [gt_mask]
            strip = np.concatenate(panels, axis=1).astype(np.uint8)
            imgs = np.concatenate([image01] * len(panels), axis=1)
            out = np.round(255.0 * self._overlay(strip, imgs)).astype(
                np.uint8)
            Image.fromarray(out).save(
                os.path.join(self.root, "vis", name + ".png"))
