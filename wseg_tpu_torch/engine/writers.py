"""Result writers: score maps or label maps -> paletted PNGs
(``no_crf/``, ``crf/``, and a ``vis/`` overlay strip when a GT mask is
known), the optional ``heatmap/`` (``cm.hot`` overlay) and
``scoremap/*.npy`` outputs, and the per-iteration ``PAMRWriter``.

Mirror of ``wseg_tpu/engine/writers.py``.  matplotlib is not needed:
the ``hot`` and ``jet`` colormaps are numpy tables built from
matplotlib's piecewise-linear segment data (``colormap``).  PIL is
imported only when a file is written.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from wseg_tpu_torch.data.pascal_voc import get_palette, voc_colormap

# matplotlib's segment data (matplotlib/_cm.py): per channel, rows
# (x, y below x, y above x)
_SEGMENTS = {
    "hot": {"red": ((0.0, 0.0416, 0.0416), (0.365079, 1.0, 1.0),
                    (1.0, 1.0, 1.0)),
            "green": ((0.0, 0.0, 0.0), (0.365079, 0.0, 0.0),
                      (0.746032, 1.0, 1.0), (1.0, 1.0, 1.0)),
            "blue": ((0.0, 0.0, 0.0), (0.746032, 0.0, 0.0),
                     (1.0, 1.0, 1.0))},
    "jet": {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
                    (1.0, 0.5, 0.5)),
            "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1),
                      (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
            "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1),
                     (0.65, 0, 0), (1.0, 0, 0))},
}
_LUT_SIZE = 256


def _lookup_table(segments, n: int = _LUT_SIZE) -> np.ndarray:
    """(n,) samples of one channel's piecewise-linear map, as
    matplotlib's ``_create_lookup_table`` builds them."""
    a = np.asarray(segments, np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], dist * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap(name: str, x: np.ndarray) -> np.ndarray:
    """RGB (..., 3) of the values ``x`` under matplotlib's colormap
    ``name`` ("hot" or "jet"; ``cm.<name>(x)[..., :3]``)."""
    lut = np.stack([_lookup_table(_SEGMENTS[name][c])
                    for c in ("red", "green", "blue")], axis=-1)
    # x * N in x's own float type, clipped to the table (under and over
    # take its ends), NaN black
    xa = np.asarray(x) * np.asarray(_LUT_SIZE, np.asarray(x).dtype)
    bad = np.isnan(xa)
    rgb = lut[np.clip(np.where(bad, 0, xa), 0, _LUT_SIZE - 1).astype(int)]
    rgb[bad] = 0.0
    return rgb


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


def threshold_and_argmax(scores: np.ndarray, prospect_thresh: float
                         ) -> np.ndarray:
    """Zero foreground scores below the threshold, then argmax over the
    last axis (reference inference_tools.py:85-88)."""
    s = scores.copy()
    fg = s[..., 1:]
    fg[fg < prospect_thresh] = 0.0
    return np.argmax(s, axis=-1)


class ResultWriter:
    """Writes under ``out_path``.  ``save_pred`` takes label maps
    computed on the device; ``save`` takes (H, W, C) scores, thresholds
    them at ``prospect_thresh`` (and through ``crf_fn(img255, scores)``
    when ``use_crf``) and adds the ``heatmap`` and ``scoremap`` outputs
    when asked."""

    def __init__(self, out_path: str, verbose: bool = True, *,
                 prospect_thresh: float = 0.5, heatmap: bool = False,
                 scoremap: bool = False, use_crf: bool = False,
                 crf_fn=None):
        self.root = out_path
        self.verbose = verbose
        self.prospect_thresh = prospect_thresh
        self.heatmap = heatmap
        self.scoremap = scoremap
        self.use_crf = use_crf
        self.crf_fn = crf_fn
        for sub in ("no_crf", "crf", "vis") + (
                ("heatmap",) if heatmap else ()) + (
                ("scoremap",) if scoremap else ()):
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

    def save(self, img_name: str, image01: np.ndarray,
             merged_mask: np.ndarray, gt_mask: Optional[np.ndarray] = None):
        """Args: image01 (H, W, 3) in [0, 1]; merged_mask (H, W, C)
        scores."""
        pred_crf = None
        if self.use_crf and self.crf_fn is not None:
            img255 = np.round(255.0 * image01).astype(np.uint8)
            pred_crf = threshold_and_argmax(self.crf_fn(img255, merged_mask),
                                            self.prospect_thresh)
        pred = threshold_and_argmax(merged_mask, self.prospect_thresh)
        self.save_pred(img_name, image01, pred, pred_crf, gt_mask)

        if not (self.heatmap or self.scoremap):
            return
        name = _stem(img_name)
        score_map = np.max(merged_mask[..., 1:], axis=-1)
        if self.heatmap:
            from PIL import Image

            hm = 0.3 * image01 + 0.7 * colormap("hot", score_map)
            Image.fromarray(np.round(255 * hm).astype(np.uint8)).save(
                os.path.join(self.root, "heatmap", name + ".png"))
        if self.scoremap:
            sm = score_map.copy()
            bgpix = pred == 0
            sm[bgpix] = 1 - sm[bgpix]
            np.save(os.path.join(self.root, "scoremap", name + ".npy"), sm)


class PAMRWriter:
    """Per-iteration PAMR visualiser: for each image, the GT overlay and
    one overlay per refinement iteration (reference
    utils/inference_tools.py:303-346)."""

    def __init__(self, out_path: str):
        self.root = out_path
        os.makedirs(out_path, exist_ok=True)

    @staticmethod
    def _overlay(mask_idx: np.ndarray, image01: np.ndarray,
                 alpha: float = 0.5) -> np.ndarray:
        return alpha * image01 + (1 - alpha) * _mask2rgb(mask_idx)

    def save_image(self, img_name: str, image01: np.ndarray,
                   per_iter_masks, gt_mask: Optional[np.ndarray] = None):
        """per_iter_masks: sequence of (H, W, C) float mask snapshots."""
        from PIL import Image

        name = os.path.basename(img_name).split(".")[0]
        if gt_mask is not None:
            out = np.round(255 * self._overlay(
                gt_mask.astype(np.uint8), image01)).astype(np.uint8)
            Image.fromarray(out).save(
                os.path.join(self.root, name + "_gt.png"))
        for it, m in enumerate(per_iter_masks):
            idx = np.argmax(m, axis=-1).astype(np.uint8)
            idx[m.sum(-1) == 0] = 255
            out = np.round(255 * self._overlay(idx, image01)).astype(
                np.uint8)
            Image.fromarray(out).save(
                os.path.join(self.root, name + "_{:02d}.png".format(it)))
