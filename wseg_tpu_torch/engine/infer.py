"""Multi-scale / multi-crop inference: views -> forward -> merge ->
writer math with the dense CRF.

Mirror of ``wseg_tpu/engine/infer.py``: ``make_infer_fn`` (test-mode
forward of host views, normalised on the device in uint8 mode),
``make_infer_merge_fn`` (device views, normalise, test-mode forward,
tent-matrix merge onto the scale-1.0 canvas), ``_device_merge_bucket``
and ``finalize_device_merge`` (the host-view path's device merge and its
host tail), ``make_device_postprocess`` (clean -> BG^pow -> CRF ->
threshold -> argmax), slot-batched, and ``InferenceEngine``, the
per-image path (host or device merge, multi-crop).  ``TEST.CRF_MODE``
picks the CRF: ``fast``, the coarse-to-fine sparse-tap CRF inside the
batched writer math, or ``exact``, where the batched program also
returns the merged maps and ``ExactCRF`` runs the exact permutohedral
mean field per image (host lattice build, CUDA filter kernels).  Only
uint8 label maps leave the device on the batched paths.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from wseg_tpu_torch.data.multiscale import (
    CropViews,
    MultiscaleViews,
    merge_crops,
    merge_multiscale,
)
from wseg_tpu_torch.data.pascal_voc import MEAN, STD
from wseg_tpu_torch.ops.crf import crf_inference_torch
from wseg_tpu_torch.ops.crf_exact import build_exact_lattice, crf_exact
from wseg_tpu_torch.ops.crf_lattice import (
    LatticeTables,
    bilateral_features,
    gaussian_features,
)
from wseg_tpu_torch.ops.crf_native import SRGB, SXY_BILATERAL, SXY_GAUSSIAN
from wseg_tpu_torch.ops.view_gen import build_views_u8

_CRF_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _tent_matrix(dst_n: int, src_n: int, dst_start, dst_len, src_start,
                 src_len, flip) -> torch.Tensor:
    """(..., dst_n, src_n) bilinear-sampling matrices.

    Maps the dst window [dst_start, dst_start+dst_len) onto the src
    window [src_start, src_start+src_len) with half-pixel sampling and
    edge clamping (the reference merge's resize of the cut view),
    optionally mirrored.  Window parameters are (...) float tensors,
    ``flip`` a (...) bool tensor.  Rows outside the dst window replicate
    the window edge; they are cut on the host.
    """
    ds, dl = dst_start[..., None, None], dst_len[..., None, None]
    ss, sl = src_start[..., None, None], src_len[..., None, None]
    dev = ds.device
    i = torch.arange(dst_n, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(src_n, dtype=torch.float32, device=dev)[None, :]
    y = (i - ds + 0.5) * (sl / dl) - 0.5
    y = torch.where(flip[..., None, None], sl - 1.0 - y, y)
    y = torch.minimum(torch.clamp(y, min=0.0), sl - 1.0) + ss
    return F.relu(1.0 - torch.abs(y - j))


def _merge_views(masks: torch.Tensor, src_windows: torch.Tensor,
                 dst_windows: torch.Tensor, flips: torch.Tensor,
                 H: int, W: int) -> torch.Tensor:
    """Window-to-window resize + sum of each slot's views.

    Args:
      masks: (S, V, Hs, Ws, C) per-view mask scores (padded canvas).
      src_windows: (S, V, 4) float (top, left, h, w) view windows.
      dst_windows: (S, 4) float window of the scale-1.0 view in the
        merge canvas; every view maps onto it.
      flips: (V,) bool.
      H, W: merge canvas size.
    Returns:
      (S, H, W, C) sum over views.
    """
    hs, ws, c = masks.shape[2:]
    dst = dst_windows[:, None, :]
    A_h = _tent_matrix(H, hs, dst[..., 0], dst[..., 2],
                       src_windows[..., 0], src_windows[..., 2],
                       torch.zeros_like(flips))             # (S, V, H, hs)
    A_w = _tent_matrix(W, ws, dst[..., 1], dst[..., 3],
                       src_windows[..., 1], src_windows[..., 3],
                       flips)                               # (S, V, W, ws)
    t = torch.matmul(A_h, masks.float().flatten(-2))        # (S,V,H,ws*c)
    t = t.unflatten(-1, (ws, c)).transpose(-3, -2)          # (S,V,ws,H,c)
    out = torch.matmul(A_w, t.flatten(-2))                  # (S,V,W,H*c)
    out = out.unflatten(-1, (H, c)).transpose(-3, -2)       # (S,V,H,W,c)
    return out.sum(dim=1)


def _device_merge_bucket(masks: torch.Tensor, src_windows, dst_window,
                         flips, merge_hw) -> torch.Tensor:
    """One image's bucket views (V, Hs, Ws, C) -> its (H, W, C) partial
    sum on the merge canvas ``merge_hw``; windows (V, 4) and (4,), flips
    (V,) bool."""
    dev = masks.device
    src = torch.as_tensor(np.asarray(src_windows, np.float32), device=dev)
    dst = torch.as_tensor(np.asarray(dst_window, np.float32), device=dev)
    fl = torch.as_tensor(np.asarray(flips, bool), device=dev)
    return _merge_views(masks[None], src[None], dst[None], fl,
                        int(merge_hw[0]), int(merge_hw[1]))[0]


def finalize_device_merge(sum_map: np.ndarray, dst_window, size_hw,
                          labels: np.ndarray, n_views: int,
                          bg_pow: float) -> np.ndarray:
    """Host tail of the device merge: cut the scale-1.0 window, resize it
    to the original size (OpenCV bilinear), zero the absent classes,
    BG^bg_pow."""
    import cv2

    pt, pl, vh, vw = dst_window
    merged = np.asarray(sum_map, np.float32) / float(n_views)
    merged = merged[pt:pt + vh, pl:pl + vw]
    merged = cv2.resize(merged, (size_hw[1], size_hw[0]),
                        interpolation=cv2.INTER_LINEAR)
    merged[..., 1:] *= labels[None, None, :]
    merged[..., 0] = np.power(merged[..., 0], bg_pow)
    return merged


def normalise_in_window(views_u8: torch.Tensor,
                        windows: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 views -> ImageNet-normalised float32, zero
    outside each view's (top, left, h, w) window (B, 4): the host path
    normalises the resized pixels, then pastes them into a zero canvas."""
    dev = views_u8.device
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(STD, dtype=torch.float32, device=dev)
    x = (views_u8.float() / 255.0 - mean) / std
    h, w = views_u8.shape[1:3]
    ri = torch.arange(h, device=dev)[None, :, None, None]
    ci = torch.arange(w, device=dev)[None, None, :, None]
    pt, pl, vh, vw = (windows.long()[:, k, None, None, None]
                      for k in range(4))
    inside = (ri >= pt) & (ri < pt + vh) & (ci >= pl) & (ci < pl + vw)
    return torch.where(inside, x, torch.zeros_like(x))


def make_infer_fn(model, device_norm: bool = False):
    """Test-mode forward of host-built views on the model's device.

    fn(views) -> (cls (B, C-1), masks (B, H, W, C)) for float32
    normalised views, or with ``device_norm`` fn(views_u8, windows (B, 4))
    for uint8 views, normalised and zeroed outside each window on the
    device.  Views are numpy arrays or tensors; outputs stay on the
    device.
    """
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def infer(views, windows=None):
        x = torch.as_tensor(views).to(dev)
        if device_norm:
            win = torch.as_tensor(np.asarray(windows, np.int32)).to(dev)
            x = normalise_in_window(x, win)
        with record_function("serve.forward"):
            out = model(x)
        return out.cls, out.masks

    return infer


def make_infer_merge_fn(model):
    """Fused device step for one scale bucket: view generation ->
    normalise/pad -> test-mode forward -> per-slot merge of the bucket's
    views onto the merge canvas.

    fn(orig_u8 (S, Hc, Wc, 3), owin (S, 4), vwin (S, 4), dstwin (S, 4),
    out_hw=(ph, pw), flip_pair=bool, merge_hw=(mh, mw))
    -> (cls (S*vpi, C-1), partial sums (S, mh, mw, C)).
    """
    @torch.inference_mode()
    def infer_mv(orig_u8, owin, vwin, dstwin, *, out_hw, flip_pair,
                 merge_hw):
        dev = orig_u8.device
        vpi = 2 if flip_pair else 1
        with record_function("serve.views"):
            views_u8 = build_views_u8(orig_u8, owin, vwin, out_hw=out_hw,
                                      flip_pair=flip_pair)
            x = normalise_in_window(
                views_u8, torch.repeat_interleave(vwin, vpi, dim=0))
        with record_function("serve.forward"):
            out = model(x)
        with record_function("serve.merge"):
            masks = out.masks.float()
            s = orig_u8.shape[0]
            m = masks.reshape(s, vpi, *masks.shape[1:])
            flips = torch.tensor([False, True][:vpi], device=dev)
            src = vwin.float()[:, None, :].expand(s, vpi, 4)
            sums = _merge_views(m, src, dstwin.float(), flips,
                                merge_hw[0], merge_hw[1])
        return out.cls, sums

    return infer_mv


def _pred(m: torch.Tensor, t: float) -> torch.Tensor:
    """(..., C) scores -> (...) uint8 argmax, foreground scores below
    ``t`` zeroed."""
    fgm = torch.where(m[..., 1:] < t, torch.zeros_like(m[..., 1:]),
                      m[..., 1:])
    return torch.argmax(torch.cat([m[..., :1], fgm], dim=-1),
                        dim=-1).to(torch.uint8)


def _postprocess(sum_maps, labels, windows, imgs_u8, *, n_views, bg_pow,
                 threshs, crf_threshs, crf_iters, crf_dtype, crf_stride,
                 crf_tap_div, crf_full_stride, crf_refine_iters,
                 ret_merged=False):
    """Slot-batched writer math: clean -> BG^pow -> (CRF) -> threshold
    -> argmax at the merge-canvas shape.  (S, H, W, C) sums ->
    (S, K, H, W) uint8 with K = len(threshs) + len(crf_threshs), and
    with ``ret_merged`` also the cleaned (S, H, W, C) maps the exact CRF
    takes."""
    merged = sum_maps.float() / float(n_views)
    fg = merged[..., 1:] * labels[:, None, None, :]
    bg = torch.pow(torch.clamp(merged[..., :1], min=0.0), float(bg_pow))
    merged = torch.cat([bg, fg], dim=-1)

    with record_function("serve.writer"):
        preds = [_pred(merged, float(t)) for t in threshs]
    if crf_threshs:
        with record_function("serve.crf"):
            s, h, w = merged.shape[:3]
            dev = merged.device
            ri = torch.arange(h, device=dev)[None, :, None]
            ci = torch.arange(w, device=dev)[None, None, :]
            win = windows.long()
            valid = ((ri >= win[:, 0, None, None])
                     & (ri < (win[:, 0] + win[:, 2])[:, None, None])
                     & (ci >= win[:, 1, None, None])
                     & (ci < (win[:, 1] + win[:, 3])[:, None, None]))
            q = crf_inference_torch(
                imgs_u8.float(), merged, t=int(crf_iters),
                valid_mask=valid.float()[..., None],
                dtype=_CRF_DTYPES[crf_dtype],
                bilateral_stride=int(crf_stride),
                tap_spacing_div=float(crf_tap_div),
                full_stride=int(crf_full_stride),
                refine_iters=int(crf_refine_iters))
            preds += [_pred(q, float(t)) for t in crf_threshs]
    preds = torch.stack(preds, dim=1)
    return (preds, merged) if ret_merged else preds


class ExactCRF:
    """Per-image exact permutohedral CRF for the serving path
    (``TEST.CRF_MODE: exact``), the port of ``wseg_tpu/engine/infer.py``
    ``ExactCRF``.

    ``build`` hashes the image's lattices on the host from its ORIGINAL
    pixels and uploads the tables; ``run`` takes the image's merged map
    on the card through ``ops/crf_exact.crf_exact`` and thresholds it.
    The Gaussian lattice depends only on the canvas and the window, so it
    is built once per geometry and kept on the device; the per-image
    host build is the bilateral half.  ``build`` and ``run`` may be
    called from several threads.
    """

    def __init__(self, crf_threshs: Sequence[float], crf_iters: int = 10):
        self.crf_threshs = tuple(float(t) for t in crf_threshs)
        self.iters = int(crf_iters)
        self._gauss_cache = {}
        self._lock = threading.Lock()

    def build(self, img_rgb_u8: np.ndarray, canvas_hw, window,
              device="cpu") -> Tuple[LatticeTables, LatticeTables]:
        """``img_rgb_u8``: the (h, w, 3) uint8 pixels that sit at
        ``window`` (top, left, h, w) of the (Hc, Wc) merge canvas.
        Returns the (Gaussian, bilateral) tables on ``device``."""
        hc, wc = (int(v) for v in canvas_hw)
        pt, pl, h, w = (int(v) for v in window)
        if img_rgb_u8.shape != (h, w, 3):
            raise ValueError(f"image {img_rgb_u8.shape} for window {window}")
        valid = np.zeros((hc, wc), bool)
        valid[pt:pt + h, pl:pl + w] = True
        valid = valid.reshape(-1)
        key = (hc, wc, pt, pl, h, w, str(device))
        with self._lock:
            gauss = self._gauss_cache.get(key)
        if gauss is None:
            gauss = build_exact_lattice(
                gaussian_features((h, w), SXY_GAUSSIAN), hc * wc,
                valid).to(device)
            with self._lock:
                if len(self._gauss_cache) >= 64:  # few geometries per run
                    self._gauss_cache.pop(next(iter(self._gauss_cache)))
                self._gauss_cache[key] = gauss
        bilat = build_exact_lattice(
            bilateral_features(img_rgb_u8, SXY_BILATERAL, SRGB), hc * wc,
            valid)
        return gauss, bilat.to(device)

    @torch.inference_mode()
    def q(self, tables, merged: torch.Tensor) -> torch.Tensor:
        """(Hc, Wc, C) merged map -> (Hc, Wc, C) float32 mean-field Q."""
        return crf_exact(merged, *tables, t=self.iters)

    @torch.inference_mode()
    def run(self, tables, merged: torch.Tensor) -> torch.Tensor:
        """(Hc, Wc, C) merged map -> (n_crf_threshs, Hc, Wc) uint8."""
        with record_function("serve.crf_exact"):
            q = self.q(tables, merged)
            return torch.stack([_pred(q, t) for t in self.crf_threshs])


class DevicePostprocess:
    """Writer math on the device for the serving path.

    ``dispatch_group`` takes image-level labels from the caller (GT);
    ``dispatch_group_cls`` computes them on the device from the
    per-view cls logits (sigmoid, max over views, > FP_CUT_SCORE).  With
    the exact CRF (``exact`` is an ``ExactCRF``) the batched program
    runs no CRF and both also return the merged maps, which the caller
    hands to ``exact.build``/``exact.run`` per image.  ``finalize`` cuts
    one image's label maps out of the canvas.
    """

    def __init__(self, threshs: Sequence[float],
                 crf_threshs: Sequence[float], crf_iters: int = 10,
                 bg_pow: float = 3.0, crf_dtype: str = "bfloat16",
                 crf_stride: int = 1, crf_tap_div: float = 2.0,
                 crf_full_stride: int = 1, crf_refine_iters: int = 0,
                 crf_mode: str = "fast"):
        if crf_dtype not in _CRF_DTYPES:
            raise ValueError(f"CRF_DTYPE must be one of "
                             f"{sorted(_CRF_DTYPES)}, got {crf_dtype!r}")
        if crf_mode not in ("fast", "exact"):
            raise ValueError(f"CRF_MODE must be 'fast' or 'exact', got "
                             f"{crf_mode!r}")
        self.threshs = tuple(float(t) for t in threshs)
        self.crf_threshs = tuple(float(t) for t in crf_threshs)
        self.exact = (ExactCRF(self.crf_threshs, crf_iters=crf_iters)
                      if crf_mode == "exact" and self.crf_threshs else None)
        self._kw = dict(threshs=self.threshs,
                        crf_threshs=() if self.exact else self.crf_threshs,
                        crf_iters=int(crf_iters), bg_pow=float(bg_pow),
                        crf_dtype=str(crf_dtype),
                        crf_stride=int(crf_stride),
                        crf_tap_div=float(crf_tap_div),
                        crf_full_stride=int(crf_full_stride),
                        crf_refine_iters=int(crf_refine_iters),
                        ret_merged=self.exact is not None)

    @torch.inference_mode()
    def dispatch_group(self, sum_maps, labels, windows, imgs_u8, n_views):
        """(S, H, W, C) sums, (S, C-1) labels, (S, 4) windows,
        (S, H, W, 3) uint8 scale-1.0 views -> (S, K, H, W) uint8, and in
        exact mode (preds, merged (S, H, W, C))."""
        dev = sum_maps.device
        return _postprocess(
            sum_maps, torch.as_tensor(labels, dtype=torch.float32,
                                      device=dev),
            torch.as_tensor(windows, device=dev), imgs_u8,
            n_views=int(n_views), **self._kw)

    @torch.inference_mode()
    def dispatch_group_cls(self, sum_maps, cls_list, windows, imgs_u8,
                           n_views, fp_cut):
        """Predicted-labels variant: ``cls_list`` holds per-scale
        (S*vpi, C-1) logits, scale-major.  Returns (preds (S, K, H, W)
        uint8, labels (S, C-1) float32), and in exact mode the merged
        maps third."""
        cls = torch.stack(list(cls_list))                  # (ns, S*vpi, C-1)
        ns, sv, c1 = cls.shape
        s_slots = sum_maps.shape[0]
        vpi = sv // s_slots
        cls = cls.reshape(ns, s_slots, vpi, c1).transpose(0, 1)
        sig = torch.sigmoid(cls.reshape(s_slots, ns * vpi, c1).float())
        labels = (sig.amax(dim=1) > float(fp_cut)).float()
        out = self.dispatch_group(sum_maps, labels, windows, imgs_u8,
                                  n_views)
        if self.exact is not None:
            return out[0], labels, out[1]
        return out, labels

    def finalize(self, preds_np: np.ndarray, window, size_hw,
                 crf_preds_np: Optional[np.ndarray] = None):
        """(K, H, W) label maps (and in exact mode the ExactCRF's
        (n_crf, H, W)) -> {thresh: {"pred", "pred_crf"}} at the image's
        own size (the scale-1.0 window is the original image)."""
        pt, pl, vh, vw = window
        if (vh, vw) != tuple(size_hw):
            raise ValueError(f"window {window} does not match image "
                             f"{size_hw}")
        cut = preds_np[:, pt:pt + vh, pl:pl + vw]
        out = {}
        for k, t in enumerate(self.threshs):
            out[t] = {"pred": cut[k]}
        if self.exact is not None:
            crf_cut = crf_preds_np[:, pt:pt + vh, pl:pl + vw]
        else:
            crf_cut = cut[len(self.threshs):]
        for k, t in enumerate(self.crf_threshs):
            out.setdefault(t, {})["pred_crf"] = crf_cut[k]
        return out


def make_device_postprocess(threshs, crf_threshs, crf_iters: int = 10,
                            bg_pow: float = 3.0,
                            crf_dtype: str = "bfloat16",
                            crf_stride: int = 1,
                            crf_tap_div: float = 2.0,
                            crf_full_stride: int = 1,
                            crf_refine_iters: int = 0,
                            crf_mode: str = "fast") -> DevicePostprocess:
    """Device writer math for ``MultiScaleServer``; ``crf_mode`` "fast"
    (coarse-to-fine CRF in the batched program) or "exact" (per-image
    ``ExactCRF``)."""
    return DevicePostprocess(threshs, crf_threshs, crf_iters=crf_iters,
                             bg_pow=bg_pow, crf_dtype=crf_dtype,
                             crf_stride=crf_stride, crf_tap_div=crf_tap_div,
                             crf_full_stride=crf_full_stride,
                             crf_refine_iters=crf_refine_iters,
                             crf_mode=crf_mode)


class InferenceEngine:
    """Per-image inference (the JAX ``InferenceEngine``): an image's
    views are built on the host, forwarded per bucket shape on the
    model's device, and merged on the host (``merge_multiscale``,
    ``merge_crops``) or, with ``TEST.DEVICE_MERGE`` in multiscale mode,
    on the device with only the merged map fetched.  ``run_image``
    returns the (H, W, C) scores and the image-level labels that the
    writers' ``ResultWriter.save`` takes."""

    def __init__(self, model, test_cfg):
        self.model = model
        self.cfg = test_cfg
        method = str(test_cfg.METHOD)
        self.uint8 = (method == "multiscale"
                      and bool(test_cfg.UINT8_TRANSFER))
        self.infer = make_infer_fn(model, device_norm=self.uint8)
        if method == "multiscale":
            self.views = MultiscaleViews(
                test_cfg.SCALES, bool(test_cfg.FLIP), test_cfg.PAD_SIZE,
                bool(test_cfg.PAD_PER_SCALE), int(test_cfg.PAD_ALIGN),
                transfer="uint8" if self.uint8 else "float32")
        elif method in ("multicrop", "crop"):
            self.views = CropViews(test_cfg.CROP_SIZE,
                                   test_cfg.CROP_GRID_SIZE,
                                   test_cfg.PAD_SIZE, bool(test_cfg.FLIP))
        else:
            raise NotImplementedError(f"Method {method} is unknown")
        self.method = method

    def _infer_batch(self, batch, windows):
        if self.uint8:
            return self.infer(batch, windows)
        return self.infer(batch)

    @staticmethod
    def _buckets(views):
        buckets = {}
        for i, v in enumerate(views):
            buckets.setdefault(v.shape[:2], []).append(i)
        return buckets

    def _forward_views(self, views, pads=None):
        """Same-shape views batched per bucket, every bucket launched
        before any is fetched; per-view (cls, mask) numpy in view order."""
        pending = []
        for idxs in self._buckets(views).values():
            batch = np.stack([views[i] for i in idxs])
            wins = [pads[i] for i in idxs] if pads is not None else None
            pending.append((idxs, self._infer_batch(batch, wins)))
        cls_out, mask_out = [None] * len(views), [None] * len(views)
        for idxs, (cls, masks) in pending:
            cls = cls.float().cpu().numpy()
            masks = masks.float().cpu().numpy()
            for k, i in enumerate(idxs):
                cls_out[i], mask_out[i] = cls[k], masks[k]
        return cls_out, mask_out

    def predict_labels(self, cls_views, gt_labels: np.ndarray) -> np.ndarray:
        """GT labels, or sigmoid-max over the views > FP_CUT_SCORE."""
        if bool(self.cfg.USE_GT_LABELS):
            return np.asarray(gt_labels, np.float32)
        sig = 1.0 / (1.0 + np.exp(-np.stack(cls_views)))
        return (sig.max(axis=0) >
                float(self.cfg.FP_CUT_SCORE)).astype(np.float32)

    def run_image(self, image_u8: np.ndarray, gt_labels: np.ndarray):
        """(h, w, 3) uint8 image -> (merged (h, w, C) float32 scores,
        labels (C-1,))."""
        h, w = image_u8.shape[:2]
        if self.method != "multiscale":
            views, coords, flips = self.views.build(image_u8)
            cls_views, mask_views = self._forward_views(views)
            labels = self.predict_labels(cls_views, gt_labels)
            return merge_crops(mask_views, coords, flips, labels,
                               (h, w)), labels
        if bool(self.cfg.DEVICE_MERGE):
            return self._run_image_device_merge(image_u8, gt_labels)
        views, pads, flips = self.views.build(image_u8)
        cls_views, mask_views = self._forward_views(views, pads)
        labels = self.predict_labels(cls_views, gt_labels)
        return merge_multiscale(mask_views, pads, flips, labels, (h, w),
                                float(self.cfg.BG_POW)), labels

    @torch.inference_mode()
    def _run_image_device_merge(self, image_u8, gt_labels):
        """Views merged per bucket on the device at the scale-1.0 bucket's
        resolution; only the merged map is fetched."""
        h, w = image_u8.shape[:2]
        views, pads, flips = self.views.build(image_u8)
        merge_hw = self.views.view_shapes(w, h)[0]
        cls_views, sum_m = [None] * len(views), None
        for idxs in self._buckets(views).values():
            cls, masks = self._infer_batch(np.stack([views[i] for i in idxs]),
                                           [pads[i] for i in idxs])
            for k, i in enumerate(idxs):
                cls_views[i] = cls[k]
            m = _device_merge_bucket(masks.float(), [pads[i] for i in idxs],
                                     pads[0], [flips[i] for i in idxs],
                                     merge_hw)
            sum_m = m if sum_m is None else sum_m + m
        labels = self.predict_labels(
            [c.float().cpu().numpy() for c in cls_views], gt_labels)
        return finalize_device_merge(sum_m.cpu().numpy(), pads[0], (h, w),
                                     labels, len(views),
                                     float(self.cfg.BG_POW)), labels
