"""Multi-scale inference on the device: views -> forward -> merge ->
writer math with the dense CRF.

Mirror of the fast path of ``wseg_tpu/engine/infer.py``:
``make_infer_merge_fn`` (device views, normalise, test-mode forward,
tent-matrix merge onto the scale-1.0 canvas) and
``make_device_postprocess`` (clean -> BG^pow -> CRF -> threshold ->
argmax), both slot-batched.  ``TEST.CRF_MODE`` picks the CRF: ``fast``,
the coarse-to-fine sparse-tap CRF inside the batched writer math, or
``exact``, where the batched program also returns the merged maps and
``ExactCRF`` runs the exact permutohedral mean field per image (host
lattice build, CUDA filter kernels).  Only uint8 label maps leave the
device.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

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
            mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
            std = torch.tensor(STD, dtype=torch.float32, device=dev)
            views_u8 = build_views_u8(orig_u8, owin, vwin, out_hw=out_hw,
                                      flip_pair=flip_pair)
            x = (views_u8.float() / 255.0 - mean) / std
            h, w = out_hw
            win = torch.repeat_interleave(vwin.long(), vpi, dim=0)
            ri = torch.arange(h, device=dev)[None, :, None, None]
            ci = torch.arange(w, device=dev)[None, None, :, None]
            pt, pl, vh, vw_ = (win[:, k, None, None, None] for k in range(4))
            inside = ((ri >= pt) & (ri < pt + vh) &
                      (ci >= pl) & (ci < pl + vw_))
            x = torch.where(inside, x, torch.zeros_like(x))
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
