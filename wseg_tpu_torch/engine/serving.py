"""Batched multi-scale inference server.

Mirror of ``wseg_tpu/engine/serving.py``'s ``MultiScaleServer`` on its
device-view path: callers submit uint8 images and receive futures; one
worker thread groups up to ``max_batch`` images of the same view-shape
signature, pads the group to ``max_batch`` slots (one tensor shape per
signature), uploads each original once, and runs per scale the fused
views -> forward -> merge step, then the device writer math.

With the exact CRF (``TEST.CRF_MODE: exact``) the writer math returns
the merged maps too, and each image's exact CRF runs as a job on a pool
of two host threads: the host lattice build from the image's original
pixels, the mean field on the card, and the image's future resolved from
there.  At most four jobs are in flight (each holds its group's merged
maps); the worker goes on to the next group meanwhile.

Left out against the JAX server: the device mesh, the finisher thread,
the host-view fallback for images larger than the canvas, and chunking
of the postprocess by memory budget.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from wseg_tpu_torch.data.multiscale import MultiscaleViews, _round_up
from wseg_tpu_torch.engine.infer import make_infer_merge_fn
from wseg_tpu_torch.ops.view_gen import build_views_u8


class MultiScaleServer:
    def __init__(self, model, test_cfg, max_batch: int = 4,
                 max_wait_ms: float = 5.0, postprocess=None):
        self.model = model
        self.cfg = test_cfg
        self.device = next(model.parameters()).device
        scales = [float(s) for s in test_cfg.SCALES]
        if not (bool(test_cfg.UINT8_TRANSFER) and bool(test_cfg.DEVICE_VIEWS)
                and bool(test_cfg.DEVICE_MERGE) and scales
                and scales[0] == 1.0):
            raise NotImplementedError(
                "only the device-view path is ported (TEST.UINT8_TRANSFER, "
                "DEVICE_VIEWS and DEVICE_MERGE on, first scale 1.0)")
        self.views = MultiscaleViews(
            scales, bool(test_cfg.FLIP), test_cfg.PAD_SIZE,
            bool(test_cfg.PAD_PER_SCALE), int(test_cfg.PAD_ALIGN))
        self.infer_mv = make_infer_merge_fn(model)
        ph, pw = (int(p) for p in test_cfg.PAD_SIZE)
        ms = max(scales)
        self.canvas_hw = (_round_up(int(ph / ms), 64),
                          _round_up(int(pw / ms), 64))
        self.postprocess = postprocess
        self._crf_pool = None
        if getattr(postprocess, "exact", None) is not None:
            # two threads: one image's host lattice build (the C++ call
            # releases the GIL) overlaps another's device mean field
            self._crf_pool = ThreadPoolExecutor(2)
            self._crf_slots = threading.BoundedSemaphore(4)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._stash = deque()  # different-signature arrivals, oldest first
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- API
    def warmup(self, image_sizes: List[Tuple[int, int]]):
        """Run one synthetic group per (width, height) signature on the
        caller's thread, so first-use costs (kernel build, library
        handles, allocator growth) stay out of served requests."""
        seen = set()
        nc1 = int(self.cfg.NUM_CLASSES) - 1
        for (w, h) in image_sizes:
            sig = tuple(self.views.view_shapes(w, h))
            if sig in seen:
                continue
            seen.add(sig)
            fut: Future = Future()
            self._process([(np.zeros((h, w, 3), np.uint8),
                            np.zeros(nc1, np.float32), fut)])
            fut.result()

    def submit(self, image_u8: np.ndarray,
               gt_labels: Optional[np.ndarray] = None) -> Future:
        """``image_u8`` (H, W, 3) uint8 RGB.  The future resolves to
        (result, labels): result is the postprocess's {thresh: {"pred",
        "pred_crf"}} when one is set, else the merged (H, W, C) scores."""
        image_u8 = np.asarray(image_u8)
        if image_u8.dtype != np.uint8 or image_u8.ndim != 3:
            raise ValueError("expected an (H, W, 3) uint8 image")
        fut: Future = Future()
        self._q.put((image_u8, gt_labels, fut))
        return fut

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=60)
        if self._crf_pool is not None:
            self._crf_pool.shutdown(wait=True)
        orphans = list(self._stash)
        self._stash.clear()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                orphans.append(item)
        for _, _, fut in orphans:
            if not fut.done():
                fut.set_exception(RuntimeError(
                    "MultiScaleServer closed before this image was "
                    "processed"))

    # ---------------------------------------------------------- worker
    def _group_sig(self, image_u8):
        h, w = image_u8.shape[:2]
        return tuple(self.views.view_shapes(w, h))

    def _collect_group(self):
        """Up to ``max_batch`` same-signature images within the wait
        window; different-signature arrivals are stashed in arrival
        order and served first next time."""
        def pop(timeout=None):
            if self._stash:
                return self._stash.popleft()
            if timeout is None:
                return self._q.get()
            return self._q.get(timeout=timeout)

        item = pop()
        if item is None:
            return []
        group = [item]
        sig0 = self._group_sig(item[0])
        misfits = []
        deadline = time.time() + self.max_wait
        while len(group) < self.max_batch:
            timeout = deadline - time.time()
            if timeout <= 0:
                break
            try:
                nxt = pop(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)
                break
            if self._group_sig(nxt[0]) == sig0:
                group.append(nxt)
            else:
                misfits.append(nxt)
        if misfits:
            misfits.extend(self._stash)
            self._stash = deque(misfits)
        return group

    def _run(self):
        while not self._stop.is_set():
            group = self._collect_group()
            if not group:
                if self._stop.is_set():
                    return
                continue
            try:
                self._process(group)
            except Exception as e:  # resolve the group, keep serving
                for _, _, fut in group:
                    if not fut.done():
                        fut.set_exception(e)

    def _labels(self, cls_views, gt_labels):
        if bool(self.cfg.USE_GT_LABELS) and gt_labels is not None:
            return np.asarray(gt_labels, np.float32)
        sig = 1.0 / (1.0 + np.exp(-np.stack(cls_views)))
        return (sig.max(axis=0) >
                float(self.cfg.FP_CUT_SCORE)).astype(np.float32)

    @torch.inference_mode()
    def _process(self, group):
        """One group: upload, per-scale fused forward + merge, writer
        math, resolve the futures."""
        cap, n, dev = self.max_batch, len(group), self.device
        with record_function("serve.upload"):
            canv = np.zeros((cap, *self.canvas_hw, 3), np.uint8)
            owin = np.zeros((cap, 4), np.int32)
            pads_all, sizes = [], []
            for gi, (image, _, _) in enumerate(group):
                c, ow, pads, _ = self.views.build_device(image,
                                                         self.canvas_hw)
                canv[gi] = c
                owin[gi] = ow
                pads_all.append(pads)
                sizes.append(image.shape[:2])
            orig = torch.from_numpy(canv).to(dev)
            owin_d = torch.from_numpy(owin).to(dev)
        h0, w0 = sizes[0]
        shapes = self.views.view_shapes(w0, h0)
        vpi = 2 if self.views.flip else 1

        dstwin = np.zeros((cap, 4), np.int32)
        for gi in range(n):
            dstwin[gi] = pads_all[gi][0]
        dst_d = torch.from_numpy(dstwin).to(dev)
        total, u8, cls_list = None, None, []
        for si, shp in enumerate(shapes):
            vwin = np.zeros((cap, 4), np.int32)
            for gi in range(n):
                vwin[gi] = pads_all[gi][si * vpi]
            vw_d = torch.from_numpy(vwin).to(dev)
            cls, part = self.infer_mv(orig, owin_d, vw_d, dst_d,
                                      out_hw=tuple(shp),
                                      flip_pair=self.views.flip,
                                      merge_hw=tuple(shapes[0]))
            total = part if total is None else total + part
            cls_list.append(cls)
            if si == 0 and self.postprocess is not None:
                # the scale-1.0 pixels for the CRF, kept on the device
                u8 = build_views_u8(orig, owin_d, vw_d, out_hw=tuple(shp),
                                    flip_pair=False)

        use_gt = (bool(self.cfg.USE_GT_LABELS)
                  and all(g[1] is not None for g in group))
        if self.postprocess is None:
            self._resolve_merged(group, pads_all, sizes, total, cls_list,
                                 vpi)
            return
        pp = self.postprocess
        exact = pp.exact is not None
        if use_gt:
            labels = np.zeros((cap, total.shape[-1] - 1), np.float32)
            for gi in range(n):
                labels[gi] = group[gi][1]
            out = pp.dispatch_group(total, labels, dstwin, u8,
                                    self.views.num_views)
            preds, merged = out if exact else (out, None)
        else:
            out = pp.dispatch_group_cls(
                total, cls_list, dstwin, u8, self.views.num_views,
                float(self.cfg.FP_CUT_SCORE))
            preds, labels, merged = out if exact else (*out, None)
        crf_jobs = (self._exact_jobs(group, pads_all, merged) if exact
                    else [None] * n)
        if not use_gt:
            labels = labels[:n].cpu().numpy()
        preds = preds[:n].cpu().numpy()
        for gi, (_, _, fut) in enumerate(group):
            self._resolve(fut, pads_all[gi][0], sizes[gi], preds[gi],
                          labels[gi], crf_jobs[gi])

    def _exact_jobs(self, group, pads_all, merged):
        """One exact-CRF job per image on the CRF pool: host lattice build
        from the original pixels, then the mean field on the card over
        the image's merged map.  Returns the jobs' futures, each ->
        (n_crf, Hc, Wc) uint8 numpy."""
        ex = self.postprocess.exact
        canvas_hw = tuple(merged.shape[1:3])

        def job(image, window, row):
            try:
                with torch.inference_mode():
                    tables = ex.build(image, canvas_hw, window,
                                      device=merged.device)
                    return ex.run(tables, merged[row]).cpu().numpy()
            finally:
                self._crf_slots.release()

        jobs = []
        for gi, (image, _, _) in enumerate(group):
            self._crf_slots.acquire()  # backpressure on the worker
            jobs.append(self._crf_pool.submit(job, image, pads_all[gi][0],
                                              gi))
        return jobs

    def _resolve(self, fut, window, size_hw, preds, labels, crf_job):
        """Resolve one image's future: now, or when its exact-CRF job
        ends (on the pool thread that ran it)."""
        pp = self.postprocess
        if crf_job is None:
            fut.set_result((pp.finalize(preds, window, size_hw), labels))
            return

        def done(job):
            try:
                res = pp.finalize(preds, window, size_hw, job.result())
            except Exception as e:
                fut.set_exception(e)
            else:
                fut.set_result((res, labels))

        crf_job.add_done_callback(done)

    def _resolve_merged(self, group, pads_all, sizes, total, cls_list, vpi):
        """No postprocess: cut each image's merged map out of the canvas,
        clean absent classes and apply BG^BG_POW on the host."""
        sums = total[:len(group)].cpu().numpy() / float(self.views.num_views)
        cls_np = [c.float().cpu().numpy() for c in cls_list]
        for gi, (_, gt_labels, fut) in enumerate(group):
            cls_views = [c[gi * vpi + f] for c in cls_np for f in range(vpi)]
            labels = self._labels(cls_views, gt_labels)
            pt, pl, vh, vw = pads_all[gi][0]
            merged = sums[gi, pt:pt + vh, pl:pl + vw].copy()
            merged[..., 1:] *= labels[None, None, :]
            merged[..., 0] = np.power(merged[..., 0],
                                      float(self.cfg.BG_POW))
            fut.set_result((merged, labels))
