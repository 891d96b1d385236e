"""Batched multi-scale inference server.

Mirror of ``wseg_tpu/engine/serving.py``'s ``MultiScaleServer``: callers
submit uint8 images and receive futures; one worker thread groups up to
``max_batch`` images of the same view-shape signature and launches the
group's device work, and one finisher thread fetches and resolves group
N while the worker launches group N+1 (at most two groups wait on the
finisher, each holding its device tensors).

Two view paths:

- device views (``TEST.UINT8_TRANSFER`` and ``DEVICE_VIEWS`` on, first
  scale 1.0): the group is padded to ``max_batch`` slots, each original
  is uploaded once into a canvas, and per scale the fused views ->
  forward -> merge step runs on the device;
- host views (otherwise, and for the images of a group that exceed the
  device canvas): PIL views per image, one forward per bucket shape
  over the group's views of that shape (no padding), then the views
  merged on the device per image (``TEST.DEVICE_MERGE``, or whenever a
  postprocess is set, since the writer math takes device sums) or
  fetched and merged on the host.

With a postprocess the writer math runs on the device over the live
rows only, in chunks of at most ``_pp_slot_cap`` slots, whose bytes
come from the fast CRF's peak per slot measured on the card
(``PP_BYTES_PER_CANVAS_BYTE``) against the memory the device has left.
With the exact CRF (``TEST.CRF_MODE: exact``) the writer math returns
the merged maps too, and each image's exact CRF runs as a job on a pool
of two host threads (host lattice build, mean field on the device); at
most four jobs are in flight.

A server owns one device (the model's) and has no ``mesh`` argument:
where the JAX server shards one slot batch over the devices, the port
runs one replica per device, each in a process of its own that serves
its share of the images (``infer_val`` under ``torchrun``).
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

from wseg_tpu_torch.data.multiscale import (
    MultiscaleViews,
    _round_up,
    merge_multiscale,
)
from wseg_tpu_torch.engine.infer import (
    _device_merge_bucket,
    finalize_device_merge,
    make_infer_fn,
    make_infer_merge_fn,
)
from wseg_tpu_torch.ops.view_gen import build_views_u8

# Peak device bytes of one fast-CRF postprocess slot over the bytes of
# its float32 (H, W, C) merged map: 12.02 at one slot and 11.98 at 8 on
# the multicrop 640x640 canvas, measured on an NVIDIA H100 80GB HBM3
# (700 W) by chip_smoke.py's phase_multicrop_serve, which fails if a run
# exceeds this budget (the measurement and ~15% headroom)
PP_BYTES_PER_CANVAS_BYTE = 14.0
# share of the device's free memory (and the allocator's unused cache)
# that one postprocess chunk may take
PP_MEMORY_SHARE = 0.5
# the budget where the postprocess runs on the CPU
CPU_PP_BUDGET = 8 << 30
# groups waiting on the finisher (each holds its device tensors)
FINISH_DEPTH = 2



class MultiScaleServer:
    def __init__(self, model, test_cfg, max_batch: int = 4,
                 max_wait_ms: float = 5.0, postprocess=None):
        self.model = model
        self.cfg = test_cfg
        self.device = next(model.parameters()).device
        self.uint8 = bool(test_cfg.UINT8_TRANSFER)
        if postprocess is not None and not self.uint8:
            raise ValueError("a device postprocess needs "
                             "TEST.UINT8_TRANSFER (its CRF reads the raw "
                             "uint8 scale-1.0 view)")
        self.postprocess = postprocess
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self._init_paths(model, test_cfg)
        self._crf_pool = None
        if getattr(postprocess, "exact", None) is not None:
            # two threads: one image's host lattice build (the C++ call
            # releases the GIL) overlaps another's device mean field
            self._crf_pool = ThreadPoolExecutor(2)
            self._crf_slots = threading.BoundedSemaphore(4)
        self._finisher = ThreadPoolExecutor(1)
        self._finish_slots = threading.BoundedSemaphore(FINISH_DEPTH)
        self._q: "queue.Queue" = queue.Queue()
        self._stash = deque()  # different-signature arrivals, oldest first
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _init_paths(self, model, test_cfg):
        """The views and the device functions of the multi-scale paths."""
        scales = [float(s) for s in test_cfg.SCALES]
        self.views = MultiscaleViews(
            scales, bool(test_cfg.FLIP), test_cfg.PAD_SIZE,
            bool(test_cfg.PAD_PER_SCALE), int(test_cfg.PAD_ALIGN),
            transfer="uint8" if self.uint8 else "float32")
        self.infer = make_infer_fn(model, device_norm=self.uint8)
        # postprocess cls rows per slot on the device-view path
        self._cls_vpi = 2 if self.views.flip else 1
        self.device_views = (self.uint8 and bool(test_cfg.DEVICE_VIEWS)
                             and bool(scales) and scales[0] == 1.0)
        if self.device_views:
            self.infer_mv = make_infer_merge_fn(model)
            ph, pw = (int(p) for p in test_cfg.PAD_SIZE)
            ms = max(scales)
            self.canvas_hw = (_round_up(int(ph / ms), 64),
                              _round_up(int(pw / ms), 64))

    # ------------------------------------------------------------- API
    def warmup(self, image_sizes: List[Tuple[int, int]]):
        """Run one synthetic group per (width, height) signature on the
        caller's thread, so first-use costs (kernel build, library
        handles, allocator growth) stay out of served requests."""
        seen = set()
        nc1 = int(self.cfg.NUM_CLASSES) - 1
        for (w, h) in image_sizes:
            image = np.zeros((h, w, 3), np.uint8)
            sig = (self._group_sig(image), self._fits(image))
            if sig in seen:
                continue
            seen.add(sig)
            fut: Future = Future()
            self._process([(image, np.zeros(nc1, np.float32), fut)])
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
        self._finisher.shutdown(wait=True)
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
        self._fail(orphans, RuntimeError(
            "MultiScaleServer closed before this image was processed"))

    # ---------------------------------------------------------- worker
    def _group_sig(self, image_u8):
        h, w = image_u8.shape[:2]
        return tuple(self.views.view_shapes(w, h))

    def _fits(self, image_u8) -> bool:
        """Whether the image takes the device-view path."""
        if not self.device_views:
            return False
        h, w = image_u8.shape[:2]
        return h <= self.canvas_hw[0] and w <= self.canvas_hw[1]

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
                self._fail(group, e)

    @staticmethod
    def _fail(group, exc):
        for _, _, fut in group:
            if not fut.done():
                fut.set_exception(exc)

    def _process(self, group):
        """Images that fit the device canvas take the device-view path,
        the rest of the group the host-view path; each half resolves its
        own futures if it fails."""
        fit = [g for g in group if self._fits(g[0])]
        over = [g for g in group if not self._fits(g[0])]
        for run, part in ((self._process_device, fit),
                          (self._process_host, over)):
            if part:
                try:
                    run(part)
                except Exception as e:
                    self._fail(part, e)

    def _submit_finish(self, group, finish):
        """Run ``finish`` (fetch + resolve) on the finisher thread; a
        failure there still resolves the group's futures."""
        self._finish_slots.acquire()  # backpressure on the worker

        def guarded():
            try:
                with torch.inference_mode():
                    finish()
            except Exception as e:
                self._fail(group, e)
            finally:
                self._finish_slots.release()

        self._finisher.submit(guarded)

    def _labels(self, cls_views, gt_labels):
        if bool(self.cfg.USE_GT_LABELS) and gt_labels is not None:
            return np.asarray(gt_labels, np.float32)
        sig = 1.0 / (1.0 + np.exp(-np.stack(cls_views)))
        return (sig.max(axis=0) >
                float(self.cfg.FP_CUT_SCORE)).astype(np.float32)

    def _use_gt(self, group) -> bool:
        return (bool(self.cfg.USE_GT_LABELS)
                and all(g[1] is not None for g in group))

    # ---------------------------------------------------- device views
    @torch.inference_mode()
    def _process_device(self, group):
        """One group on the device-view path: upload, per-scale fused
        forward + merge, then the writer math (or the host tail)."""
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

        windows = dstwin[:n]
        if self.postprocess is not None:
            self._postprocess_rows(group, windows, sizes, total, u8,
                                   cls_list)
            return

        def finish():
            sums = total[:n].cpu().numpy()
            cls_np = [c.float().cpu().numpy() for c in cls_list]
            for gi, (_, gt_labels, fut) in enumerate(group):
                labels = self._labels(
                    [c[gi * vpi + f] for c in cls_np for f in range(vpi)],
                    gt_labels)
                fut.set_result((finalize_device_merge(
                    sums[gi], windows[gi], sizes[gi], labels,
                    self.views.num_views, float(self.cfg.BG_POW)), labels))

        self._submit_finish(group, finish)

    # ------------------------------------------------------ host views
    @torch.inference_mode()
    def _process_host(self, group):
        """Host-view path: PIL views per image, one forward per bucket
        shape over the group's views of that shape, then a device merge
        per image (with a postprocess or ``DEVICE_MERGE``) or the host
        merge."""
        per_image = []  # (views, pads, flips, size_hw)
        with record_function("serve.host_views"):
            for image, _, _ in group:
                views, pads, flips = self.views.build(image)
                per_image.append((views, pads, flips, image.shape[:2]))
        buckets = {}
        for gi, (views, _, _, _) in enumerate(per_image):
            for vi, v in enumerate(views):
                buckets.setdefault(v.shape[:2], []).append((gi, vi))
        pending = []
        for idxs in buckets.values():
            batch = np.stack([per_image[gi][0][vi] for gi, vi in idxs])
            wins = [per_image[gi][1][vi] for gi, vi in idxs]
            cls, masks = (self.infer(batch, wins) if self.uint8
                          else self.infer(batch))
            pending.append((idxs, cls, masks))

        if self.postprocess is not None or bool(self.cfg.DEVICE_MERGE):
            self._finish_device_merge(group, per_image, pending)
            return

        def finish():
            n = len(group)
            cls_out = [[None] * len(pi[0]) for pi in per_image]
            mask_out = [[None] * len(pi[0]) for pi in per_image]
            for idxs, cls, masks in pending:
                cls, masks = cls.float().cpu().numpy(), masks.float().cpu(
                    ).numpy()
                for k, (gi, vi) in enumerate(idxs):
                    cls_out[gi][vi], mask_out[gi][vi] = cls[k], masks[k]
            for gi in range(n):
                _, pads, flips, size_hw = per_image[gi]
                labels = self._labels(cls_out[gi], group[gi][1])
                group[gi][2].set_result((merge_multiscale(
                    mask_out[gi], pads, flips, labels, size_hw,
                    float(self.cfg.BG_POW)), labels))

        self._submit_finish(group, finish)

    def _finish_device_merge(self, group, per_image, pending):
        """Merge each image's views on the device (the views of one image
        in a bucket are a contiguous run of its rows), then the writer
        math per merge-canvas shape, or fetch only the merged maps."""
        n = len(group)
        sums, cls_rows = [None] * n, [[None] * len(pi[0]) for pi in
                                      per_image]
        merge_hw = [tuple(self.views.view_shapes(w, h)[0])
                    for (h, w) in (pi[3] for pi in per_image)]
        with record_function("serve.merge"):
            for idxs, cls, masks in pending:
                k = 0
                while k < len(idxs):
                    gi = idxs[k][0]
                    k1 = k
                    while k1 < len(idxs) and idxs[k1][0] == gi:
                        cls_rows[gi][idxs[k1][1]] = cls[k1]
                        k1 += 1
                    vis = [vi for _, vi in idxs[k:k1]]
                    _, pads, flips, _ = per_image[gi]
                    m = _device_merge_bucket(
                        masks[k:k1].float(), [pads[vi] for vi in vis],
                        pads[0], [flips[vi] for vi in vis], merge_hw[gi])
                    sums[gi] = m if sums[gi] is None else sums[gi] + m
                    k = k1

        if self.postprocess is not None:
            subgroups = {}
            for gi in range(n):
                subgroups.setdefault(merge_hw[gi], []).append(gi)
            for gis in subgroups.values():
                sub = [group[gi] for gi in gis]
                total = torch.stack([sums[gi] for gi in gis])
                u8 = torch.from_numpy(np.stack(
                    [per_image[gi][0][0] for gi in gis])).to(self.device)
                windows = np.asarray([per_image[gi][1][0] for gi in gis],
                                     np.int32)
                # every view's cls row of each image, image-major: the
                # labels come from all of an image's views
                cls_all = [torch.stack([c for gi in gis
                                        for c in cls_rows[gi]])]
                self._postprocess_rows(sub, windows,
                                       [per_image[gi][3] for gi in gis],
                                       total, u8, cls_all,
                                       cls_vpi=len(cls_rows[gis[0]]))
            return

        def finish():
            for gi, (_, gt_labels, fut) in enumerate(group):
                _, pads, _, size_hw = per_image[gi]
                labels = self._labels(
                    [c.float().cpu().numpy() for c in cls_rows[gi]],
                    gt_labels)
                fut.set_result((finalize_device_merge(
                    sums[gi].cpu().numpy(), pads[0], size_hw, labels,
                    self.views.num_views, float(self.cfg.BG_POW)), labels))

        self._submit_finish(group, finish)

    # ------------------------------------------------------ writer math
    def _pp_budget(self) -> float:
        """Bytes one postprocess chunk may take: on a card
        ``PP_MEMORY_SHARE`` of its free memory and of the allocator's
        unused cache, on the CPU ``CPU_PP_BUDGET``."""
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            cached = (torch.cuda.memory_reserved(self.device)
                      - torch.cuda.memory_allocated(self.device))
            return PP_MEMORY_SHARE * (free + cached)
        return float(CPU_PP_BUDGET)

    def _pp_slot_cap(self, mh: int, mw: int, nc: int) -> int:
        """Most postprocess slots per dispatch at this merge canvas."""
        per_slot = mh * mw * nc * 4 * PP_BYTES_PER_CANVAS_BYTE
        return max(1, int(self._pp_budget() // per_slot))

    def _postprocess_rows(self, group, windows, sizes, total, u8, cls_list,
                          cls_vpi: Optional[int] = None):
        """Writer math for ``group``, whose merged sums are the first
        len(group) rows of ``total`` (S, H, W, C) and whose CRF pixels
        those of ``u8``: launched here in chunks of at most the slot cap
        (live rows only), fetched and resolved on the finisher.  GT
        labels ride as a host array; otherwise they are computed on the
        device from ``cls_list`` (per-scale (S * vpi, C-1) logits,
        image-major; ``cls_vpi`` rows a slot)."""
        pp = self.postprocess
        exact = pp.exact is not None
        vpi = self._cls_vpi if cls_vpi is None else cls_vpi
        n = len(group)
        mh, mw, nc = (int(v) for v in total.shape[1:])
        use_gt = self._use_gt(group)
        if use_gt:
            labels = np.stack([np.asarray(g[1], np.float32) for g in group])
        cs = self._pp_slot_cap(mh, mw, nc)
        pending = []
        for sl in (slice(st, min(n, st + cs)) for st in range(0, n, cs)):
            if use_gt:
                out = pp.dispatch_group(total[sl], labels[sl], windows[sl],
                                        u8[sl], self.views.num_views)
                preds, merged = out if exact else (out, None)
                lab = labels[sl]
            else:
                cls = [c[sl.start * vpi:sl.stop * vpi] for c in cls_list]
                out = pp.dispatch_group_cls(
                    total[sl], cls, windows[sl], u8[sl],
                    self.views.num_views, float(self.cfg.FP_CUT_SCORE))
                preds, lab, merged = out if exact else (*out, None)
            jobs = (self._exact_jobs(group[sl], windows[sl], merged)
                    if exact else [None] * (sl.stop - sl.start))
            pending.append((sl, preds, lab, jobs))

        def finish():
            for sl, preds, lab, jobs in pending:
                preds = preds.cpu().numpy()
                if isinstance(lab, torch.Tensor):
                    lab = lab.cpu().numpy()
                for k, gi in enumerate(range(sl.start, sl.stop)):
                    self._resolve(group[gi][2], windows[gi], sizes[gi],
                                  preds[k], lab[k], jobs[k])

        self._submit_finish(group, finish)

    def _exact_jobs(self, group, windows, merged):
        """One exact-CRF job per image on the CRF pool: host lattice build
        from the original pixels, then the mean field on the device over
        the image's merged map (row k of ``merged`` for the k-th image).
        Returns the jobs' futures, each -> (n_crf, Hc, Wc) uint8 numpy."""
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
        for k, (image, _, _) in enumerate(group):
            self._crf_slots.acquire()  # backpressure on the worker
            jobs.append(self._crf_pool.submit(job, image,
                                              tuple(windows[k]), k))
        return jobs

    def _resolve(self, fut, window, size_hw, preds, labels, crf_job):
        """Resolve one image's future: now, or when its exact-CRF job
        ends (on the pool thread that ran it)."""
        pp = self.postprocess
        if crf_job is None:
            fut.set_result((pp.finalize(preds, tuple(window), size_hw),
                            labels))
            return

        def done(job):
            try:
                res = pp.finalize(preds, tuple(window), size_hw,
                                  job.result())
            except Exception as e:
                fut.set_exception(e)
            else:
                fut.set_result((res, labels))

        crf_job.add_done_callback(done)
