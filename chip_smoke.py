#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

from the repository root.  Phases, each printing its own lines:

1. environment: torch/CUDA versions and the card (fails without CUDA);
2. build: compiles every hand-written kernel from ``wseg_tpu_torch/csrc``;
3. kernel vs plain: the bilateral-message kernel against its plain
   PyTorch version at the flagship shapes, error and median times;
4. slice: WRN38 + CAM_CASA_WGAP_tf at full width (bfloat16, seeded
   random weights) serves 8 VOC-sized synthetic images through
   ``MultiScaleServer`` with the fast-CRF device postprocess; checks
   the label maps, the kernel's launch count, finite scores, and the
   writer math on the card against the same math on the CPU;
5. the card line, the kernel JSON line, and last ``{"ok": true, ...}``.

Any failed check raises, so the script exits non-zero and prints no
``ok`` line.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time

# (width, height) of the served images: VOC's common sizes, two each
VOC_SIZES = [(500, 375), (375, 500), (500, 333), (333, 500)] * 2
# flagship bilateral-message shapes: 8 slots, 21 classes, the 192x256
# half grid of a 384x512 merge canvas
KERNEL_SHAPE = (8, 21, 192, 256)
KERNEL_REL_TOL = 1e-5


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_env() -> str:
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device 0: {torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}", flush=True)
    avail = {m: importlib.util.find_spec(m) is not None
             for m in ("yaml", "PIL", "cv2", "triton")}
    print(f"optional modules: {avail}", flush=True)
    return smi


def phase_build(card: str) -> None:
    from wseg_tpu_torch import _build
    from wseg_tpu_torch.ops import crf_bilateral

    t0 = time.perf_counter()
    crf_bilateral._library()
    dt = time.perf_counter() - t0
    print(f"build crf_bilateral.cu: {dt:.2f} s ({card})", flush=True)
    for line in _build.build.log.get("crf_bilateral", "").splitlines():
        print(f"  nvcc: {line}", flush=True)


def phase_kernel(card: str) -> dict:
    import torch

    from wseg_tpu_torch.ops.crf import _bilateral_taps
    from wseg_tpu_torch.ops.crf_bilateral import (
        bilateral_message_cm,
        bilateral_message_cm_reference,
    )

    taps = [(-dy, -dx) for dy, dx in _bilateral_taps(40.0, 2.0)]
    b, c, h, w = KERNEL_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.rand((b, c, h, w), generator=gen, device="cuda")
    wt = torch.rand((b, len(taps), h, w), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got = bilateral_message_cm(q, wt, taps)
    want = bilateral_message_cm_reference(q, wt, taps)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    print(f"kernel bilateral_message_cm at {KERNEL_SHAPE}, {len(taps)} "
          f"taps: max_abs_err {max_abs:.3e}, rel {rel:.3e} "
          f"(tol {KERNEL_REL_TOL:g})", flush=True)
    check(rel <= KERNEL_REL_TOL, f"kernel disagrees with plain: rel {rel}")
    plain_ms = cuda_median_ms(
        lambda: bilateral_message_cm_reference(q, wt, taps), reps=10)
    ms = cuda_median_ms(lambda: bilateral_message_cm(q, wt, taps), reps=30)
    plain_ms2 = cuda_median_ms(
        lambda: bilateral_message_cm_reference(q, wt, taps), reps=10)
    ms2 = cuda_median_ms(lambda: bilateral_message_cm(q, wt, taps), reps=30)
    print(f"kernel median {ms:.4f} / {ms2:.4f} ms, plain median "
          f"{plain_ms:.4f} / {plain_ms2:.4f} ms (two rounds; {card})",
          flush=True)
    return {"name": "bilateral_message_cm", "route": "cuda",
            "source": "wseg_tpu_torch/csrc/crf_bilateral.cu",
            "replaces": "wseg_tpu/ops/crf_pallas.py:87",
            "max_abs_err": max_abs, "ms": min(ms, ms2),
            "plain_ms": min(plain_ms, plain_ms2)}


def phase_slice(card: str) -> int:
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.infer import _postprocess
    from wseg_tpu_torch.flagship import (
        THRESHS,
        build_flagship_server,
        load_flagship_cfg,
        synthetic_images,
    )
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm

    src = load_flagship_cfg()
    print(f"config: {src}; NET.DTYPE {cfg.NET.DTYPE}, scales "
          f"{cfg.TEST.SCALES}, flip {cfg.TEST.FLIP}, CRF "
          f"{cfg.TEST.CRF_MODE}/{cfg.TEST.CRF_DTYPE} full_stride "
          f"{cfg.TEST.CRF_FULL_STRIDE} refine {cfg.TEST.CRF_REFINE_ITERS}",
          flush=True)
    t0 = time.perf_counter()
    server = build_flagship_server("cuda", seed=0)
    model, dev = server.model, server.device
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.NET.MODEL}/{cfg.NET.BACKBONE}: {n_params} params, "
          f"{next(model.parameters()).dtype}, built in "
          f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)

    pp = server.postprocess
    pp_calls = [0]
    dispatch_group = pp.dispatch_group

    def counted_dispatch(*args, **kw):
        pp_calls[0] += 1
        return dispatch_group(*args, **kw)

    pp.dispatch_group = counted_dispatch
    images = synthetic_images(VOC_SIZES)
    # one warm-up group per view-shape signature (the server groups by it)
    sigs = {tuple(server.views.view_shapes(w, h)): (w, h)
            for (w, h) in VOC_SIZES}
    try:
        bilateral_message_cm.launches = 0
        t0 = time.perf_counter()
        for size in sigs.values():
            before = bilateral_message_cm.launches
            server.warmup([size])
            delta = bilateral_message_cm.launches - before
            check(delta == 12, f"warm-up group {size}: {delta} bilateral "
                  "launches, expected 12")
        torch.cuda.synchronize()
        print(f"warm-up, one group per size signature: "
              f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
        t0 = time.perf_counter()
        futs = [server.submit(img, lab) for img, lab in images]
        results = [f.result(timeout=600) for f in futs]
        dt = time.perf_counter() - t0
        launches = bilateral_message_cm.launches
    finally:
        server.close()
    print(f"slice: {len(images)} images in {dt:.3f} s = "
          f"{len(images) / dt:.3f} images/s, {pp_calls[0]} postprocess "
          f"calls, {launches} bilateral launches ({card})", flush=True)
    check(pp_calls[0] >= 2 * len(sigs),
          f"{pp_calls[0]} postprocess calls for {len(sigs)} warm-up and "
          f">= {len(sigs)} served groups")
    check(launches == 12 * pp_calls[0],
          f"{launches} bilateral launches for {pp_calls[0]} postprocess "
          "calls, expected 12 each")

    for (img, lab), (res, got_lab) in zip(images, results):
        check(np.array_equal(got_lab, lab), "labels changed")
        for t in THRESHS:
            for key in ("pred", "pred_crf"):
                m = res[t][key]
                check(m.dtype == np.uint8 and m.shape == img.shape[:2],
                      f"{key}@{t}: {m.dtype} {m.shape} for {img.shape}")
                check(int(m.max()) <= 20, f"{key}@{t}: label {m.max()}")

    # scores of one image per size are finite, and the writer math
    # (incl. the kernel's CRF) on the card matches the same math on the
    # CPU (the plain bilateral version) for the first image
    infer_mv = server.infer_mv
    vpi = 2 if server.views.flip else 1
    for k, (img, lab) in enumerate(images[:4]):
        canvas, owin, pads, _ = server.views.build_device(img,
                                                          server.canvas_hw)
        h, w = img.shape[:2]
        shapes = server.views.view_shapes(w, h)
        orig = torch.from_numpy(canvas[None]).to(dev)
        ow = torch.tensor([owin], device=dev)
        dst = torch.tensor([pads[0]], device=dev)
        total, cls_all = 0, []
        for si, shp in enumerate(shapes):
            vw = torch.tensor([pads[vpi * si]], device=dev)
            cls, part = infer_mv(orig, ow, vw, dst, out_hw=tuple(shp),
                                 flip_pair=server.views.flip,
                                 merge_hw=tuple(shapes[0]))
            total = total + part
            cls_all.append(cls)
        check(bool(torch.isfinite(total).all()) and all(
            bool(torch.isfinite(c).all()) for c in cls_all),
            f"non-finite scores for image {k}")
        if k == 0:
            from wseg_tpu_torch.ops.view_gen import build_views_u8

            u8 = build_views_u8(orig, ow, dst, out_hw=tuple(shapes[0]),
                                flip_pair=False)
            kw = dict(pp._kw, n_views=server.views.num_views)
            labels = torch.from_numpy(lab[None]).to(dev)
            on_card = _postprocess(total, labels, dst, u8, **kw).cpu()
            on_cpu = _postprocess(total.cpu(), labels.cpu(), dst.cpu(),
                                  u8.cpu(), **kw)
            agree = (on_card == on_cpu).float().mean(dim=(0, 2, 3))
            print(f"writer math card vs CPU, image 0: label agreement per "
                  f"map {[round(float(a), 5) for a in agree]} "
                  f"(pred@0.0, pred@0.1, pred_crf@0.0, pred_crf@0.1)",
                  flush=True)
            check(bool((agree >= 0.99).all()),
                  f"card and CPU writer math disagree: {agree}")
    return launches


def main() -> int:
    card = phase_env()
    phase_build(card)
    kern = phase_kernel(card)
    kern["launches"] = phase_slice(card)
    check(kern["launches"] > 0, "the slice never launched the kernel")
    import torch

    print(card, flush=True)
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
