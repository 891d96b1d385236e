#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

from the repository root.  Phases, each printing its own lines:

1. environment: torch/CUDA versions and the card (fails without CUDA);
2. build: compiles every hand-written kernel from ``wseg_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. kernel vs plain: the bilateral-message kernel against its plain
   PyTorch version at the flagship shapes, error and median times;
4. serving slice: WRN38 + CAM_CASA_WGAP_tf at full width (bfloat16,
   seeded random weights) serves 8 VOC-sized synthetic images through
   ``MultiScaleServer`` with the fast-CRF device postprocess; checks
   the label maps, the kernel's launch count, finite scores, and the
   writer math on the card against the same math on the CPU;
5. PAMR kernels vs plain: the affinity and propagation kernels against
   their plain versions at the flagship shapes (guide (8, 48, 48, 3),
   mask (8, 48, 48, 21), dilations 1-24, 10 steps), errors and times;
6. train slice: the flagship trainer's model on the card (float32
   parameters, bfloat16 compute, crop 384, batch 8, mask loss on), 2
   warm-up and 6 timed SGD steps on seeded synthetic batches; checks
   finite losses, trained parameters moved and frozen ones bit-equal,
   one affinity and one propagation launch per step; then one more step
   whose labels agree with the pseudo-GT of a sharpened head (see
   ``sharpen_head_and_label``), where the mask loss must be non-zero;
   and the refined masks of the kernel path against the plain path on
   the same card;
7. entry point: ``python -m wseg_tpu_torch.train`` (``main``) trains one
   short epoch + validation on a synthetic VOC directory and writes a
   checkpoint, which ``wseg_tpu_torch.infer_val`` loads and serves;
8. the card line, the kernel JSON line, and last ``{"ok": true, ...}``.

Any failed check raises, so the script exits non-zero and prints no
``ok`` line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# (width, height) of the served images: VOC's common sizes, two each
VOC_SIZES = [(500, 375), (375, 500), (500, 333), (333, 500)] * 2
# flagship bilateral-message shapes: 8 slots, 21 classes, the 192x256
# half grid of a 384x512 merge canvas
KERNEL_SHAPE = (8, 21, 192, 256)
KERNEL_REL_TOL = 1e-5
# flagship PAMR shapes: batch 8, the 384 crop at stride 8, 21 classes
PAMR_SHAPE = (8, 48, 48, 21)
PAMR_DIL = (1, 2, 4, 8, 12, 24)
PAMR_ITER = 10
PAMR_REL_TOL = 1e-5
WARMUP_STEPS, TIMED_STEPS = 2, 6
# the class that the mask-loss step's sharpened head gives its images
MASK_CLASS = 1
# the card's published peaks (H100 SXM data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time for ``nbytes`` of compulsory traffic and ``flops``
    float32 operations on the card, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def valid_tap_pixels(taps, h: int, w: int) -> int:
    """(tap, pixel) pairs whose displaced pixel lies inside an h x w image."""
    return sum(max(0, h - abs(dy)) * max(0, w - abs(dx)) for dy, dx in taps)


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
             for m in ("yaml", "PIL", "cv2", "triton", "sklearn")}
    print(f"optional modules: {avail}", flush=True)
    return smi


def phase_build(card: str) -> None:
    from wseg_tpu_torch import _build
    from wseg_tpu_torch.ops import crf_bilateral, pamr_cuda

    names = ("crf_bilateral", "pamr")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    crf_bilateral._library()
    pamr_cuda._library()
    dt = time.perf_counter() - t0
    print(f"build {', '.join(n + '.cu' for n in names)} in parallel: "
          f"{dt:.2f} s ({card})", flush=True)
    for name in names:
        for line in _build.build.log.get(name, "").splitlines():
            print(f"  nvcc {name}: {line}", flush=True)


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
    nbytes = 2 * q.numel() * 4 + wt.numel() * 2
    flops = 2 * b * c * valid_tap_pixels(taps, h, w)
    return {"name": "bilateral_message_cm", "route": "cuda",
            "source": "wseg_tpu_torch/csrc/crf_bilateral.cu",
            "replaces": "wseg_tpu/ops/crf_pallas.py:87",
            "max_abs_err": max_abs, "ms": min(ms, ms2),
            "plain_ms": min(plain_ms, plain_ms2), **bound(nbytes, flops),
            "library_ms": None}


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


def phase_pamr_kernels(card: str) -> list:
    """Both PAMR kernels against their plain versions at the flagship
    shapes: (affinity entry, propagation entry) without launches."""
    import torch

    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_affinity_cm_reference,
        pamr_propagate_cm,
        pamr_propagate_cm_reference,
        pamr_taps,
    )

    b, h, w, c = PAMR_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    guide = torch.rand((b, h, w, 3), generator=gen, device="cuda")
    mask = torch.softmax(torch.randn((b, h, w, c), generator=gen,
                                     device="cuda") * 3, dim=-1)
    im_cm = guide.permute(0, 3, 1, 2).contiguous()
    m_cm = mask.permute(0, 3, 1, 2).contiguous()
    aff = pamr_affinity_cm(im_cm, PAMR_DIL)
    aff_ref = pamr_affinity_cm_reference(im_cm, PAMR_DIL)
    out = pamr_propagate_cm(aff_ref, m_cm, PAMR_DIL, PAMR_ITER)
    out_ref = pamr_propagate_cm_reference(aff_ref, m_cm, PAMR_DIL,
                                          PAMR_ITER)
    torch.cuda.synchronize()
    t = len(PAMR_DIL) * 8
    taps9 = [tap for d in PAMR_DIL for tap in pamr_taps((d,)) + [(0, 0)]]
    # affinity: per pixel and channel 4 ops per sigma tap (mean, then
    # deviation squared and summed) + 4 per logit tap; 3 per softmax tap
    aff_flops = b * h * w * (3 * 4 * len(taps9) + 3 * 4 * t + 3 * t)
    entries = []
    for name, src, got, want, plain, kernel, nbytes, flops in (
            ("pamr_affinity_cm", "wseg_tpu/ops/pamr_pallas.py:203", aff,
             aff_ref, lambda: pamr_affinity_cm_reference(im_cm, PAMR_DIL),
             lambda: pamr_affinity_cm(im_cm, PAMR_DIL),
             (im_cm.numel() + aff.numel()) * 4, aff_flops),
            ("pamr_propagate_cm", "wseg_tpu/ops/pamr_pallas.py:117", out,
             out_ref,
             lambda: pamr_propagate_cm_reference(aff_ref, m_cm, PAMR_DIL,
                                                 PAMR_ITER),
             lambda: pamr_propagate_cm(aff_ref, m_cm, PAMR_DIL, PAMR_ITER),
             (aff_ref.numel() + 2 * m_cm.numel()) * 4,
             # edge replication: every tap reads a pixel, none is skipped
             2 * b * c * PAMR_ITER * t * h * w)):
        max_abs = float((got - want).abs().max())
        rel = max_abs / float(want.abs().max())
        print(f"kernel {name} at {PAMR_SHAPE}, dilations {PAMR_DIL}, "
              f"{PAMR_ITER} steps: max_abs_err {max_abs:.3e}, rel "
              f"{rel:.3e} (tol {PAMR_REL_TOL:g})", flush=True)
        check(rel <= PAMR_REL_TOL, f"{name} disagrees with plain: rel {rel}")
        p1 = cuda_median_ms(plain, reps=10)
        k1 = cuda_median_ms(kernel, reps=30)
        k2 = cuda_median_ms(kernel, reps=30)
        p2 = cuda_median_ms(plain, reps=10)
        bnd = bound(nbytes, flops)
        print(f"kernel {name} median {k1:.4f} / {k2:.4f} ms, plain median "
              f"{p1:.4f} / {p2:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}) ({card})", flush=True)
        entries.append({"name": name, "route": "cuda",
                        "source": "wseg_tpu_torch/csrc/pamr.cu",
                        "replaces": src, "max_abs_err": max_abs,
                        "ms": min(k1, k2), "plain_ms": min(p1, p2), **bnd,
                        "library_ms": None})
    return entries


def sharpen_head_and_label(model, batch, cls: int = MASK_CLASS):
    """Give ``batch`` labels under which the mask loss counts; returns
    (labels (B, 20), images that count).

    The seeded head's masks are nearly uniform, so no class reaches
    ``pseudo_gtmask``'s floor of 0.2 and the mask loss is 0.  Here fc8
    keeps two columns, the background and ``cls``, along + and - the top
    principal direction of its input features (taken orthogonal to their
    mean, so that its sign splits the pixels), scaled to logits of up to
    20: masks as peaked as a trained head's.  Each image is then labelled
    with the classes of the pseudo-GT of its refined masks.  PAMR is
    linear in each channel and cleaning only zeroes channels, so these
    labels leave that pseudo-GT as it was: an image whose pseudo-GT holds
    the background and ``cls`` counts in the loss.  The dropout draws of
    the probes are the step's own (the generator is rewound)."""
    import torch

    from wseg_tpu_torch.engine.train_loop import normalise_batch_image
    from wseg_tpu_torch.models.backbones.common import Dropout2d
    from wseg_tpu_torch.ops.pseudo_mask import pseudo_gtmask

    gen = next(m.generator for m in model.modules()
               if isinstance(m, Dropout2d))
    state = gen.get_state()
    feats = {}
    hook = model.fc8.register_forward_hook(
        lambda mod, inp, out: feats.update(x=inp[0]))
    with torch.no_grad():
        image, raw = normalise_batch_image(batch["image"], batch["jitter"])
        ones = torch.ones_like(batch["labels"])
        try:
            model(image, raw, ones)
        finally:
            hook.remove()
        x = feats["x"][0].float().flatten(1).T          # image 0's pixels
        mean = x.mean(dim=0)
        centred = x - mean
        u = torch.linalg.eigh(centred.T @ centred).eigenvectors[:, -1]
        v = u - (u @ mean) * mean / (mean @ mean)
        v = v * (20.0 / float(torch.quantile((x @ v).abs(), 0.9)))
        w = torch.zeros_like(model.fc8.weight)
        w[0, :, 0, 0] = v
        w[cls, :, 0, 0] = -v
        model.fc8.weight.copy_(w)
        gen.set_state(state)
        out = model(image, raw, ones)
        gen.set_state(state)
        present = pseudo_gtmask(out.masks_dec).amax(dim=(1, 2)) > 0
    fg = present[:, 1:]
    has_fg = fg.any(dim=-1, keepdim=True)
    labels = torch.where(has_fg, fg.float(), batch["labels"])
    return labels, int((present[:, 0] & has_fg[:, 0]).sum())


def phase_train(card: str) -> dict:
    """Full-width train steps; returns the PAMR launch counts."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.engine.train_loop import (
        normalise_batch_image,
        train_step,
    )
    from wseg_tpu_torch.engine.trainer import build_train_model
    from wseg_tpu_torch.flagship import (
        load_flagship_cfg,
        synthetic_train_batch,
    )
    from wseg_tpu_torch.models.stage_net import _clean_only
    from wseg_tpu_torch.ops.pamr import pamr, pamr_reference
    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_propagate_cm,
    )
    from wseg_tpu_torch.optim import FROZEN, make_optimizer

    reset_cfg()
    src = load_flagship_cfg()
    crop, bs = int(cfg.DATASET.CROP_SIZE), int(cfg.TRAIN.BATCH_SIZE)
    check(crop == 384 and bs == 8 and cfg.NET.DTYPE == "bfloat16"
          and bool(cfg.DATASET.DEVICE_JITTER),
          f"not the flagship train config: crop {crop}, batch {bs}, "
          f"{cfg.NET.DTYPE}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    model = build_train_model(dev, seed=0)
    opt, labels = make_optimizer(cfg.NET, model)
    params = dict(model.named_parameters())
    check(all(p.dtype == torch.float32 for p in params.values()),
          "training parameters must be float32")
    init = {n: p.detach().clone() for n, p in params.items()}
    print(f"train model ({src}): {sum(p.numel() for p in params.values())} "
          f"float32 params, autocast {model.amp_dtype}, crop {crop}, batch "
          f"{bs}, PAMR {model.pamr_kernel} x {model.pamr_iter}, built in "
          f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)

    rng = np.random.RandomState(0)
    batches = [synthetic_train_batch(rng, bs, crop) for _ in range(
        WARMUP_STEPS + TIMED_STEPS)]
    kw = dict(device_jitter=True, loss_name=str(cfg.NET.LOSS),
              mask_loss_bce=float(cfg.NET.MASK_LOSS_BCE))
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pamr_affinity_cm.launches = 0
    pamr_propagate_cm.launches = 0
    for i, batch in enumerate(batches):
        before = (pamr_affinity_cm.launches, pamr_propagate_cm.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(model, opt, batch, 1.0, **kw)
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append((time.perf_counter() - t) * 1e3)
        delta = (pamr_affinity_cm.launches - before[0],
                 pamr_propagate_cm.launches - before[1])
        check(delta == (1, 1), f"step {i}: PAMR launches {delta}, "
              "expected one affinity and one propagation")
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = {"pamr_affinity_cm": pamr_affinity_cm.launches,
                "pamr_propagate_cm": pamr_propagate_cm.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(v) for m in losses for v in m.values()),
          f"non-finite losses: {losses}")
    times.sort()
    med = times[len(times) // 2]
    print(f"train steps (after {WARMUP_STEPS} warm-up): median {med:.2f} "
          f"ms, min {times[0]:.2f} ms, max {times[-1]:.2f} ms over "
          f"{TIMED_STEPS} = {bs * 1e3 / med:.2f} images/s; peak memory "
          f"{peak:.2f} GiB; PAMR launches {launches} ({card})", flush=True)
    print(f"losses, first and last step: {losses[0]} / {losses[-1]}",
          flush=True)

    moved = frozen_same = n_train = n_frozen = 0
    for n, p in params.items():
        same = torch.equal(p.detach(), init[n])
        if labels[n] == FROZEN:
            n_frozen += 1
            frozen_same += same
        else:
            n_train += 1
            moved += not same
    print(f"parameters: {moved} of {n_train} trained tensors moved, "
          f"{frozen_same} of {n_frozen} frozen tensors bit-equal", flush=True)
    check(frozen_same == n_frozen, "a frozen parameter changed")
    check(moved == n_train, "a trained parameter did not move")

    # the refined masks of one step's inputs: kernel path vs plain path
    model.eval()
    batch = batches[-1]
    with torch.no_grad():
        image, raw = normalise_batch_image(batch["image"], batch["jitter"])
        with torch.autocast("cuda", dtype=model.amp_dtype):
            logits, _ = model._features(image)
        src_masks = _clean_only(torch.softmax(logits.float(), dim=-1),
                                batch["labels"])
        dec_k = pamr(raw, src_masks, model.pamr_kernel, model.pamr_iter)
        dec_p = pamr_reference(raw, src_masks, model.pamr_kernel,
                               model.pamr_iter)
    err = float((dec_k - dec_p).abs().max())
    print(f"masks_dec (B, 48, 48, 21) kernel path vs plain path on the card: "
          f"max_abs_err {err:.3e} (tol 1e-5)", flush=True)
    check(err <= 1e-5, f"masks_dec kernel vs plain: {err}")
    model.train()

    batch = synthetic_train_batch(rng, bs, crop)
    batch["labels"], n_counted = sharpen_head_and_label(model, batch)
    before = (pamr_affinity_cm.launches, pamr_propagate_cm.launches)
    metrics = {k: float(v) for k, v in
               train_step(model, opt, batch, 1.0, **kw).items()}
    delta = (pamr_affinity_cm.launches - before[0],
             pamr_propagate_cm.launches - before[1])
    print(f"mask-loss step: {n_counted} of {bs} images hold background + "
          f"their labels in the pseudo-GT; losses {metrics}", flush=True)
    check(delta == (1, 1), f"mask-loss step: PAMR launches {delta}")
    check(n_counted > 0 and metrics["loss_mask"] > 0
          and all(np.isfinite(v) for v in metrics.values()),
          f"the refined masks did not reach the loss: {metrics}")
    del model, opt, params, init, batches
    torch.cuda.empty_cache()
    return launches


def phase_entry(card: str) -> None:
    """``wseg_tpu_torch.train.main`` for one short epoch + validation on
    a synthetic VOC, then ``infer_val`` on its checkpoint."""
    import torch

    from wseg_tpu_torch import infer_val, train
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.flagship import FLAGSHIP_CFG, write_synthetic_voc
    from wseg_tpu_torch.utils.checkpoints import model_file

    tmp = tempfile.mkdtemp(prefix="wseg_smoke_")
    try:
        root = write_synthetic_voc(os.path.join(tmp, "data"), n_train=16,
                                   n_val=4)
        common = ["--dataset", "pascal_voc", "--cfg", FLAGSHIP_CFG,
                  "--exp", "smoke", "--run", "r0",
                  "--snapshot-dir", os.path.join(tmp, "snap"),
                  "--logdir", os.path.join(tmp, "logs"), "--workers", "2",
                  "--device", "cuda"]
        sets = ["--set", "DATASET.ROOT", root, "TEST.DATA_ROOT", root,
                "TRAIN.NUM_EPOCHS", "0", "TRAIN.PRETRAIN", "0"]
        reset_cfg()
        t0 = time.perf_counter()
        trainer = train.main(common + sets)
        dt = time.perf_counter() - t0
        check(trainer.checkpoint.checkpoints, "the trainer saved nothing")
        suffix = trainer.checkpoint.checkpoints[-1]
        snap = trainer.args.snapshot_dir
        check(os.path.isfile(model_file(snap, suffix)),
              f"no checkpoint file for {suffix}")
        print(f"entry point: train.main, 1 epoch of 16 + validation of 4 "
              f"synthetic 500x375 images in {dt:.2f} s, checkpoint "
              f"{suffix} ({card})", flush=True)
        del trainer
        torch.cuda.empty_cache()

        reset_cfg()
        check(infer_val._find_snapshot(suffix, snap) == model_file(snap,
                                                                   suffix),
              "infer_val does not find the trainer's checkpoint")
        out = os.path.join(tmp, "masks")
        t0 = time.perf_counter()
        infer_val.main(common + ["--resume", suffix, "--infer-list",
                                 os.path.join(root, "val_voc.txt"),
                                 "--mask-output-dir", out] + sets)
        dt = time.perf_counter() - t0
        n = {sub: len(os.listdir(os.path.join(out + "_0", sub)))
             for sub in ("no_crf", "crf")}
        check(n == {"no_crf": 4, "crf": 4}, f"infer_val wrote {n}")
        print(f"entry point: infer_val loaded {suffix} and wrote {n} PNGs "
              f"at threshold 0.0 in {dt:.2f} s ({card})", flush=True)
    finally:
        reset_cfg()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    card = phase_env()
    phase_build(card)
    kern = phase_kernel(card)
    kern["launches"] = phase_slice(card)
    check(kern["launches"] > 0, "the slice never launched the kernel")
    pamr_kernels = phase_pamr_kernels(card)
    launches = phase_train(card)
    for entry in pamr_kernels:
        entry["launches"] = launches[entry["name"]]
        check(entry["launches"] > 0, f"the train slice never launched "
              f"{entry['name']}")
    phase_entry(card)
    import torch

    print(card, flush=True)
    print(json.dumps({"kernels": [kern] + pamr_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
