#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

from the repository root.  Phases, each printing its own lines:

1. environment: torch/CUDA versions and the card (fails without CUDA);
2. build: compiles every hand-written kernel from ``wseg_tpu_torch/csrc``
   (one nvcc per source, all started together); then the int8 kernels
   (``csrc/qconv.cu``: ``quantize_act`` and ``qconv_s8``) against their
   plain versions at every distinct conv of the flagship's int8 forward
   on one bucket (16 views of 384x512), a VGG16 ``fc6`` at dilation 12
   and a ResNet-50 stride-2 3x3: xq and sx equal, int32 sums and bf16
   outputs bit-equal (dynamic and static), each conv's host plan, the
   kernels' device times and call times summed over the bucket's convs
   beside their bounds and shares of them (the quantize's dynamic launch
   beside its static pass, which splits off the |x| max), ``F.unfold`` +
   ``torch._int_mm`` and the bf16 cuDNN convs;
3. kernels vs plain: the bilateral-message kernel (21 classes and the
   C = 1 norm filter) and the Gaussian-blur kernel (the four filter
   shapes of a postprocess call, each without and with the valid mask)
   against their plain PyTorch versions, errors, median call times, the
   profiler's kernel times, bounds and (blur) a cuDNN convolution of
   the unmasked input as the library yardstick;
4. serving slice: WRN38 + CAM_CASA_WGAP_tf at full width (bfloat16,
   seeded random weights) serves 8 VOC-sized synthetic images through
   ``MultiScaleServer`` with the fast-CRF device postprocess; checks
   the label maps, both CRF kernels' launch counts (12 each per
   postprocess call), finite scores, and the writer math on the card
   against the same math on the CPU; then the ResNet-50 SoftMaxAE
   (``ae``) model serves the same images under ``voc_resnet50.yaml``'s
   TEST settings (scales 1/0.75/1.25/1.5 + flip on the 768 canvas):
   label maps, finite scores, the CRF kernels' launch counts, images/s;
   then the zoo's classic-CAM ``bsl`` and two-window ``tf_v10``
   (ResNet-50, ``voc_resnet50.yaml``), multi-level ``CAM_MF`` and
   cross-query talking-heads ``tf_v9`` (WRN38, ``voc_resnet38.yaml``)
   the same way, each with the fast CRF on one image's merged map,
   kernels on the card against the plain versions on the CPU (float32,
   max |dQ|); then
   the flagship in int8 (``NET.DTYPE int8``), dynamic and static (the
   statistics from ``quant_calibrate``'s CLI on the same images and
   weights), each in turns with bf16: images/s, the int8 kernels'
   launches (none in bf16), and the label agreement with bf16;
5. PAMR kernels vs plain: the affinity and propagation kernels against
   their plain versions at the flagship shapes (guide (8, 48, 48, 3),
   mask (8, 48, 48, 21), dilations 1-24, 10 steps), the propagation
   at (8, 96, 96, 21) too, and both at the ``ae`` configs' odd plane
   (16, 81, 81, 21): errors, call times, the profiler's kernel
   times and bounds, both kernels' host plans and ptxas lines, and each
   one's host time a call (wrapper, C entry, ctypes);
   then the three lab variants (fold, dxfirst, mxu) against theirs at
   the same shapes, and the lab ``wseg_tpu_torch.bench_pamr`` at
   (8, 96, 96, 21), whose run gives the variants' launch counts;
6. train slice: the flagship trainer's model on the card (float32
   parameters, bfloat16 compute, crop 384, batch 8, mask loss on), 2
   warm-up and 6 timed SGD steps on seeded synthetic batches; checks
   finite losses, trained parameters moved and frozen ones bit-equal,
   one affinity and one propagation launch per step; then one more step
   whose labels agree with the pseudo-GT of a sharpened head (see
   ``sharpen_head_and_label``), where the mask loss must be non-zero;
   and the refined masks of the kernel path against the plain path on
   the same card; then 2 warm-up and 4 timed steps of each SoftMaxAE
   config (ResNet-50 and -101 at batch 16, VGG16 at batch 8, crop 321):
   finite losses, trained tensors moved, frozen ones bit-equal, the live
   BatchNorms' running statistics moved (float32, finite), one launch of
   each PAMR kernel a step, the (B, 81, 81, 21) refined masks of the
   kernels against the plain path; median step ms and host issue ms;
   then the model zoo (``ZOO_TRAIN``): each registry head on the backbone
   ``tests/test_reference_parity.py`` pairs it with at that backbone's
   config (``tf_v3``, ``tf_v9``, ``tf_v9_2`` on WRN38, ``tf_v4``-``tf_v8``
   and ``tf_v10`` on ResNet-50 among them), plus ``CAM_CASA_WGAP_v6`` on
   ResNet-101, ``v5`` on VGG16 and ``ae`` on WRN38, 2 warm-up and 2
   timed steps each (the attention loss
   at weight 20 where the head has one; ``v4``'s (B, C-1) labels
   refused, as ROADMAP C2 records): step and host issue ms, peak memory,
   losses, trained tensors moved; for the PAMR heads the refined masks
   of the kernels against the plain path, and both PAMR kernels against
   their plain versions and timed at each new plane ((16, 21, 21, 21),
   (8, 21, 41, 41), (8, 21, 96, 96)); then the flagship's SEAM steps
   (``engine/seam.py``: a second forward at 0.5x scale and the ER loss),
   2 warm-up and 6 timed with the mask and ER losses on, one with
   ``er_on`` 0 and one on a sharpened head where the mask loss counts:
   finite losses, ``loss_er`` > 0, two launches of each PAMR kernel a
   step, median step and host issue ms, the refined masks of both
   scales from the kernels against the plain path, and both kernels
   against their plain versions and timed at the half-scale plane
   (8, 21, 24, 24); then data parallelism (``phase_ddp``): both PAMR
   kernels against their plain versions and timed at the per-rank
   planes (4, 21, 48, 48) and (1, 21, 48, 48) of the global batch of 8,
   ``torchrun --standalone --nproc_per_node 1`` (NCCL) running
   ``wseg_tpu_torch.train`` and ``infer_val``, two flagship steps in
   an NCCL group of one bit-equal to the same steps without a group,
   and two ``gloo`` ranks on the card (4 rows each) against one process
   on the whole batch (float32);
7. exact-CRF kernels vs plain: the four lattice kernels (norm folding,
   the split splat, the all-axes blur, slice) against their plain
   versions on the Gaussian and bilateral lattices of a photo-like
   500x375 image on the 384x512 merge canvas (the blur also bit for bit
   against the chain of per-axis plain blurs), errors, median times,
   bounds, cuSPARSE products as the library yardstick and lattice
   sizes; the slice's L2 floor (each warp tile's distinct row sectors,
   the tables and out once) at the L2 rate of a copy; the one-call filter
   against the same steps called one by one;
   then multicrop serving: the flagship model serves the 8 images
   through ``MultiCropServer`` at the covering geometry (PAD 640x640,
   crops 448x448 on a 2x2 grid with flip, 8 views an image), fast then
   exact CRF: label maps, finite scores, launch counts, images/s, peak
   memory, the postprocess's peak bytes per slot against the server's
   budget; the fast CRF's planes read from its launches, both fast-CRF
   kernels timed and held at them, the lattice kernels on the 640x640
   canvas, and the fast and exact CRF of image 0 against their plain
   versions; then the host-view paths: 4 VOC-sized images submitted
   with 640x480 and 520x390 ones (over the 512x512 device canvas, sent
   to host views), the 4 with ``DEVICE_VIEWS`` off, device against host
   views' merged scores, and ``InferenceEngine.run_image`` (host merge,
   device merge, multicrop) against the server on one image;
8. exact serving slice: the flagship model serves the 8 images with
   ``TEST.CRF_MODE exact`` (host lattice build + one host call of the
   splat, blur and slice kernels per filter); checks the label maps and
   each kernel's launch count against the count per image, the card's Q
   against the host C++ mean field on the same merged map, and bit-equal
   labels from two runs; prints images/s, host build ms and device ms
   per image;
9. entry point: ``python -m wseg_tpu_torch.train`` (``main``) trains one
   short epoch + validation on a synthetic VOC directory and writes a
   checkpoint, which ``wseg_tpu_torch.infer_val`` loads and serves, in
   the fast and in the exact CRF mode, with ``TEST.METHOD multicrop``
   and with ``TEST.DEVICE_MERGE False`` (the per-image path), the last
   two scored by ``eval_seg``; then the same ``train`` ->
   ``infer_val`` -> ``wseg_tpu_torch.eval_seg`` on ``voc_resnet50.yaml``,
   whose mIoU line must be printed and finite, on ``voc_resnet38.yaml``
   with ``NET.MODEL CAM_CASA_WGAP_v6`` and on ``voc_resnet50.yaml`` with
   ``NET.MODEL CAM_CASA_WGAP_tf_v7``; then
   ``wseg_tpu_torch.train_SEAM`` (validation, then one epoch) writes a
   checkpoint, from which ``wseg_tpu_torch.infer_cam`` (GradCAM) writes
   the 4 validation images' PNGs, the float32 GradCAM and FullGrad maps
   of the card are held to the CPU's, and ``wseg_tpu_torch.cam`` writes
   its three JPEGs; then ``train`` with ``NET.OPT Adam`` (finite
   losses), ``quant_calibrate`` on its checkpoint, ``infer_val`` in int8
   static (refused without statistics) and in int8 dynamic with the
   exact CRF, multicrop and the per-image path, each scored;
10. the card line, the kernel JSON line (launch counts summed over the
    flagship's, the ``ae``, the zoo's, multicrop, host-view, the SEAM,
    the NCCL group of one's and the int8 main paths), and last ``{"ok":
    true, ...}``.  Each phase prints its wall seconds.

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
# flagship bilateral-message shapes: 8 slots, 21 classes (and the norm
# filter's one channel), the 192x256 half grid of a 384x512 merge canvas
KERNEL_SHAPES = ((8, 21, 192, 256), (8, 1, 192, 256))
KERNEL_REL_TOL = 1e-5
# the fast CRF's Gaussian blurs: (shape, radius) of the coarse grid's
# 21-class and the full canvas's 21-class and norm (C = 1) filters, and
# the coarse grid's norm filter
GAUSS_CASES = (((8, 21, 192, 256), 3), ((8, 21, 384, 512), 6),
               ((8, 1, 384, 512), 6), ((8, 1, 192, 256), 3))
# flagship PAMR shapes: batch 8, the 384 crop at stride 8, 21 classes
PAMR_SHAPE = (8, 48, 48, 21)
# the PAMR lab's second shape, at which the propagation is timed too
PAMR_LAB_SHAPE = (8, 96, 96, 21)
# the ae configs' PAMR shape: batch 16, the 321 crop at stride 4 (odd)
AE_PAMR_SHAPE = (16, 81, 81, 21)
PAMR_DIL = (1, 2, 4, 8, 12, 24)
PAMR_ITER = 10
PAMR_REL_TOL = 1e-5
# bfloat16 planes and single-pass bf16 reads of the lab variants
PAMR_BF16_TOL = 1e-2
LAB_ARGS = ["--shape", "8,96,96,21", "--reps", "5"]
LAB_BF16_TOL = 5e-2
WARMUP_STEPS, TIMED_STEPS = 2, 6
# the class that the mask-loss step's sharpened head gives its images
MASK_CLASS = 1
# exact CRF: one photo-like VOC image on the flagship merge canvas
LATTICE_CANVAS = (384, 512)
LATTICE_IMAGE = (375, 500)
LATTICE_WINDOW = (4, 6, 375, 500)
LATTICE_REL_TOL = 1e-5
CRF_ITERS = 10
ORACLE_Q_TOL = 1e-4
# the card's published peaks (H100 SXM data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# shared memory: 128 B a clock on each of 132 SMs at 1.98 GHz
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9


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


def _kernel_window(fn, reps: int, matches) -> tuple:
    """The profiler's CUDA kernel records of a window of calls of ``fn``,
    one list for each of ``matches`` (parts of kernel names; "" takes
    every kernel), and the window's calls.  A window now and then records
    no kernel, so up to five windows, each ``reps`` calls longer than the
    last, until every match has device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wseg_tpu_torch.profile_slice import _dev_us

    fn()
    torch.cuda.synchronize()
    for window in range(1, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps * window):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        groups = [[e for e in kernels if m in e.key] for m in matches]
        if all(sum(_dev_us(e, self_only=True) for e in g) > 0
               for g in groups):
            return groups, reps * window
    raise RuntimeError(f"the profiler recorded no kernel named like "
                       f"{matches} in five windows")


def device_ms(fn, reps: int, match: str = "", per_call: int = 0) -> float:
    """Kernel time on the card per call of ``fn``: the profiler's device
    time of every kernel (or those whose name holds ``match``) over a
    window of ``reps`` calls or more, divided by its calls (no host gaps
    counted).  With ``per_call`` (the matching launches of one call), the
    mean time of the launches the profiler recorded times ``per_call``: a
    window can drop some of a run's kernel records."""
    from wseg_tpu_torch.profile_slice import _dev_us

    (evts,), calls = _kernel_window(fn, reps, (match,))
    us = sum(_dev_us(e, self_only=True) for e in evts)
    if per_call:
        return us / 1e3 / sum(e.count for e in evts) * per_call
    return us / 1e3 / calls


def device_ms_each(fn, reps: int, matches) -> list:
    """``device_ms`` of each of ``matches``, from one window."""
    from wseg_tpu_torch.profile_slice import _dev_us

    groups, calls = _kernel_window(fn, reps, matches)
    return [sum(_dev_us(e, self_only=True) for e in g) / 1e3 / calls
            for g in groups]


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
             for m in ("yaml", "PIL", "cv2", "scipy", "triton", "sklearn")}
    print(f"optional modules: {avail}", flush=True)
    return smi


def phase_build(card: str) -> None:
    from wseg_tpu_torch import _build
    from wseg_tpu_torch.ops import (
        crf_bilateral,
        crf_gauss,
        crf_lattice_cuda,
        crf_native,
        pamr_cuda,
        pamr_variants,
        qconv,
    )

    names = ("crf_bilateral", "crf_gauss", "pamr", "pamr_variants",
             "crf_lattice", "permutohedral_host", "qconv")
    def timed(name):
        t = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        secs = list(pool.map(timed, names))
    for module in (crf_bilateral, crf_gauss, pamr_cuda, pamr_variants,
                   crf_lattice_cuda, crf_native, qconv):
        module._library()
    dt = time.perf_counter() - t0
    print(f"build {', '.join(_build.source(n).name for n in names)} in "
          f"parallel: {dt:.2f} s (each: "
          f"{', '.join(f'{n} {t:.2f} s' for n, t in zip(names, secs))}) "
          f"({card})", flush=True)
    for name in names:
        for line in _build.build.log.get(name, "").splitlines():
            print(f"  nvcc {name}: {line}", flush=True)


def phase_kernel(card: str, shapes=KERNEL_SHAPES) -> dict:
    """The bilateral-message kernel against its plain version at the fast
    CRF's two message shapes (21 classes and the C = 1 norm filter);
    returns the entry of the 21-class shape (10 of the 12 launches of a
    postprocess call), without launches."""
    import torch

    from wseg_tpu_torch.ops.crf import _bilateral_taps
    from wseg_tpu_torch.ops.crf_bilateral import (
        band_plan,
        bilateral_message_cm,
        bilateral_message_cm_reference,
    )

    taps = [(-dy, -dx) for dy, dx in _bilateral_taps(40.0, 2.0)]
    entry = None
    for k, shape in enumerate(shapes):
        b, c, h, w = shape
        plan = band_plan(tuple(taps), c, h, w)
        gen = torch.Generator(device="cuda").manual_seed(k)
        q = torch.rand((b, c, h, w), generator=gen, device="cuda")
        wt = torch.rand((b, len(taps), h, w), generator=gen,
                        device="cuda").to(torch.bfloat16)
        got = bilateral_message_cm(q, wt, taps)
        want = bilateral_message_cm_reference(q, wt, taps)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        rel = max_abs / float(want.abs().max())
        print(f"kernel bilateral_message_cm at {shape}, {len(taps)} taps "
              f"(row pitch {plan.pitch}, bands of {plan.rows} rows, "
              f"{plan.group} channels a block, {plan.smem_bytes()} B of "
              f"shared memory): max_abs_err {max_abs:.3e}, rel {rel:.3e} "
              f"(tol {KERNEL_REL_TOL:g})", flush=True)
        check(rel <= KERNEL_REL_TOL,
              f"kernel disagrees with plain at {shape}: rel {rel}")
        plain_ms = cuda_median_ms(
            lambda: bilateral_message_cm_reference(q, wt, taps), reps=10)
        ms = cuda_median_ms(lambda: bilateral_message_cm(q, wt, taps),
                            reps=30)
        plain_ms2 = cuda_median_ms(
            lambda: bilateral_message_cm_reference(q, wt, taps), reps=10)
        ms2 = cuda_median_ms(lambda: bilateral_message_cm(q, wt, taps),
                             reps=30)
        dev = device_ms(lambda: bilateral_message_cm(q, wt, taps), reps=20,
                        match=bilateral_message_cm.kernel_name)
        # q read and out written once, and the bf16 weights of the taps
        # that land inside the image (the others are never read)
        nbytes = 2 * q.numel() * 4 + 2 * b * valid_tap_pixels(taps, h, w)
        flops = 2 * b * c * valid_tap_pixels(taps, h, w)
        bnd = bound(nbytes, flops)
        print(f"kernel bilateral_message_cm {shape} median {ms:.4f} / "
              f"{ms2:.4f} ms per call (CUDA events), {dev * 1e3:.2f} us of "
              f"kernel (profiler); plain median {plain_ms:.4f} / "
              f"{plain_ms2:.4f} ms (two rounds); bound "
              f"{bnd['bound_ms'] * 1e3:.2f} us ({bnd['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB) ({card})", flush=True)
        if entry is None:
            entry = {"name": "bilateral_message_cm", "route": "cuda",
                     "source": "wseg_tpu_torch/csrc/crf_bilateral.cu",
                     "replaces": "wseg_tpu/ops/crf_pallas.py:108",
                     "max_abs_err": max_abs, "ms": min(ms, ms2),
                     "plain_ms": min(plain_ms, plain_ms2), **bnd,
                     "library_ms": None}
    return entry


def gauss_taps(r: int):
    """The fast CRF's 1-D Gaussian at radius r (sxy = r / 2)."""
    import math

    sxy = r / 2.0
    return [math.exp(-i * i / (2.0 * sxy * sxy)) for i in range(-r, r + 1)]


def ptxas_lines(name: str, entry: str) -> list:
    """The register and spill lines ptxas printed for the kernel entries
    of library ``name`` whose mangled names hold ``entry``."""
    from wseg_tpu_torch import _build

    out, take = [], False
    for line in _build.build.log.get(name, "").splitlines():
        if "Compiling entry function" in line:
            take = entry in line
        elif take and ("Used" in line or "spill" in line):
            out.append(line.strip())
    return out


def phase_gauss(card: str, cases=GAUSS_CASES) -> dict:
    """The Gaussian-blur kernel against its plain version at the fast
    CRF's four filter shapes, each without and with the valid mask as
    the CRF calls it (at C = 1 the norm filter blurs the mask itself, so
    x is the mask); returns the entry of the coarse grid's masked filter
    (9 of the 12 launches of a postprocess call), without launches."""
    import torch
    import torch.nn.functional as F

    from wseg_tpu_torch.ops.crf_gauss import (
        BANDS,
        _occupancy,
        _sm_count,
        gauss_blur_cm,
        gauss_blur_cm_reference,
        gauss_plan,
    )

    torch.backends.cudnn.allow_tf32 = False
    for r in sorted({r for _, r in cases}):
        lines = ptxas_lines("crf_gauss", f"gauss_band_kernelILi{r}E")
        check(lines, f"no ptxas lines for gauss_band_kernel<{r}>")
        print(f"ptxas gauss_band_kernel<{r}>: {'; '.join(lines)}",
              flush=True)
    entry = None
    for k, (shape, r) in enumerate(cases):
        k1d = gauss_taps(r)
        gen = torch.Generator(device="cuda").manual_seed(3 + k)
        x = torch.rand(shape, generator=gen, device="cuda")
        b, c, h, w = shape
        # a padded slot's valid mask: the image's window is 1, the rest 0
        valid = torch.zeros((b, 1, h, w), device="cuda")
        valid[:, :, :h * 3 // 4, :w * 5 // 6] = 1.0
        # the library yardstick: one cuDNN convolution of the (B*C, 1, H,
        # W) view with the (2r+1)^2 outer-product kernel, TF32 off
        k2d = torch.outer(torch.tensor(k1d), torch.tensor(k1d)).to(x)

        for mask in (None, valid):
            tag = "masked" if mask is not None else "unmasked"
            # the norm filter: gauss_filter(valid_mask), x and mask one
            # tensor (0/1, so the function is the blur of the mask)
            if mask is not None and c == 1:
                x = valid
            xv = x.view(-1, 1, h, w)

            def library():
                return F.conv2d(xv, k2d[None, None], padding=r)

            masked = mask is not None
            plan = gauss_plan(b * c, h, w, r, masked,
                              _occupancy(r, masked, 0), _sm_count(0))
            got = gauss_blur_cm(x, k1d, r, mask=mask)
            want = gauss_blur_cm_reference(x, k1d, r, mask)
            torch.cuda.synchronize()
            max_abs = float((got - want).abs().max())
            rel = max_abs / float(want.abs().max())
            print(f"kernel gauss_blur_cm at {shape}, r {r}, {tag}: band "
                  f"{plan.bw} x {plan.sh} rows, {plan.threads} threads, "
                  f"{plan.smem_bytes()} B of shared memory, "
                  f"{_occupancy(r, masked, 0)} blocks an SM at bands "
                  f"{BANDS}, {plan.blocks} blocks ({plan.waves:.2f} waves); "
                  f"max_abs_err {max_abs:.3e}, rel {rel:.3e} (tol "
                  f"{KERNEL_REL_TOL:g})", flush=True)
            check(rel <= KERNEL_REL_TOL, f"Gaussian kernel disagrees with "
                  f"plain at {shape}, {tag}: rel {rel}")
            # F.conv2d computes the same function without a mask, and for
            # the norm filter (a 0/1 mask times itself); else it blurs x
            same = mask is None or x is mask
            if same:
                lib_err = float((library().view(shape) - got).abs().max()
                                ) / float(got.abs().max())
            p1 = cuda_median_ms(
                lambda: gauss_blur_cm_reference(x, k1d, r, mask), 10)
            k1 = cuda_median_ms(lambda: gauss_blur_cm(x, k1d, r, mask=mask),
                                30)
            k2 = cuda_median_ms(lambda: gauss_blur_cm(x, k1d, r, mask=mask),
                                30)
            p2 = cuda_median_ms(
                lambda: gauss_blur_cm_reference(x, k1d, r, mask), 10)
            lib_ms = cuda_median_ms(library, 30)
            dev = device_ms(lambda: gauss_blur_cm(x, k1d, r, mask=mask),
                            reps=20, match=gauss_blur_cm.kernel_name)
            # 20 calls back to back between two events: the kernels queue
            # up, so this is about their device time when the host keeps
            # ahead
            burst = cuda_median_ms(
                lambda: [gauss_blur_cm(x, k1d, r, mask=mask)
                         for _ in range(20)], 5) / 20
            # x read and out written once, the mask read once where it
            # is not x
            nbytes = 2 * x.numel() * 4 + (0 if same else mask.numel() * 4)
            flops = 2 * 2 * (2 * r + 1) * x.numel() + (
                0 if mask is None else x.numel())
            bnd = bound(nbytes, flops)
            print(f"kernel gauss_blur_cm {shape} r {r} {tag} median "
                  f"{k1:.4f} / {k2:.4f} ms per call (CUDA events), "
                  f"{burst:.4f} ms per call of 20 back to back, "
                  f"{dev * 1e3:.2f} us of kernel (profiler, "
                  f"{bnd['bound_ms'] / dev:.1%} of the bound); plain median "
                  f"{p1:.4f} / {p2:.4f} ms; library F.conv2d {lib_ms:.4f} "
                  f"ms ({'the same function' if same else 'unmasked x'}; "
                  f"rel diff {lib_err:.2e}); bound "
                  f"{bnd['bound_ms'] * 1e3:.2f} us ({bnd['bound_by']}, "
                  f"{nbytes / 1e6:.1f} MB) ({card})", flush=True)
            if entry is None and mask is not None:
                entry = {"name": "gauss_blur_cm", "route": "cuda",
                         "source": "wseg_tpu_torch/csrc/crf_gauss.cu",
                         "replaces": "wseg_tpu/ops/crf_pallas.py:167",
                         "max_abs_err": max_abs, "ms": min(k1, k2),
                         "plain_ms": min(p1, p2), **bnd,
                         # no one call blurs x * mask: F.conv2d (printed
                         # above) computes the unmasked blur only
                         "library_ms": None}
    return entry


def phase_slice(card: str) -> dict:
    import torch

    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.infer import _postprocess
    from wseg_tpu_torch.flagship import (
        build_flagship_server,
        load_cfg,
        synthetic_images,
    )
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    kernels = (bilateral_message_cm, gauss_blur_cm)
    src = load_cfg("voc_resnet38.yaml")
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
        t0 = time.perf_counter()
        for size in sigs.values():
            before = [f.launches for f in kernels]
            server.warmup([size])
            delta = [f.launches - n for f, n in zip(kernels, before)]
            check(delta == [12, 12], f"warm-up group {size}: {delta} "
                  "bilateral and Gaussian launches, expected 12 each")
        torch.cuda.synchronize()
        print(f"warm-up, one group per size signature: "
              f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
        pp_calls[0] = 0
        for f in kernels:
            f.launches = 0
        t0 = time.perf_counter()
        futs = [server.submit(img, lab) for img, lab in images]
        results = [f.result(timeout=600) for f in futs]
        dt = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in kernels}
    finally:
        server.close()
    print(f"slice: {len(images)} images in {dt:.3f} s = "
          f"{len(images) / dt:.3f} images/s, {pp_calls[0]} postprocess "
          f"calls, launches {launches} ({card})", flush=True)
    check(pp_calls[0] >= len(sigs),
          f"{pp_calls[0]} postprocess calls for >= {len(sigs)} served groups")
    check(all(n == 12 * pp_calls[0] for n in launches.values()),
          f"launches {launches} for {pp_calls[0]} postprocess calls, "
          "expected 12 of each kernel per call")

    check_results("slice", images, results)

    # scores of one image per size are finite, and the writer math
    # (incl. the CRF with both kernels) on the card matches the same
    # math on the CPU (their plain versions) for the first image
    for k, (img, lab) in enumerate(images[:4]):
        total, cls_all, dst, u8 = image_merged_sums(server, img)
        check(bool(torch.isfinite(total).all()) and all(
            bool(torch.isfinite(c).all()) for c in cls_all),
            f"non-finite scores for image {k}")
        if k == 0:
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


def pamr_inputs(b: int, h: int, w: int, c: int, seed: int):
    """Channels-major guide (B, 3, H, W) and softmax mask (B, C, H, W)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    guide = torch.rand((b, h, w, 3), generator=gen, device="cuda")
    mask = torch.softmax(torch.randn((b, h, w, c), generator=gen,
                                     device="cuda") * 3, dim=-1)
    return (guide.permute(0, 3, 1, 2).contiguous(),
            mask.permute(0, 3, 1, 2).contiguous())


def propagate_host_us(aff, mask) -> dict:
    """Host us to enqueue one propagation (0 steps, so the card keeps up
    with the calls), best of 3 x 400 calls: ``call`` the whole wrapper,
    ``entry`` its C entry (plan and pointers made beforehand),
    ``refused`` the same ctypes call with num_iter -1, which the C entry
    refuses before any CUDA call."""
    import ctypes

    import torch

    from wseg_tpu_torch.ops import pamr_cuda as pc

    b, c, h, w = mask.shape
    _, plan_ints, dil_ints = pc._plan(b, c, h, w, PAMR_DIL, 0,
                                      mask.device.index)
    lib = pc._library()
    out = torch.empty_like(mask)
    ptrs = (aff.data_ptr(), mask.data_ptr(), out.data_ptr(),
            ctypes.addressof(dil_ints), len(PAMR_DIL), b, c, h, w)
    plan_ptr = ctypes.addressof(plan_ints)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(steps):
        return lib.wseg_pamr_propagate(*ptrs, steps, plan_ptr, stream)

    check(entry(-1) != 0, "the propagation's C entry took num_iter -1")
    check(entry(0) == 0, "the propagation's C entry refused its plan")
    fns = {"call": lambda: pc.pamr_propagate_cm(aff, mask, PAMR_DIL, 0),
           "entry": lambda: entry(0), "refused": lambda: entry(-1)}
    return {name: min(host_us(fn, 400) for _ in range(3))
            for name, fn in fns.items()}


def affinity_host_us(im) -> dict:
    """Host us to enqueue one affinity, best of 3 x 400 calls: ``call``
    the whole wrapper, ``entry`` its C entry (plan and pointers made
    beforehand), ``refused`` the same ctypes call with no dilations,
    which the C entry refuses before any CUDA call."""
    import ctypes

    import torch

    from wseg_tpu_torch.ops import pamr_cuda as pc

    b, _, h, w = im.shape
    _, plan_ints, dil_ints = pc._affinity_launch(b, h, w, PAMR_DIL)
    lib = pc._library()
    out = torch.empty((b, 8 * len(PAMR_DIL), h, w), device=im.device)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(n_dil):
        return lib.wseg_pamr_affinity(
            im.data_ptr(), out.data_ptr(), ctypes.addressof(dil_ints), n_dil,
            b, h, w, ctypes.addressof(plan_ints), stream)

    check(entry(0) != 0, "the affinity's C entry took no dilations")
    check(entry(len(PAMR_DIL)) == 0, "the affinity's C entry refused its "
          "plan")
    fns = {"call": lambda: pc.pamr_affinity_cm(im, PAMR_DIL),
           "entry": lambda: entry(len(PAMR_DIL)), "refused": lambda: entry(0)}
    return {name: min(host_us(fn, 400) for _ in range(3))
            for name, fn in fns.items()}


def phase_pamr_kernels(card: str) -> list:
    """Both PAMR kernels against their plain versions at the flagship
    shapes and at the ``ae`` configs' (16, 81, 81, 21), and the
    propagation also at the lab's (8, 96, 96, 21):
    errors, call times, the profiler's kernel time, bounds, the
    propagation's host plan and ptxas lines.  Returns the flagship's
    (affinity entry, propagation entry) without launches."""
    from wseg_tpu_torch.ops.pamr_cuda import (
        affinity_plan_for,
        pamr_affinity_cm,
        pamr_affinity_cm_reference,
        pamr_propagate_cm,
        pamr_propagate_cm_reference,
        pamr_taps,
        propagate_plan_for,
    )

    t = len(PAMR_DIL) * 8
    taps9 = [tap for d in PAMR_DIL for tap in pamr_taps((d,)) + [(0, 0)]]
    entries = []
    for k, (b, h, w, c) in enumerate((PAMR_SHAPE, PAMR_LAB_SHAPE,
                                      AE_PAMR_SHAPE)):
        shape = (b, h, w, c)
        im_cm, m_cm = pamr_inputs(b, h, w, c, seed=1 + k)
        aff = pamr_affinity_cm(im_cm, PAMR_DIL)
        aff_ref = pamr_affinity_cm_reference(im_cm, PAMR_DIL)
        out = pamr_propagate_cm(aff_ref, m_cm, PAMR_DIL, PAMR_ITER)
        out_ref = pamr_propagate_cm_reference(aff_ref, m_cm, PAMR_DIL,
                                              PAMR_ITER)
        plan = propagate_plan_for(m_cm, PAMR_DIL, PAMR_ITER)
        inst = f"pamr_propagate_cluster_kernelILi{plan.g}ELi{plan.p}E"
        lines = ptxas_lines("pamr", inst)
        check(lines, f"no ptxas lines for {inst}")
        print(f"propagation plan at {shape}: G {plan.g} channels a unit, "
              f"clusters of N {plan.n} CTAs (rows {list(plan.bands())[:2]} "
              f"...), {plan.threads} threads taking {plan.p} pixels "
              f"together, {plan.sdil} dilations' affinities in shared "
              f"memory, {plan.smem_bytes()} B of shared memory, "
              f"{plan.total_ctas} CTAs, {plan.clusters} clusters at once "
              f"({plan.waves:.2f} waves); "
              f"ptxas {inst}: {'; '.join(lines)}", flush=True)
        aplan = affinity_plan_for(im_cm, PAMR_DIL)
        inst = "pamr_affinity_kernel"
        lines = ptxas_lines("pamr", inst)
        check(lines, f"no ptxas lines for {inst}")
        print(f"affinity plan at {(b, 3, h, w)}: tiles of one row of "
              f"{aplan.cols} pixels, "
              f"{aplan.threads} threads, {aplan.smem_bytes()} B of shared "
              f"memory, {aplan.ctas} CTAs; ptxas {inst}: "
              f"{'; '.join(lines)}", flush=True)
        # affinity: per pixel and channel 4 ops per sigma tap (mean, then
        # deviation squared and summed) + 4 per logit tap; 3 per softmax
        # tap
        aff_flops = b * h * w * (3 * 4 * len(taps9) + 3 * 4 * t + 3 * t)
        cases = [("pamr_propagate_cm", "wseg_tpu/ops/pamr_pallas.py:134",
                  out, out_ref,
                  lambda: pamr_propagate_cm_reference(aff_ref, m_cm, PAMR_DIL,
                                                      PAMR_ITER),
                  lambda: pamr_propagate_cm(aff_ref, m_cm, PAMR_DIL,
                                            PAMR_ITER),
                  pamr_propagate_cm.kernel_name,
                  (aff_ref.numel() + 2 * m_cm.numel()) * 4,
                  # edge replication: every tap reads a pixel
                  2 * b * c * PAMR_ITER * t * h * w)]
        if k != 1:
            cases.insert(0, (
                "pamr_affinity_cm", "wseg_tpu/ops/pamr_pallas.py:215", aff,
                aff_ref, lambda: pamr_affinity_cm_reference(im_cm, PAMR_DIL),
                lambda: pamr_affinity_cm(im_cm, PAMR_DIL),
                pamr_affinity_cm.kernel_name,
                (im_cm.numel() + aff.numel()) * 4, aff_flops))
        for (name, src, got, want, plain, kernel, kname, nbytes,
             flops) in cases:
            max_abs = float((got - want).abs().max())
            rel = max_abs / float(want.abs().max())
            print(f"kernel {name} at {shape}, dilations {PAMR_DIL}, "
                  f"{PAMR_ITER} steps: max_abs_err {max_abs:.3e}, rel "
                  f"{rel:.3e} (tol {PAMR_REL_TOL:g})", flush=True)
            check(rel <= PAMR_REL_TOL,
                  f"{name} disagrees with plain at {shape}: rel {rel}")
            p1 = cuda_median_ms(plain, reps=10)
            k1 = cuda_median_ms(kernel, reps=30)
            k2 = cuda_median_ms(kernel, reps=30)
            p2 = cuda_median_ms(plain, reps=10)
            dev = device_ms(kernel, reps=20, match=kname)
            bnd = bound(nbytes, flops)
            # the propagation's floor when every FMA reads its plane value
            # from shared memory (4 B at 128 B a clock on each of 132
            # SMs at 1.98 GHz)
            floor = (f"; shared-memory floor "
                     f"{flops / 2 * 4 / SMEM_BYTES_PER_S * 1e6:.2f} us"
                     if name == "pamr_propagate_cm" else "")
            print(f"kernel {name} {shape} median {k1:.4f} / {k2:.4f} ms "
                  f"per call (CUDA events), {dev * 1e3:.2f} us of kernel "
                  f"(profiler, {bnd['bound_ms'] / dev:.1%} of the bound); "
                  f"plain median {p1:.4f} / {p2:.4f} ms; bound "
                  f"{bnd['bound_ms'] * 1e3:.2f} us ({bnd['bound_by']}, "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e6:.1f} MFLOP){floor} "
                  f"({card})", flush=True)
            if k == 0:
                split = (propagate_host_us(aff_ref, m_cm)
                         if name == "pamr_propagate_cm"
                         else affinity_host_us(im_cm))
                print(f"kernel {name} {shape} host us a call ("
                      f"{'0 steps, ' if name == 'pamr_propagate_cm' else ''}"
                      f"the card keeping up): wrapper {split['call']:.2f}, "
                      f"of which the C entry {split['entry']:.2f} (its "
                      f"ctypes call refused before any CUDA call "
                      f"{split['refused']:.2f}, so the launch "
                      f"{split['entry'] - split['refused']:.2f}) and "
                      f"Python {split['call'] - split['entry']:.2f} "
                      f"({card})", flush=True)
            if k == 0:
                entries.append({"name": name, "route": "cuda",
                                "source": "wseg_tpu_torch/csrc/pamr.cu",
                                "replaces": src, "max_abs_err": max_abs,
                                "ms": min(k1, k2), "plain_ms": min(p1, p2),
                                "kernel_ms": dev, **bnd,
                                "library_ms": None})
    return entries


def phase_pamr_variants(card: str) -> list:
    """The three lab variants against their plain versions at the
    flagship PAMR shapes, at the lab's block sizes and types; then the
    lab itself (``bench_pamr.main``), whose run gives each variant's
    launch count.  Returns (fold, dxfirst, mxu) entries."""
    import torch

    from wseg_tpu_torch import bench_pamr
    from wseg_tpu_torch.ops import pamr_variants as pv
    from wseg_tpu_torch.ops.pamr_cuda import pamr_affinity_cm

    b, h, w, c = PAMR_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    guide = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    mask = torch.softmax(torch.randn((b, c, h, w), generator=gen,
                                     device="cuda") * 3, dim=1)
    aff = pamr_affinity_cm(guide, PAMR_DIL)
    t = 8 * len(PAMR_DIL)
    nbytes = (aff.numel() + 2 * mask.numel()) * 4
    bnd = bound(nbytes, 2 * b * c * PAMR_ITER * t * h * w)
    cases = (  # (kernel, keywords, exact float32, JSON entry)
        (pv.propagate_fold_cm, {"block_b": 4}, True, "propagate_fold"),
        (pv.propagate_fold_cm, {"block_b": 4,
                                "store_dtype": torch.bfloat16}, False, None),
        (pv.propagate_dxfirst_cm, {"block_b": 1}, True, None),
        (pv.propagate_dxfirst_cm, {"block_b": 4}, True, "propagate_dxfirst"),
        (pv.propagate_dxfirst_cm, {"block_b": 4,
                                   "store_dtype": torch.bfloat16}, False,
         None),
        (pv.propagate_mxu_cm, {"block_b": 2, "precision": "highest"}, True,
         "propagate_mxu"),
        (pv.propagate_mxu_cm, {"block_b": 2, "precision": "default"}, False,
         None))
    sources = {"propagate_fold": "tools/bench_pamr.py:107",
               "propagate_dxfirst": "tools/bench_pamr.py:199",
               "propagate_mxu": "tools/bench_pamr.py:311"}
    entries = []
    for kernel, kw, f32, entry in cases:
        plain = getattr(pv, kernel.__name__ + "_reference")
        pkw = {k: v for k, v in kw.items() if k != "block_b"}
        label = kernel.__name__ + "(" + ", ".join(
            f"{k}={v}" for k, v in kw.items()) + ")"

        def run(kernel=kernel, kw=kw):
            return kernel(aff, mask, PAMR_DIL, PAMR_ITER, **kw)

        def run_plain(plain=plain, pkw=pkw):
            return plain(aff, mask, PAMR_DIL, PAMR_ITER, **pkw)

        got, want = run(), run_plain()
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        rel = max_abs / float(want.abs().max())
        tol = (f"rel tol {PAMR_REL_TOL:g}" if f32
               else f"abs tol {PAMR_BF16_TOL:g}")
        print(f"kernel {label} at {PAMR_SHAPE}, {PAMR_ITER} steps: "
              f"max_abs_err {max_abs:.3e}, rel {rel:.3e} ({tol})",
              flush=True)
        check(rel <= PAMR_REL_TOL if f32 else max_abs <= PAMR_BF16_TOL,
              f"{label} disagrees with plain: {max_abs}")
        p1 = cuda_median_ms(run_plain, reps=5)
        k1 = cuda_median_ms(run, reps=30)
        k2 = cuda_median_ms(run, reps=30)
        p2 = cuda_median_ms(run_plain, reps=5)
        dev = device_ms(run, reps=10, match="pamr_")
        print(f"kernel {label} median {k1:.4f} / {k2:.4f} ms per call, "
              f"{dev * 1e3:.2f} us of kernel (profiler); plain median "
              f"{p1:.4f} / {p2:.4f} ms; bound {bnd['bound_ms'] * 1e3:.2f} us "
              f"({bnd['bound_by']}) ({card})", flush=True)
        if entry:
            entries.append({"name": entry, "route": "cuda",
                            "source": "wseg_tpu_torch/csrc/pamr_variants.cu",
                            "replaces": sources[entry], "max_abs_err": max_abs,
                            "ms": min(k1, k2), "plain_ms": min(p1, p2), **bnd,
                            "library_ms": None})

    kernels = (pv.propagate_fold_cm, pv.propagate_dxfirst_cm,
               pv.propagate_mxu_cm)
    for f in kernels:
        f.launches = 0
    print(f"lab: python -m wseg_tpu_torch.bench_pamr {' '.join(LAB_ARGS)}",
          flush=True)
    rows = bench_pamr.main(LAB_ARGS)
    for entry, f in zip(entries, kernels):
        entry["launches"] = f.launches
        check(entry["launches"] > 0, f"the lab never launched {entry['name']}")
    # against the float32 reference: the float32 rows to rounding; the
    # bfloat16 rows (held to their own plain versions above) carry one
    # bf16 rounding per stored step, 2e-2 after 10 steps at the lab shape
    for r in rows:
        low = "bf16" in r["name"] or "default" in r["name"]
        tol = LAB_BF16_TOL if low else PAMR_REL_TOL
        check(r["err"] <= tol, f"lab row {r['name']}: err {r['err']}")
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
        load_cfg,
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
    src = load_cfg("voc_resnet38.yaml")
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


def smooth_image(h: int, w: int, seed: int):
    """Photo-like (h, w, 3) uint8 image: a random 1/48-resolution colour
    field resampled bilinearly (flat regions share lattice vertices as a
    photo's do; noise would make every pixel its own)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed)
    low = torch.rand((1, 3, max(h // 48, 2), max(w // 48, 2)), generator=gen)
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False)[0]
    return (img.permute(1, 2, 0) * 255).to(torch.uint8).numpy()


def sparse_csr(crow, col, val, shape):
    """A CSR matrix on the card, for the library yardstick only."""
    import torch

    return torch.sparse_csr_tensor(crow.long(), col.long(), val, size=shape,
                                   check_invariants=True)


def lattice_library_calls(tables, wn_pix, wn_csr, q, lat):
    """PyTorch's cuSPARSE CSR x dense products for the kernels that have
    one: the splat S'^T q (one call), the blur B_d ... B_0 lat (d+1
    calls, one per axis) and the slice alpha S' lat (one call); the norm
    folding has none."""
    import torch

    m, d1, n_pix = tables.m, tables.d1, tables.ids.shape[0]
    splat = sparse_csr(torch.cat([tables.row_ptr, tables.row_ptr[-1:]]),
                       torch.div(tables.entries, d1, rounding_mode="floor"),
                       wn_csr, (m + 1, n_pix))
    real = tables.ids[:, 0] < m
    ids, order = torch.sort(tables.ids[real].long(), dim=1)
    vals = torch.gather(wn_pix[real], 1, order) * tables.alpha
    crow = torch.zeros(n_pix + 1, dtype=torch.long, device=q.device)
    crow[1:] = torch.cumsum(real.long() * d1, 0)
    slice_ = sparse_csr(crow, ids.reshape(-1), vals.reshape(-1),
                        (n_pix, m + 1))
    blurs = []
    for j in range(d1):
        nbr = tables.nbr[j].long()
        cols = torch.cat([torch.arange(m, device=q.device)[:, None], nbr], 1)
        w3 = torch.tensor([1.0, 0.5, 0.5], device=q.device).expand(m, 3)
        keep = cols < m
        cols, order = torch.sort(torch.where(keep, cols, m + 1), dim=1)
        w3 = torch.gather(torch.where(keep, w3, 0.0), 1, order)
        keep = cols <= m
        crow = torch.zeros(m + 2, dtype=torch.long, device=q.device)
        crow[1:m + 1] = torch.cumsum(keep.sum(1), 0)
        crow[m + 1] = crow[m]
        blurs.append(sparse_csr(crow, cols[keep], w3[keep], (m + 1, m + 1)))

    def blur_axes():
        out = lat
        for b in blurs:
            out = torch.sparse.mm(b, out)
        return out

    return {"lattice_splat": lambda: torch.sparse.mm(splat, q),
            "lattice_blur": blur_axes,
            "lattice_slice": lambda: torch.sparse.mm(slice_, lat)}


def host_us(fn, n: int = 50) -> float:
    """Host time to enqueue one call of ``fn`` (us), over ``n`` calls
    enqueued back to back while the card works behind them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def lattice_filter_row(name, tables, wn_pix, wn_csr, q, card: str) -> None:
    """The one-call filter (``lattice_filter_cuda``) against its steps
    called one by one (splat, blur, slice: 3 calls; splat, d+1 one-axis
    blurs, slice: d+3 calls, a launch per blur axis) and the plain filter:
    results, call times, host enqueue time, kernel time and bound."""
    import torch

    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    def one():
        return k.lattice_filter_cuda(q, tables, wn_pix, wn_csr)

    def steps(per_axis: bool):
        lat = k.lattice_splat(tables, wn_csr, q)
        for nbr in (tables.nbr if per_axis else [tables.nbr]):
            lat = k.lattice_blur(lat, nbr)
        return k.lattice_slice(lat, tables.ids, wn_pix, tables.alpha)

    def plain():
        return k.lattice_filter_reference(q, tables, wn_pix, wn_csr)

    got, want = one(), plain()
    torch.cuda.synchronize()
    rel = float((got - want).abs().max()) / float(want.abs().max())
    same = (torch.equal(got, steps(False)), torch.equal(got, steps(True)))
    print(f"filter ({name} lattice): one call vs plain rel {rel:.3e} (tol "
          f"{LATTICE_REL_TOL:g}); bit-equal to the 3 step calls / the "
          f"d+3 step calls: {same}", flush=True)
    check(rel <= LATTICE_REL_TOL and all(same),
          f"one-call filter on the {name} lattice: rel {rel}, {same}")
    runs = {"one call": one, "3 step calls": lambda: steps(False),
            f"{tables.d1 + 2} step calls": lambda: steps(True),
            "plain": plain}
    order = ["one call", "3 step calls", f"{tables.d1 + 2} step calls",
             "plain", "plain", f"{tables.d1 + 2} step calls", "3 step calls",
             "one call"]
    ms = {key: [] for key in runs}
    for key in order:
        ms[key].append(cuda_median_ms(runs[key],
                                      reps=10 if key == "plain" else 30))
    host = {key: host_us(runs[key]) for key in runs if key != "plain"}
    # the one call's host time in parts: argument checks, device and
    # stream lookup, the two allocations; the rest is ctypes + 3 launches
    i32, f32 = torch.int32, torch.float32
    parts = {
        "checks": host_us(lambda: k._splat_tables(
            "lattice_filter", tables, wn_csr, q, nbr=(tables.nbr, i32, 3),
            ids=(tables.ids, i32, 2), w_pix=(wn_pix, f32, 2))),
        "device+stream": host_us(lambda: k._launch(
            lambda stream: 0, "none", q.device)),
        "allocation": host_us(lambda: torch.empty(
            ((q.shape[0] + 2 * (tables.m + 1) + tables.chunk_row.numel())
             * q.shape[1],), dtype=f32, device=q.device))}
    dev = device_ms(one, reps=20, match="lattice_")
    n_pix, d1, m, c = q.shape[0], tables.d1, tables.m, q.shape[1]
    e = tables.entries.numel()
    # compulsory: the real pixels' values and the CSR (row pointers,
    # entries, weights) in, the neighbour and pixel-major tables, the
    # canvas out; the lattice stays on chip
    bnd = bound(4 * ((e // d1) * c + (m + 1) + 2 * e + 2 * d1 * m
                     + 2 * n_pix * d1 + n_pix * c),
                2 * e * c + 3 * d1 * m * c + 2 * n_pix * d1 * c + n_pix * c)
    print(f"filter ({name}) median ms per call, in turns: " + "; ".join(
        f"{key} {' / '.join(f'{t:.4f}' for t in ts)}"
        for key, ts in ms.items()) + "; host enqueue us per call: " + ", ".join(
        f"{key} {us:.1f}" for key, us in host.items()) + " (one call: "
        + ", ".join(f"{key} {us:.1f}" for key, us in parts.items())
        + f"); one call {dev * 1e3:.2f} us of kernels (profiler); bound "
        f"{bnd['bound_ms'] * 1e3:.2f} us ({bnd['bound_by']}) ({card})",
        flush=True)


def l2_rate() -> float:
    """Bytes/s, read and written, of a float32 copy between two 8 MB
    tensors resident in the 50 MB L2 (the profiler's kernel time of 50
    copies): the L2 rate a plain streaming kernel reaches."""
    import torch

    x = torch.rand(2 << 20, device="cuda")
    y = torch.empty_like(x)
    return 2 * x.numel() * 4 / (device_ms(lambda: y.copy_(x), reps=50) / 1e3)


def slice_l2_bytes(tables, c: int) -> dict:
    """The slice's L2 floor: the distinct 32 B vertex-row sectors (a row
    is C floats) that each warp's tile of pixels gathers, which it must
    read at least once, and the ids, weights and out once.  And, as an
    upper estimate of its traffic, the row sectors of every real (pixel,
    slot) gather, as if none hit L1."""
    import torch

    ids = tables.ids.long()
    real = ids < tables.m
    first = ids * 4 * c // 32
    last = (ids * 4 * c + 4 * c - 1) // 32
    rows = int((last - first + 1)[real].sum()) * 32
    once = 4 * (2 * ids.numel() + ids.shape[0] * c)
    tile = 32 if c >= 4 else 128
    pix = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    span = int((last - first).max()) + 1
    sec = (first[..., None] + torch.arange(span, device=ids.device))
    keep = real[..., None] & (sec <= last[..., None])
    key = (pix[..., None] // tile) * (int(last.max()) + 1) + sec
    distinct = int(torch.unique(key[keep]).numel()) * 32
    return {"no_l1": rows, "once": once, "floor": distinct + once,
            "tile_distinct": distinct}


def phase_lattice_kernels(card: str, canvas=LATTICE_CANVAS,
                          image=LATTICE_IMAGE, window=LATTICE_WINDOW,
                          full: bool = True) -> list:
    """The four exact-CRF kernels against their plain versions on the
    lattices of one photo-like VOC image on a merge canvas (the
    flagship's by default): (entries without launches) for the bilateral
    lattice, and the same checks for the Gaussian one; with ``full``
    also the slice's L2 floor and per lattice the one-call filter."""
    import torch

    from wseg_tpu_torch.engine.infer import ExactCRF
    from wseg_tpu_torch.flagship import THRESHS
    from wseg_tpu_torch.ops import crf_lattice_cuda as k
    from wseg_tpu_torch.ops.crf_lattice import SPLAT_CHUNK, kernel_norm

    hc, wc = canvas
    img = smooth_image(*image, seed=0)
    ex = ExactCRF(THRESHS, crf_iters=CRF_ITERS)
    t0 = time.perf_counter()
    lat_g, lat_b = ex.build(img, canvas, window, device="cuda")
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    print(f"exact-CRF lattices of a photo-like {image[1]}x"
          f"{image[0]} image on the {hc}x{wc} canvas: Gaussian (d=2) "
          f"m = {lat_g.m}, bilateral (d=5) m = {lat_b.m}, CSR rows of the "
          f"bilateral lattice: mean {lat_b.entries.numel() / lat_b.m:.1f}, "
          f"max {int((lat_b.row_ptr[1:] - lat_b.row_ptr[:-1]).max())} "
          f"entries; split tables (chunks of {SPLAT_CHUNK}): Gaussian "
          f"{lat_g.chunk_row.numel()} chunks, {lat_g.splits.shape[0]} split "
          f"rows, bilateral {lat_b.chunk_row.numel()} chunks, "
          f"{lat_b.splits.shape[0]} split rows; host build {dt:.1f} ms with "
          f"upload ({card})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.softmax(torch.randn((hc * wc, 21), generator=gen,
                                  device="cuda") * 3, dim=-1)
    l2_bps = l2_rate() if full else None
    entries = []
    for name, tables in (("Gaussian", lat_g), ("bilateral", lat_b)):
        norm = kernel_norm(tables)
        wn_pix, wn_csr = k.lattice_weights(tables.w, tables.w_csr,
                                           tables.entries, norm)
        lat = k.lattice_splat(tables, wn_csr, q)
        n_pix, d1, m, c = hc * wc, tables.d1, tables.m, 21
        e = tables.entries.numel()
        n_real = e // d1  # the pixels the CSR covers
        cases = (  # name, TPU kernel, kernel call, plain call, bytes, flops
            ("lattice_weights", "wseg_tpu/ops/crf_mm.py:446",
             lambda: k.lattice_weights(tables.w, tables.w_csr,
                                       tables.entries, norm),
             lambda: k.lattice_weights_reference(tables.w, tables.w_csr,
                                                 tables.entries, norm),
             4 * (2 * n_pix * d1 + 3 * e + n_pix), n_pix * d1 + e),
            ("lattice_splat", "wseg_tpu/ops/crf_mm.py:497",
             lambda: k.lattice_splat(tables, wn_csr, q),
             lambda: k.lattice_splat_split_reference(
                 tables.chunk_ptr, tables.chunk_row, tables.entries, wn_csr,
                 q, d1),
             4 * ((m + 1) + 2 * e + n_real * c + (m + 1) * c), 2 * e * c),
            ("lattice_blur", "wseg_tpu/ops/crf_mm.py:544",
             lambda: k.lattice_blur(lat, tables.nbr),
             lambda: k.lattice_blur_axes_reference(lat, tables.nbr),
             4 * (2 * (m + 1) * c + 2 * d1 * m), 3 * d1 * m * c),
            ("lattice_slice", "wseg_tpu/ops/crf_mm.py:544",
             lambda: k.lattice_slice(lat, tables.ids, wn_pix, tables.alpha),
             lambda: k.lattice_slice_reference(lat, tables.ids, wn_pix,
                                               tables.alpha),
             4 * ((m + 1) * c + 2 * n_pix * d1 + n_pix * c),
             2 * n_pix * d1 * c + n_pix * c))
        library = lattice_library_calls(tables, wn_pix, wn_csr, q, lat)
        for kname, src, kernel, plain, nbytes, flops in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            max_abs = max(float((g - w).abs().max()) for g, w in
                          zip(got, want))
            rel = max_abs / max(float(w.abs().max()) for w in want)
            note = ""
            if kname == "lattice_splat":
                rows = k.lattice_splat_reference(tables.row_ptr,
                                                 tables.entries, wn_csr, q, d1)
                note = (f", rel to the row-order plain splat "
                        f"{float((got[0] - rows).abs().max()) / float(rows.abs().max()):.3e}")
            if kname == "lattice_blur":  # the chain of d+1 per-axis blurs
                same = torch.equal(got[0], want[0])
                note = f", bit-equal to the {d1} per-axis plain blurs: {same}"
                check(same, f"all-axes blur vs per-axis chain on the {name} "
                      "lattice: not bit-equal")
            print(f"kernel {kname} ({name} lattice, m {m}, C {c}): "
                  f"max_abs_err {max_abs:.3e}, rel {rel:.3e} "
                  f"(tol {LATTICE_REL_TOL:g}){note}", flush=True)
            check(rel <= LATTICE_REL_TOL,
                  f"{kname} disagrees with plain on the {name} lattice: "
                  f"rel {rel}")
            p1 = cuda_median_ms(plain, reps=10)
            k1 = cuda_median_ms(kernel, reps=30)
            k2 = cuda_median_ms(kernel, reps=30)
            p2 = cuda_median_ms(plain, reps=10)
            lib_ms = None
            if kname in library:
                lib_out = library[kname]()
                lib_err = float((lib_out - got[0]).abs().max()) / float(
                    got[0].abs().max())
                lib_ms = cuda_median_ms(library[kname], reps=30)
                lib_dev = device_ms(library[kname], reps=20)
                print(f"  library torch.sparse.mm (CSR"
                      f"{f', {d1} calls' if kname == 'lattice_blur' else ''})"
                      f" {lib_ms:.4f} ms per call, {lib_dev * 1e3:.2f} us of "
                      f"kernel (profiler), rel diff to the kernel "
                      f"{lib_err:.3e}", flush=True)
            bnd = bound(nbytes, flops)
            dev = device_ms(kernel, reps=20, match=kname)
            enqueue = host_us(kernel)
            print(f"kernel {kname} ({name}) median {k1:.4f} / {k2:.4f} ms "
                  f"per call (CUDA events), {dev * 1e3:.2f} us of kernel "
                  f"(profiler, {bnd['bound_ms'] / dev:.1%} of the bound), "
                  f"host enqueue {enqueue:.1f} us per call; plain "
                  f"median {p1:.4f} / {p2:.4f} ms; bound "
                  f"{bnd['bound_ms'] * 1e3:.2f} us ({bnd['bound_by']}, "
                  f"{nbytes / 1e6:.2f} MB) ({card})", flush=True)
            if kname == "lattice_slice" and full:
                l2 = slice_l2_bytes(tables, c)
                floor_us = l2["floor"] / l2_bps * 1e6
                no_l1_us = (l2["no_l1"] + l2["once"]) / l2_bps * 1e6
                print(f"  L2 floor of the slice ({name}, C {c}): each warp "
                      f"tile's distinct row sectors once, "
                      f"{l2['tile_distinct'] / 1e6:.2f} MB, + "
                      f"{l2['once'] / 1e6:.2f} MB of tables and out = "
                      f"{l2['floor'] / 1e6:.2f} MB, {floor_us:.2f} us at "
                      f"the L2 rate of a copy, {l2_bps / 1e12:.2f} TB/s "
                      f"(the kernel takes {dev * 1e3 / floor_us:.2f}x it); "
                      f"upper estimate of its L2 traffic, if no gather hit "
                      f"L1: {l2['no_l1'] / 1e6:.2f} MB of row sectors, "
                      f"{no_l1_us:.2f} us with the tables and out "
                      f"({card})", flush=True)
            if name == "bilateral":
                entries.append({
                    "name": kname, "route": "cuda",
                    "source": "wseg_tpu_torch/csrc/crf_lattice.cu",
                    "replaces": src, "max_abs_err": max_abs,
                    "ms": min(k1, k2), "plain_ms": min(p1, p2), **bnd,
                    "library_ms": lib_ms})
        if full:
            lattice_filter_row(name, tables, wn_pix, wn_csr, q, card)
    return entries


def per_image_launches(t: int) -> dict:
    """Kernel launches of one exact CRF: per lattice (Gaussian d=2,
    bilateral d=5) a norm filter and t mean-field filters, each one
    splat, one blur of all d+1 axes and one slice, and one norm
    folding."""
    filters = 2 * (t + 1)
    return {"lattice_weights": 2, "lattice_splat": filters,
            "lattice_blur": filters, "lattice_slice": filters}


def image_merged_sums(server, img):
    """One image through the server's fused views -> forward -> merge
    steps, alone: (sums (1, H, W, C), cls per scale, dst window, scale-1.0
    views (1, H, W, 3) uint8)."""
    import torch

    from wseg_tpu_torch.ops.view_gen import build_views_u8

    dev = server.device
    canvas, owin, pads, _ = server.views.build_device(img, server.canvas_hw)
    h, w = img.shape[:2]
    shapes = server.views.view_shapes(w, h)
    vpi = 2 if server.views.flip else 1
    orig = torch.from_numpy(canvas[None]).to(dev)
    ow = torch.tensor([owin], device=dev)
    dst = torch.tensor([pads[0]], device=dev)
    total, cls_all = 0, []
    for si, shp in enumerate(shapes):
        vw = torch.tensor([pads[vpi * si]], device=dev)
        cls, part = server.infer_mv(orig, ow, vw, dst, out_hw=tuple(shp),
                                    flip_pair=server.views.flip,
                                    merge_hw=tuple(shapes[0]))
        total = total + part
        cls_all.append(cls)
    u8 = build_views_u8(orig, ow, dst, out_hw=tuple(shapes[0]),
                        flip_pair=False)
    return total, cls_all, dst, u8


def image_merged_map(server, img, lab):
    """One image's cleaned BG^pow merged map (Hc, Wc, C) on the card, as
    the exact-mode writer math hands it to ExactCRF, and its window."""
    import torch

    from wseg_tpu_torch.engine.infer import _postprocess

    pp = server.postprocess
    total, _, dst, u8 = image_merged_sums(server, img)
    _, merged = _postprocess(total, torch.from_numpy(lab[None]).cuda(), dst,
                             u8, n_views=server.views.num_views, **pp._kw)
    return merged[0], tuple(int(v) for v in dst[0])


def check_against_host_oracle(img, lab, merged, window, tables, server,
                              card: str) -> None:
    """The card's exact CRF against the host C++ mean field on the same
    merged map, and two runs from fresh lattices bit-equal.

    The seeded model's masks are nearly uniform across classes, so an
    image with several present classes has them nearly tied at every
    pixel (printed: the median ratio of the second to the top score),
    and the mean field amplifies any difference in summation order
    there from iteration to iteration (printed: max |dQ| after t
    iterations).  The held check takes the image with one present class
    (its first), whose map has no such ties: max |dQ| <= 1e-4 and
    >= 99.5% equal labels."""
    import numpy as np
    import torch

    from wseg_tpu_torch.engine.infer import ExactCRF, _pred
    from wseg_tpu_torch.flagship import THRESHS
    from wseg_tpu_torch.ops.crf_exact import crf_exact
    from wseg_tpu_torch.ops.crf_native import crf_inference_native

    pt, pl, h, w = window

    def card_and_host(m, t):
        with torch.inference_mode():
            q = crf_exact(m, *tables, t=t)[pt:pt + h, pl:pl + w]
        host = crf_inference_native(
            img, m[pt:pt + h, pl:pl + w].cpu().numpy(), t=t)
        return q.cpu().numpy(), host

    growth = {}
    for t in (1, 2, 4, CRF_ITERS):
        got, want = card_and_host(merged, t)
        growth[t] = float(np.abs(got - want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    top2 = torch.topk(merged[pt:pt + h, pl:pl + w], 2, dim=-1).values
    tie = float((top2[..., 1] / top2[..., 0]).median())
    print(f"exact CRF image 0 with its {int(lab.sum())} classes (median "
          f"second/top score {tie:.6f}): card vs host max |dQ| after t "
          f"iterations {growth}, argmax agreement at t={CRF_ITERS} "
          f"{agree:.5f} (near-tied classes; not held)", flush=True)

    one = np.zeros_like(lab)
    one[np.flatnonzero(lab)[0]] = 1.0
    merged1, _ = image_merged_map(server, img, one)
    t0 = time.perf_counter()
    got, want = card_and_host(merged1, CRF_ITERS)
    host_ms = (time.perf_counter() - t0) * 1e3
    dq = float(np.abs(got - want).max())
    agree = [float((_pred(torch.from_numpy(got), t)
                    == _pred(torch.from_numpy(want), t)).float().mean())
             for t in THRESHS]
    print(f"exact CRF image 0 ({w}x{h}) with one class: card Q vs host C++ "
          f"mean field max |dQ| {dq:.3e} (tol {ORACLE_Q_TOL:g}), label "
          f"agreement {agree} (>= 0.995); card + host C++ CRF {host_ms:.1f} "
          f"ms ({card})", flush=True)
    check(dq <= ORACLE_Q_TOL, f"card Q vs host oracle: {dq}")
    check(min(agree) >= 0.995, f"label agreement {agree}")

    runs = []
    for _ in range(2):
        fresh = ExactCRF(THRESHS, crf_iters=CRF_ITERS)
        lat = fresh.build(img, merged.shape[:2], window, device="cuda")
        runs.append((fresh.q(lat, merged), fresh.run(lat, merged)))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"exact CRF image 0, two runs from fresh lattices: Q and label "
          f"maps bit-equal: {same}", flush=True)
    check(same, "two exact-CRF runs of one image differ")


def phase_exact_slice(card: str) -> dict:
    """The flagship serving path with TEST.CRF_MODE exact; returns the
    lattice kernels' launch counts of the served run."""
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.flagship import (
        build_flagship_server,
        load_cfg,
        synthetic_images,
    )
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    kernels = {f.__name__: f for f in (k.lattice_weights, k.lattice_splat,
                                       k.lattice_blur, k.lattice_slice)}
    reset_cfg()
    load_cfg("voc_resnet38.yaml")
    cfg.TEST.CRF_MODE = "exact"
    server = build_flagship_server("cuda", seed=0)
    pp = server.postprocess
    check(pp.exact is not None and pp.exact.iters == CRF_ITERS,
          "the flagship postprocess is not in exact mode")
    images = synthetic_images(VOC_SIZES)
    sigs = {tuple(server.views.view_shapes(w, h)): (w, h)
            for (w, h) in VOC_SIZES}
    try:
        t0 = time.perf_counter()
        server.warmup(list(sigs.values()))
        torch.cuda.synchronize()
        print(f"exact slice warm-up, one group per size signature: "
              f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        futs = [server.submit(img, lab) for img, lab in images]
        results = [f.result(timeout=600) for f in futs]
        dt = time.perf_counter() - t0
        launches = {n: f.launches for n, f in kernels.items()}
    finally:
        server.close()
    want = {n: len(images) * v
            for n, v in per_image_launches(CRF_ITERS).items()}
    print(f"exact slice: {len(images)} images in {dt:.3f} s = "
          f"{len(images) / dt:.3f} images/s; launches {launches} "
          f"(expected {want}) ({card})", flush=True)
    check(launches == want, f"lattice launches {launches}, expected {want}")
    check_results("exact slice", images, results)

    # per image: host build and device time apart, one at a time
    ex = pp.exact
    builds, run_ms = [], []
    for k_img, (img, lab) in enumerate(images):
        merged, window = image_merged_map(server, img, lab)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = ex.build(img, merged.shape[:2], window, device="cuda")
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0) * 1e3)
        run_ms.append(cuda_median_ms(lambda: ex.run(tables, merged),
                                     reps=3, warmup=1))
        if k_img == 0:
            kernel_ms = device_ms(lambda: ex.run(tables, merged), reps=3)
            lattice_ms = device_ms(lambda: ex.run(tables, merged), reps=3,
                                   match="lattice_")
            lat_b = tables[1]
            rows = lat_b.row_ptr[1:] - lat_b.row_ptr[:-1]
            print(f"exact CRF image 0: kernels {kernel_ms:.2f} ms per run "
                  f"(profiler), of which lattice kernels {lattice_ms:.2f} ms; "
                  f"its bilateral lattice m = {lat_b.m}, CSR rows mean "
                  f"{lat_b.entries.numel() / lat_b.m:.1f}, max "
                  f"{int(rows.max())}, {lat_b.splits.shape[0]} split rows "
                  f"({card})", flush=True)
            check_against_host_oracle(img, lab, merged, window, tables,
                                      server, card)
    print(f"exact CRF per image: host lattice build + upload "
          f"{[round(b, 1) for b in builds]} ms (median "
          f"{sorted(builds)[len(builds) // 2]:.1f}); device (ExactCRF.run, "
          f"CUDA events) {[round(d, 2) for d in run_ms]} ms (median "
          f"{sorted(run_ms)[len(run_ms) // 2]:.2f}) ({card})",
          flush=True)
    del server
    torch.cuda.empty_cache()
    return launches


def phase_entry(card: str) -> None:
    """``wseg_tpu_torch.train.main`` for one short epoch + validation on
    a synthetic VOC, then ``infer_val`` on its checkpoint: fast and exact
    CRF, multicrop and the per-image path, the last two scored by
    ``eval_seg``."""
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

        reset_cfg()
        out = os.path.join(tmp, "masks_exact")
        t0 = time.perf_counter()
        infer_val.main(common + ["--resume", suffix, "--infer-list",
                                 os.path.join(root, "val_voc.txt"),
                                 "--mask-output-dir", out] + sets
                       + ["TEST.CRF_MODE", "exact"])
        dt = time.perf_counter() - t0
        n = {sub: len(os.listdir(os.path.join(out + "_0", sub)))
             for sub in ("no_crf", "crf")}
        check(n == {"no_crf": 4, "crf": 4}, f"exact infer_val wrote {n}")
        print(f"entry point: infer_val with TEST.CRF_MODE exact wrote {n} "
              f"PNGs at threshold 0.0 in {dt:.2f} s ({card})", flush=True)

        # multicrop at the covering geometry, and the per-image path
        # (InferenceEngine, host C++ CRF in the writers), each scored
        for tag, extra in (("multicrop", MULTICROP_SET),
                           ("per-image", ["TEST.DEVICE_MERGE", "False"])):
            reset_cfg()
            out = os.path.join(tmp, "masks_" + tag)
            t0 = time.perf_counter()
            infer_val.main(common + ["--resume", suffix, "--infer-list",
                                     os.path.join(root, "val_voc.txt"),
                                     "--mask-output-dir", out] + sets
                           + extra)
            dt = time.perf_counter() - t0
            n = {sub: len(os.listdir(os.path.join(out + "_0", sub)))
                 for sub in ("no_crf", "crf")}
            check(n == {"no_crf": 4, "crf": 4}, f"{tag} infer_val wrote {n}")
            miou = score_masks(root, out + "_0", tmp)
            print(f"entry point: infer_val ({tag}, {extra}) wrote {n} PNGs "
                  f"at threshold 0.0 in {dt:.2f} s; eval_seg mIoU "
                  f"{miou:.4f} ({card})", flush=True)
    finally:
        reset_cfg()
        shutil.rmtree(tmp, ignore_errors=True)


def score_masks(root: str, masks: str, tmp: str) -> float:
    """``eval_seg`` on ``<masks>/crf``: its table must show the 4 images
    and a finite mIoU, which it returns."""
    import contextlib
    import io
    import math

    from wseg_tpu_torch import eval_seg

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        stats = eval_seg.main([
            "--data", root, "--filelist", os.path.join(root, "val_voc.txt"),
            "--masks", os.path.join(masks, "crf"),
            "--log-scores", os.path.join(tmp, "scores.log")])
    lines = [ln for ln in text.getvalue().splitlines()
             if ln.startswith(("# of images", "mIoU"))]
    check(len(lines) == 3 and "# of images: 4" in lines[0]
          and math.isfinite(stats["miou"]),
          f"eval_seg printed {lines}, mIoU {stats['miou']}")
    return float(stats["miou"])


# multicrop serving at the covering geometry of bench.py (the default
# PAD 1024 / grid 2x2 has stride 512 > crop 448 and is refused): crops
# 448x448 on a 2x2 grid with flip over the 640x640 canvas, stride 320
MULTICROP_SET = ["TEST.METHOD", "multicrop", "TEST.PAD_SIZE", "[640, 640]"]
# a photo larger than the flagship's 512x512 device canvas, and a second
# one just over it: both take the host-view path
OVERSIZE = [(640, 480), (520, 390)]
# card bfloat16 model, device against host views of the same image
# (one-LSB pixel differences through the forward): mean |d merged|
VIEWS_MEAN_TOL = 1e-2
# the per-image engine against the server on one image (same batches,
# float32 merges in another order)
ENGINE_TOL = 1e-4


def crf_planes(run) -> dict:
    """Run ``run()`` and count the fast CRF's kernel calls in it by plane:
    ("bilateral_message_cm", shape) and ("gauss_blur_cm", shape, r,
    masked)."""
    from collections import Counter

    from wseg_tpu_torch.ops import crf as crf_mod

    seen = Counter()
    bil, gauss = crf_mod.bilateral_message_cm, crf_mod.gauss_blur_cm

    def rec_b(q, *args, **kw):
        seen[("bilateral_message_cm", tuple(q.shape))] += 1
        return bil(q, *args, **kw)

    def rec_g(x, k1d, r, *args, **kw):
        seen[("gauss_blur_cm", tuple(x.shape), int(r),
              kw.get("mask") is not None)] += 1
        return gauss(x, k1d, r, *args, **kw)

    crf_mod.bilateral_message_cm, crf_mod.gauss_blur_cm = rec_b, rec_g
    try:
        run()
    finally:
        crf_mod.bilateral_message_cm, crf_mod.gauss_blur_cm = bil, gauss
    return dict(seen)


def check_results(tag, images, results, labels=True) -> None:
    """uint8 label maps in [0, 20] at each image's size; the GT labels
    back."""
    import numpy as np

    from wseg_tpu_torch.flagship import THRESHS

    for (img, lab), (res, got_lab) in zip(images, results):
        if labels:
            check(np.array_equal(got_lab, lab), f"{tag}: labels changed")
        for t in THRESHS:
            for key in ("pred", "pred_crf"):
                m = res[t][key]
                check(m.dtype == np.uint8 and m.shape == img.shape[:2]
                      and int(m.max()) <= 20,
                      f"{tag} {key}@{t}: {m.dtype} {m.shape} max {m.max()}")


def serve_timed(server, images):
    """Submit every image, wait for all; (results, seconds)."""
    t0 = time.perf_counter()
    futs = [server.submit(img, lab) for img, lab in images]
    results = [f.result(timeout=600) for f in futs]
    return results, time.perf_counter() - t0


def pp_peak_ratio(pp, hw, slots: int, lab, n_views: int) -> float:
    """Peak device bytes of one ``dispatch_group`` over ``slots`` random
    (H, W, 21) merged maps (the window the whole canvas), per slot, over
    the bytes of one slot's float32 merged map."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    h, w = hw
    sums = torch.rand((slots, h, w, 21), generator=gen, device="cuda")
    u8 = torch.randint(0, 256, (slots, h, w, 3), generator=gen,
                       device="cuda").to(torch.uint8)
    wins = np.tile(np.asarray([0, 0, h, w], np.int32), (slots, 1))
    labels = np.repeat(lab[None], slots, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = pp.dispatch_group(sums, labels, wins, u8, n_views)
    torch.cuda.synchronize()
    del out
    return ((torch.cuda.max_memory_allocated() - base) / slots
            / (h * w * 21 * 4))


def phase_multicrop_serve(card: str):
    """The flagship model serves the 8 VOC-sized images through
    ``MultiCropServer`` at the covering geometry, in fast then exact CRF
    mode; the fast CRF's planes read from its launches, the postprocess's
    peak bytes per slot, both fast-CRF kernels at those planes, the
    lattice kernels on the 640x640 canvas and the fast and exact CRF on
    image 0's merged map against their plain versions.  Returns the fast
    CRF's and the lattice kernels' launches of the served runs."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, cfg_from_list, reset_cfg
    from wseg_tpu_torch.engine import serving
    from wseg_tpu_torch.engine.infer import ExactCRF
    from wseg_tpu_torch.flagship import (
        THRESHS,
        build_flagship_server,
        load_cfg,
        synthetic_images,
    )
    from wseg_tpu_torch.ops import crf_lattice_cuda as k
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm
    from wseg_tpu_torch.ops.crf_exact import crf_exact
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    fast_kernels = (bilateral_message_cm, gauss_blur_cm)
    lattice = {f.__name__: f for f in (k.lattice_weights, k.lattice_splat,
                                       k.lattice_blur, k.lattice_slice)}
    reset_cfg()
    src = load_cfg("voc_resnet38.yaml")
    cfg_from_list(MULTICROP_SET)
    server = build_flagship_server("cuda", seed=0)
    views = server.views
    print(f"multicrop serving ({src} + {MULTICROP_SET}): pad "
          f"{views.pad_size}, crop {views.crop_h}x{views.crop_w}, grid "
          f"{views.grid_h}x{views.grid_w}, flip {views.flip}: "
          f"{views.num_views} views an image at {views.coords}, "
          f"{server.max_batch} slots, bg_pow "
          f"{server.postprocess._kw['bg_pow']} ({card})", flush=True)
    pp = server.postprocess
    pp_calls = [0]
    dispatch_group = pp.dispatch_group

    def counted_dispatch(*args, **kw):
        pp_calls[0] += 1
        return dispatch_group(*args, **kw)

    pp.dispatch_group = counted_dispatch
    images = synthetic_images(VOC_SIZES)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        before = [f.launches for f in fast_kernels]
        server.warmup([VOC_SIZES[0]])
        delta = [f.launches - n for f, n in zip(fast_kernels, before)]
        check(delta == [12, 12], f"multicrop warm-up: {delta}")
        torch.cuda.synchronize()
        print(f"multicrop warm-up group: {time.perf_counter() - t0:.2f} s",
              flush=True)
        pp_calls[0] = 0
        for f in fast_kernels:
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        results, dt = serve_timed(server, images)
        launches = {f.__name__: f.launches for f in fast_kernels}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        server.close()
    print(f"multicrop serving (fast CRF): {len(images)} images in {dt:.3f} "
          f"s = {len(images) / dt:.3f} images/s, {pp_calls[0]} postprocess "
          f"calls, launches {launches}, peak memory {peak:.2f} GiB "
          f"({card})", flush=True)
    check(pp_calls[0] >= 1 and all(n == 12 * pp_calls[0]
                                   for n in launches.values()),
          f"multicrop launches {launches} for {pp_calls[0]} calls")
    check_results("multicrop", images, results)

    # one image's merged map: finite scores, the CRF's planes, the
    # postprocess's peak bytes per slot
    img, lab = images[0]
    h, w = img.shape[:2]
    pt, pl, _, _ = views.window(h, w)
    canv = np.zeros((1, *views.pad_size, 3), np.uint8)
    canv[0, pt:pt + h, pl:pl + w] = img
    canv_d = torch.from_numpy(canv).cuda()
    owin = torch.tensor([[pt, pl, h, w]], device="cuda")
    cls, merged = server.dispatch_crops(canv_d, owin)
    check(bool(torch.isfinite(merged).all() and torch.isfinite(cls).all()),
          "multicrop: non-finite scores")
    labels = lab[None]
    # one present class: no near-tied classes, whose mean field would
    # amplify the kernels' and the plain versions' summation orders
    one = np.zeros_like(lab)
    one[np.flatnonzero(lab)[0]] = 1.0
    planes = crf_planes(lambda: pp.dispatch_group(
        merged, labels, owin.cpu().numpy(), canv_d, views.num_views))
    print(f"multicrop fast CRF planes (kernel, plane[, r, masked]: calls "
          f"per postprocess call): {planes}", flush=True)
    slots = server.max_batch
    ratios = {}
    for hw in (views.pad_size, LATTICE_CANVAS):
        for s_n in (1, slots):
            ratios[(hw, s_n)] = pp_peak_ratio(pp, hw, s_n, lab,
                                              views.num_views)
    print(f"fast-CRF postprocess peak bytes per slot over its float32 "
          f"merged map, by (canvas, slots): {ratios}; the server budgets "
          f"{serving.PP_BYTES_PER_CANVAS_BYTE} ({card})", flush=True)
    check(max(ratios.values()) <= serving.PP_BYTES_PER_CANVAS_BYTE,
          f"postprocess peak {ratios} over PP_BYTES_PER_CANVAS_BYTE")
    # the fast CRF on this merged map (float32), card against CPU: as
    # served (no BG_POW, so background and the class nearly tie on the
    # seeded model's flat masks: argmax held), and with BG^3 (no ties:
    # Q held)
    crf_on_merged_map("multicrop", server, merged, one, owin, canv_d, card,
                      hold_q=False)
    crf_on_merged_map("multicrop", server, merged, one, owin, canv_d, card,
                      bg_pow=3.0)

    # exact mode: the served run, then image 0's exact CRF on the
    # 640x640 canvas against the plain filter on the CPU
    cfg.TEST.CRF_MODE = "exact"
    server = build_flagship_server("cuda", seed=0)
    try:
        server.warmup([VOC_SIZES[0]])
        for f in lattice.values():
            f.launches = 0
        results, dt = serve_timed(server, images)
        lat_launches = {n: f.launches for n, f in lattice.items()}
    finally:
        server.close()
    want = {n: len(images) * v
            for n, v in per_image_launches(CRF_ITERS).items()}
    print(f"multicrop serving (exact CRF): {len(images)} images in "
          f"{dt:.3f} s = {len(images) / dt:.3f} images/s; launches "
          f"{lat_launches} (expected {want}) ({card})", flush=True)
    check(lat_launches == want, f"multicrop exact launches {lat_launches}")
    check_results("multicrop exact", images, results)
    ex = ExactCRF(THRESHS, crf_iters=CRF_ITERS)
    window = (pt, pl, h, w)
    tables = ex.build(img, views.pad_size, window, device="cuda")
    with torch.inference_mode():
        # image 0's map with one class and BG^3 (no near-tied classes)
        m_clean = merged[0] / float(views.num_views)
        m_clean[..., 1:] *= torch.from_numpy(one).cuda()
        m_clean[..., 0] = m_clean[..., 0].clamp(min=0.0) ** 3
        q_card = crf_exact(m_clean, *tables, t=CRF_ITERS)
        q_cpu = crf_exact(m_clean.cpu(), *(t.to("cpu") for t in tables),
                          t=CRF_ITERS)
    cut = (slice(pt, pt + h), slice(pl, pl + w))
    dq = float((q_card.cpu() - q_cpu)[cut].abs().max())
    agree = float((q_card.cpu()[cut].argmax(-1) == q_cpu[cut].argmax(-1))
                  .float().mean())
    print(f"multicrop exact CRF, image 0 with one class and BG^3 ({w}x{h} "
          f"at {window} of "
          f"{views.pad_size}), kernels vs the plain filter on the CPU: max "
          f"|dQ| {dq:.3e} (tol {CRF_Q_TOL:g}), argmax agreement {agree:.5f} "
          f"({card})", flush=True)
    check(dq <= CRF_Q_TOL, f"multicrop exact CRF |dQ| {dq}")
    del server
    torch.cuda.empty_cache()

    # both fast-CRF kernels at the planes read above, the lattice kernels
    # on the 640x640 canvas
    bil_shapes = tuple(sorted({p[1] for p in planes
                               if p[0] == "bilateral_message_cm"},
                              key=lambda s: -s[1]))
    gauss_cases = tuple(sorted({(p[1], p[2]) for p in planes
                                if p[0] == "gauss_blur_cm"},
                               key=lambda c: (-c[0][1], c[0][2])))
    phase_kernel(card, tuple((slots, *s[1:]) for s in bil_shapes))
    phase_gauss(card, tuple(((slots, *s[1:]), r) for s, r in gauss_cases))
    ph, pw = views.pad_size
    lh, lw = LATTICE_IMAGE
    phase_lattice_kernels(card, canvas=(ph, pw), image=LATTICE_IMAGE,
                          window=((ph - lh) // 2, (pw - lw) // 2, lh, lw),
                          full=False)
    return launches, lat_launches


def phase_host_paths(card: str) -> dict:
    """The host-view paths on the card with the flagship model: 4
    VOC-sized images submitted with two larger than the 512x512 device
    canvas (the server sends those to host views), then the 4 with
    ``DEVICE_VIEWS`` off, with the fast-CRF postprocess; device against
    host views' merged scores; and ``InferenceEngine.run_image`` in
    host-merge, device-merge and multicrop mode against the server on the
    same image.  Returns the fast CRF's launches of the served runs."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, cfg_from_list, reset_cfg
    from wseg_tpu_torch.engine.infer import InferenceEngine
    from wseg_tpu_torch.engine.serving import MultiScaleServer
    from wseg_tpu_torch.engine.serving_crop import MultiCropServer
    from wseg_tpu_torch.flagship import (
        build_flagship_server,
        load_cfg,
        synthetic_images,
    )
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    kernels = (bilateral_message_cm, gauss_blur_cm)
    reset_cfg()
    load_cfg("voc_resnet38.yaml")
    server = build_flagship_server("cuda", seed=0)
    model, pp = server.model, server.postprocess
    voc = synthetic_images(VOC_SIZES[:4])
    over = synthetic_images(OVERSIZE, seed=1)
    paths = {"_process_device": 0, "_process_host": 0}
    pp_calls = [0]

    def spy_on(srv):
        for name in paths:
            run = getattr(srv, name)

            def spy(group, _run=run, _name=name):
                paths[_name] += len(group)
                return _run(group)

            setattr(srv, name, spy)

    dispatch_group = pp.dispatch_group

    def counted_dispatch(*args, **kw):
        pp_calls[0] += 1
        return dispatch_group(*args, **kw)

    pp.dispatch_group = counted_dispatch
    spy_on(server)
    for f in kernels:
        f.launches = 0
    try:
        results, dt = serve_timed(server, voc + over)
    finally:
        server.close()
    launches = {f.__name__: f.launches for f in kernels}
    print(f"host paths: {len(voc)} VOC-sized images + {OVERSIZE} over the "
          f"{server.canvas_hw} canvas in {dt:.3f} s; images per path "
          f"{paths}, {pp_calls[0]} postprocess calls, launches {launches} "
          f"({card})", flush=True)
    check(paths == {"_process_device": len(voc),
                    "_process_host": len(over)},
          f"host paths: {paths}")
    check_results("oversize split", voc + over, results)

    cfg.TEST.DEVICE_VIEWS = False
    server = MultiScaleServer(model, cfg.TEST, max_batch=8, postprocess=pp)
    paths.update({"_process_device": 0, "_process_host": 0})
    spy_on(server)
    try:
        results, dt = serve_timed(server, voc)
    finally:
        server.close()
    for f in kernels:
        launches[f.__name__] = f.launches
    print(f"host paths: DEVICE_VIEWS False, {len(voc)} images in {dt:.3f} "
          f"s, images per path {paths}; {pp_calls[0]} postprocess calls, "
          f"launches {launches} so far ({card})", flush=True)
    check(paths["_process_host"] == len(voc), f"host views: {paths}")
    check_results("host views", voc, results)
    check(all(n == 12 * pp_calls[0] for n in launches.values()),
          f"host paths: launches {launches} for {pp_calls[0]} calls")

    merged = {}
    for device_views in (True, False):
        cfg.TEST.DEVICE_VIEWS = device_views
        srv = MultiScaleServer(model, cfg.TEST, max_batch=8)
        try:
            merged[device_views], _ = serve_timed(srv, voc)
        finally:
            srv.close()
    diffs, agree = [], []
    for (m_d, _), (m_h, _) in zip(merged[True], merged[False]):
        check(m_d.shape == m_h.shape and np.isfinite(m_d).all()
              and np.isfinite(m_h).all(), "views: merged shapes or values")
        diffs.append(float(np.abs(m_d - m_h).mean()))
        agree.append(float((m_d.argmax(-1) == m_h.argmax(-1)).mean()))
    print(f"device vs host views, merged scores: mean |d| per image "
          f"{[f'{d:.2e}' for d in diffs]} (tol {VIEWS_MEAN_TOL:g}), argmax "
          f"agreement {[round(a, 4) for a in agree]} ({card})", flush=True)
    check(max(diffs) <= VIEWS_MEAN_TOL, f"device vs host views: {diffs}")

    # the per-image engine against the server on one image, per mode
    img, lab = voc[0]
    for mode, sets in (("host-merge", ["TEST.DEVICE_MERGE", "False"]),
                       ("device-merge", ["TEST.DEVICE_MERGE", "True"]),
                       ("multicrop", MULTICROP_SET)):
        reset_cfg()
        load_cfg("voc_resnet38.yaml")
        cfg_from_list(["TEST.DEVICE_VIEWS", "False"] + sets)
        engine = InferenceEngine(model, cfg.TEST)
        t0 = time.perf_counter()
        got, got_lab = engine.run_image(img, lab)
        dt = time.perf_counter() - t0
        srv = (MultiScaleServer if mode != "multicrop" else MultiCropServer)(
            model, cfg.TEST, max_batch=8)
        try:
            [(want, want_lab)], _ = serve_timed(srv, [(img, lab)])
        finally:
            srv.close()
        err = float(np.abs(got - want).max())
        print(f"InferenceEngine.run_image ({mode}, {img.shape[1]}x"
              f"{img.shape[0]}) in {dt:.3f} s: against the server max |d| "
              f"{err:.3e} (tol {ENGINE_TOL:g}) ({card})", flush=True)
        check(got.shape == img.shape[:2] + (21,) and np.isfinite(got).all()
              and err <= ENGINE_TOL and np.array_equal(got_lab, want_lab),
              f"engine {mode} vs server: {err}")
    del server, model
    torch.cuda.empty_cache()
    return launches


AE_CONFIGS = ("voc_resnet50.yaml", "voc_resnet101.yaml", "voc_vgg16.yaml")
AE_WARMUP_STEPS, AE_TIMED_STEPS = 2, 4


def live_bn_stats(model) -> dict:
    """Copies of the running statistics of the model's live BatchNorms."""
    from wseg_tpu_torch.models.backbones.common import BatchNorm

    return {f"{n}.{k}": getattr(m, k).detach().clone()
            for n, m in model.named_modules() if isinstance(m, BatchNorm)
            for k in ("running_mean", "running_var")}


def phase_ae_train(card: str) -> dict:
    """Train steps of the three SoftMaxAE configs at full width (their
    batch, crop 321, bfloat16 autocast, seeded weights with the
    bottlenecks' conv3 zeroed); returns the PAMR launch counts of the
    timed and warm-up steps."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.engine.train_loop import (
        normalise_batch_image,
        train_step,
    )
    from wseg_tpu_torch.engine.trainer import build_train_model
    from wseg_tpu_torch.flagship import load_cfg, synthetic_train_batch
    from wseg_tpu_torch.ops.pamr import pamr, pamr_reference
    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_propagate_cm,
    )
    from wseg_tpu_torch.optim import FROZEN, make_optimizer

    launches = {"pamr_affinity_cm": 0, "pamr_propagate_cm": 0}
    for name in AE_CONFIGS:
        reset_cfg()
        src = load_cfg(name)
        crop, bs = int(cfg.DATASET.CROP_SIZE), int(cfg.TRAIN.BATCH_SIZE)
        check(cfg.NET.MODEL == "ae" and crop == 321
              and bs == (8 if cfg.NET.BACKBONE == "vgg16" else 16)
              and cfg.NET.DTYPE == "bfloat16",
              f"{name}: not the config's train settings")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        model = build_train_model(torch.device("cuda"), seed=0)
        opt, labels = make_optimizer(cfg.NET, model)
        params = dict(model.named_parameters())
        check(all(p.dtype == torch.float32 for p in params.values()),
              "training parameters must be float32")
        init = {n: p.detach().clone() for n, p in params.items()}
        stats0 = live_bn_stats(model)
        print(f"ae train model {cfg.NET.BACKBONE} ({src}): "
              f"{sum(p.numel() for p in params.values())} float32 params, "
              f"{len(stats0) // 2} live BatchNorms, autocast "
              f"{model.amp_dtype}, crop {crop}, batch {bs}, SG_PSI "
              f"{cfg.NET.SG_PSI}, built in {time.perf_counter() - t0:.2f} s "
              f"({card})", flush=True)
        rng = np.random.RandomState(0)
        batches = [synthetic_train_batch(rng, bs, crop)
                   for _ in range(AE_WARMUP_STEPS + AE_TIMED_STEPS)]
        kw = dict(device_jitter=True, loss_name=str(cfg.NET.LOSS),
                  mask_loss_bce=float(cfg.NET.MASK_LOSS_BCE))
        walls, issues, losses = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pamr_affinity_cm.launches = 0
        pamr_propagate_cm.launches = 0
        for i, batch in enumerate(batches):
            before = (pamr_affinity_cm.launches, pamr_propagate_cm.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = train_step(model, opt, batch, 1.0, **kw)
            t_issue = time.perf_counter()
            torch.cuda.synchronize()
            if i >= AE_WARMUP_STEPS:
                walls.append((time.perf_counter() - t) * 1e3)
                issues.append((t_issue - t) * 1e3)
            delta = (pamr_affinity_cm.launches - before[0],
                     pamr_propagate_cm.launches - before[1])
            check(delta == (1, 1), f"{name} step {i}: PAMR launches {delta}")
            losses.append({k: float(v) for k, v in metrics.items()})
        launches["pamr_affinity_cm"] += pamr_affinity_cm.launches
        launches["pamr_propagate_cm"] += pamr_propagate_cm.launches
        check(all(np.isfinite(v) for m in losses for v in m.values()),
              f"{name}: non-finite losses {losses}")
        walls.sort()
        issues.sort()
        med = walls[len(walls) // 2]
        print(f"ae train steps {cfg.NET.BACKBONE} (after {AE_WARMUP_STEPS} "
              f"warm-up): median {med:.2f} ms (min {walls[0]:.2f}, max "
              f"{walls[-1]:.2f}) over {AE_TIMED_STEPS} = "
              f"{bs * 1e3 / med:.2f} images/s; host issue median "
              f"{issues[len(issues) // 2]:.2f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"losses first / last {losses[0]} / {losses[-1]} ({card})",
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
        stats = live_bn_stats(model)
        st_moved = sum(not torch.equal(v, stats0[k]) for k, v in stats.items())
        check(all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                  for v in stats.values()),
              f"{name}: running statistics not finite float32")
        print(f"ae {cfg.NET.BACKBONE}: {moved} of {n_train} trained tensors "
              f"moved, {frozen_same} of {n_frozen} frozen tensors bit-equal, "
              f"{st_moved} of {len(stats)} running statistics moved "
              f"(float32, finite)", flush=True)
        check(frozen_same == n_frozen, f"{name}: a frozen parameter changed")
        check(moved == n_train, f"{name}: a trained parameter did not move")
        check(st_moved == len(stats), f"{name}: a running statistic stayed")

        model.eval()
        batch = batches[-1]
        with torch.no_grad():
            image, raw = normalise_batch_image(batch["image"],
                                               batch["jitter"])
            with torch.autocast("cuda", dtype=model.amp_dtype):
                logits, _ = model._features(image)
            masks = torch.softmax(logits.float(), dim=-1)
            dec_k = pamr(raw, masks, model.pamr_kernel, model.pamr_iter)
            dec_p = pamr_reference(raw, masks, model.pamr_kernel,
                                   model.pamr_iter)
        err = float((dec_k - dec_p).abs().max())
        print(f"ae {cfg.NET.BACKBONE} masks_dec {tuple(dec_k.shape)} kernel "
              f"path vs plain path on the card: max_abs_err {err:.3e} "
              f"(tol 1e-5)", flush=True)
        check(tuple(dec_k.shape) == (bs, 81, 81, 21),
              f"{name}: masks_dec {tuple(dec_k.shape)}")
        check(err <= 1e-5, f"{name} masks_dec kernel vs plain: {err}")
        del model, opt, params, init, batches
        torch.cuda.empty_cache()
    return launches


# the model zoo (ROADMAP A5(b), A5(c)): each spec trained on the backbone
# that tests/test_reference_parity.py pairs it with, at that backbone's
# shipped config; then CAM_CASA_WGAP_v6 on ResNet-101, v5 on VGG16 and
# ae on WRN38
ZOO_TRAIN = [(name, "voc_resnet50.yaml") for name in (
    "bsl", "CAM_SA", "CAM_SA_WGAP", "CAM_WGAP_v3", "CAM_CASA_WGAP_tf_v2",
    "CAM_CASA_WGAP_tf_v4", "CAM_CASA_WGAP_tf_v5", "CAM_CASA_WGAP_tf_v6",
    "CAM_CASA_WGAP_tf_v7", "CAM_CASA_WGAP_tf_v8",
    "CAM_CASA_WGAP_tf_v10")] + [
    (name, "voc_resnet38.yaml") for name in (
        "CAM_CASA", "CAM_CASA_WGAP", "CAM_MF", "CAM_MF_v2",
        "CAM_CASA_WGAP_v2", "CAM_CASA_WGAP_v3", "CAM_CASA_WGAP_v4",
        "CAM_CASA_WGAP_v5", "CAM_CASA_WGAP_v6", "CAM_CASA_WGAP_PCM",
        "CAM_CASA_WGAP_tf_v3", "CAM_CASA_WGAP_tf_v9",
        "CAM_CASA_WGAP_tf_v9_2")] + [
    ("CAM_CASA_WGAP_v6", "voc_resnet101.yaml"),
    ("CAM_CASA_WGAP_v5", "voc_vgg16.yaml"), ("ae", "voc_resnet38.yaml")]
ZOO_WARMUP_STEPS, ZOO_TIMED_STEPS = 2, 2
# served through the fast CRF: the classic-CAM and multi-level models,
# the cross-query talking-heads tf_v9 and the two-window tf_v10
ZOO_SERVE = (("bsl", "voc_resnet50.yaml"), ("CAM_MF", "voc_resnet38.yaml"),
             ("CAM_CASA_WGAP_tf_v9", "voc_resnet38.yaml"),
             ("CAM_CASA_WGAP_tf_v10", "voc_resnet50.yaml"))
# the fast CRF's Q, float32 kernels on the card against the plain
# versions on the CPU, 10 mean-field iterations
CRF_Q_TOL = 1e-4


def pamr_plane_report(raw, masks, card: str,
                      where: str = "the zoo plane") -> None:
    """Both PAMR kernels at one train step's plane against their plain
    versions (rel ``PAMR_REL_TOL``): the guide ``raw`` (B, H, W, 3)
    resized to the masks' (B, h, w, C) plane, dilations 1-24, 10 steps;
    errors, CUDA-event medians, the profiler's kernel time and the
    bound (as ``phase_pamr_kernels`` counts it), printed as ``where``."""
    from wseg_tpu_torch.ops.pamr import _guide
    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_affinity_cm_reference,
        pamr_propagate_cm,
        pamr_propagate_cm_reference,
        pamr_taps,
    )

    b, h, w, c = masks.shape
    im_cm = _guide(raw, masks).permute(0, 3, 1, 2).contiguous()
    m_cm = masks.float().permute(0, 3, 1, 2).contiguous()
    t = len(PAMR_DIL) * 8
    taps9 = [tap for d in PAMR_DIL for tap in pamr_taps((d,)) + [(0, 0)]]
    aff_ref = pamr_affinity_cm_reference(im_cm, PAMR_DIL)
    cases = (
        ("pamr_affinity_cm", pamr_affinity_cm(im_cm, PAMR_DIL), aff_ref,
         lambda: pamr_affinity_cm_reference(im_cm, PAMR_DIL),
         lambda: pamr_affinity_cm(im_cm, PAMR_DIL),
         pamr_affinity_cm.kernel_name, (im_cm.numel() + aff_ref.numel()) * 4,
         b * h * w * (3 * 4 * len(taps9) + 3 * 4 * t + 3 * t)),
        ("pamr_propagate_cm",
         pamr_propagate_cm(aff_ref, m_cm, PAMR_DIL, PAMR_ITER),
         pamr_propagate_cm_reference(aff_ref, m_cm, PAMR_DIL, PAMR_ITER),
         lambda: pamr_propagate_cm_reference(aff_ref, m_cm, PAMR_DIL,
                                             PAMR_ITER),
         lambda: pamr_propagate_cm(aff_ref, m_cm, PAMR_DIL, PAMR_ITER),
         pamr_propagate_cm.kernel_name,
         (aff_ref.numel() + 2 * m_cm.numel()) * 4,
         2 * b * c * PAMR_ITER * t * h * w))
    for name, got, want, plain, kernel, kname, nbytes, flops in cases:
        max_abs = float((got - want).abs().max())
        rel = max_abs / float(want.abs().max())
        check(rel <= PAMR_REL_TOL,
              f"{name} disagrees with plain at {(b, c, h, w)}: rel {rel}")
        p1 = cuda_median_ms(plain, reps=5)
        k1 = cuda_median_ms(kernel, reps=20)
        k2 = cuda_median_ms(kernel, reps=20)
        p2 = cuda_median_ms(plain, reps=5)
        dev = device_ms(kernel, reps=10, match=kname, per_call=1)
        bnd = bound(nbytes, flops)
        print(f"kernel {name} at {where} {(b, c, h, w)}: max_abs_err "
              f"{max_abs:.3e}, rel {rel:.3e} (tol {PAMR_REL_TOL:g}); "
              f"median {k1:.4f} / {k2:.4f} ms per call (CUDA events), "
              f"{dev * 1e3:.2f} us of kernel (profiler, "
              f"{bnd['bound_ms'] / dev:.1%} of the bound); plain median "
              f"{p1:.4f} / {p2:.4f} ms; bound {bnd['bound_ms'] * 1e3:.2f} us "
              f"({bnd['bound_by']}, {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e6:.1f} MFLOP) ({card})", flush=True)


def phase_zoo_train(card: str) -> dict:
    """Train steps of every ``ZOO_TRAIN`` model at full width (its
    config's batch and crop, bfloat16 autocast, seeded weights with the
    residual branches' last convs zeroed, the attention loss at weight
    20 where the head has one); for the PAMR heads the refined masks of
    the kernels against the plain path on the last step's batch, and
    both kernels against their plain versions once per new plane.
    Returns the PAMR launch counts of all steps."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.engine.train_loop import (
        normalise_batch_image,
        train_step,
    )
    from wseg_tpu_torch.engine.trainer import build_train_model
    from wseg_tpu_torch.flagship import load_cfg, synthetic_train_batch
    from wseg_tpu_torch.models.stage_net import _clean_only
    from wseg_tpu_torch.ops.pamr import pamr, pamr_reference
    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_propagate_cm,
    )
    from wseg_tpu_torch.optim import FROZEN, make_optimizer

    launches = {"pamr_affinity_cm": 0, "pamr_propagate_cm": 0}
    planes = {PAMR_SHAPE[:3]}          # timed by phase_pamr_kernels
    for name, cfg_name in ZOO_TRAIN:
        reset_cfg()
        load_cfg(cfg_name)
        cfg.NET.MODEL = name
        tag = f"zoo {name}/{cfg.NET.BACKBONE}"
        crop, bs = int(cfg.DATASET.CROP_SIZE), int(cfg.TRAIN.BATCH_SIZE)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        model = build_train_model(torch.device("cuda"), seed=0)
        spec = model.spec
        opt, labels = make_optimizer(cfg.NET, model)
        params = dict(model.named_parameters())
        init = {n: p.detach().clone() for n, p in params.items()}
        rng = np.random.RandomState(0)
        batches = [synthetic_train_batch(rng, bs, crop)
                   for _ in range(ZOO_WARMUP_STEPS + ZOO_TIMED_STEPS)]
        kw = dict(device_jitter=True, loss_name=str(cfg.NET.LOSS),
                  mask_loss_bce=float(cfg.NET.MASK_LOSS_BCE),
                  attn_loss_weight=20.0 if spec.loss_at else 0.0)
        note = ""
        if spec.labels_with_bg:
            # the loader's (B, C-1) labels fail as in wseg_tpu (ROADMAP
            # C2); the steps take (B, C) labels, background first
            try:
                train_step(model, opt, batches[0], 1.0, **kw)
                refused = ""
            except ValueError as e:
                refused = str(e)
            check("C2" in refused, f"{tag}: (B, C-1) labels not refused")
            for b in batches:
                b["labels"] = torch.cat([torch.ones_like(
                    b["labels"][:, :1]), b["labels"]], dim=1)
            note = "; (B, C-1) labels refused (C2), steps on (B, C)"
        print(f"{tag} train model ({cfg_name}, NET.MODEL {name}): "
              f"{sum(p.numel() for p in params.values())} float32 params, "
              f"autocast {model.amp_dtype}, crop {crop}, batch {bs}, "
              f"attention loss weight {kw['attn_loss_weight']:g}, built in "
              f"{time.perf_counter() - t0:.2f} s{note} ({card})", flush=True)
        per_step = (1, 1) if spec.refine == "pamr" else (0, 0)
        walls, issues, losses = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pamr_affinity_cm.launches = 0
        pamr_propagate_cm.launches = 0
        for i, batch in enumerate(batches):
            before = (pamr_affinity_cm.launches, pamr_propagate_cm.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = train_step(model, opt, batch, 1.0, **kw)
            t_issue = time.perf_counter()
            torch.cuda.synchronize()
            if i >= ZOO_WARMUP_STEPS:
                walls.append((time.perf_counter() - t) * 1e3)
                issues.append((t_issue - t) * 1e3)
            delta = (pamr_affinity_cm.launches - before[0],
                     pamr_propagate_cm.launches - before[1])
            check(delta == per_step, f"{tag} step {i}: PAMR launches {delta}")
            losses.append({k: round(float(v), 5) for k, v in metrics.items()})
        launches["pamr_affinity_cm"] += pamr_affinity_cm.launches
        launches["pamr_propagate_cm"] += pamr_propagate_cm.launches
        check(all(np.isfinite(v) for m in losses for v in m.values()),
              f"{tag}: non-finite losses {losses}")
        check(("loss_at" in losses[0]) == spec.loss_at
              and ("loss_mask" in losses[0]) == bool(spec.refine),
              f"{tag}: losses {sorted(losses[0])}")
        moved = sum(not torch.equal(p.detach(), init[n])
                    for n, p in params.items() if labels[n] != FROZEN)
        n_train = sum(lab != FROZEN for lab in labels.values())
        frozen_same = all(torch.equal(p.detach(), init[n])
                          for n, p in params.items() if labels[n] == FROZEN)
        walls.sort()
        issues.sort()
        print(f"{tag} train steps (after {ZOO_WARMUP_STEPS} warm-up): "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms "
              f"= {bs * 1e3 / walls[0]:.2f} images/s at the best; host "
              f"issue {', '.join(f'{w:.2f}' for w in issues)} ms; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
              f"GiB; {moved} of {n_train} trained tensors moved; losses "
              f"first / last {losses[0]} / {losses[-1]} ({card})",
              flush=True)
        check(frozen_same, f"{tag}: a frozen parameter changed")
        check(moved == n_train, f"{tag}: a trained parameter did not move")
        if spec.refine == "pamr":
            model.eval()
            batch = batches[-1]
            with torch.no_grad():
                image, raw = normalise_batch_image(batch["image"],
                                                   batch["jitter"])
                with torch.autocast("cuda", dtype=model.amp_dtype):
                    logits, _ = model._features(image)
                masks = torch.softmax(logits.float(), dim=-1)
                if spec.clean_before_refine:
                    masks = _clean_only(masks, batch["labels"].float())
                dec_k = pamr(raw, masks, model.pamr_kernel, model.pamr_iter)
                dec_p = pamr_reference(raw, masks, model.pamr_kernel,
                                       model.pamr_iter)
            err = float((dec_k - dec_p).abs().max())
            plane = tuple(masks.shape[:3])
            print(f"{tag} PAMR plane {tuple(masks.shape)}: masks_dec of the "
                  f"kernels vs the plain path max_abs_err {err:.3e} "
                  f"(tol 1e-5)", flush=True)
            check(err <= 1e-5, f"{tag} masks_dec kernel vs plain: {err}")
            if plane not in planes:
                planes.add(plane)
                pamr_plane_report(raw, masks, card)
        del model, opt, params, init, batches
        torch.cuda.empty_cache()
    return launches


def serve_slice(tag: str, cfg_name: str, card: str, model_name: str = "",
                crf_check: bool = False) -> dict:
    """A seeded model (bfloat16) of ``configs/<cfg_name>`` -- ``NET.MODEL``
    set to ``model_name`` where given -- serves the 8 VOC-sized images
    under the config's TEST settings with the fast CRF; checks the label
    maps, finite scores and 12 launches of each CRF kernel per
    postprocess call; with ``crf_check`` also the fast CRF on one image's
    merged map with the kernels against the plain versions (float32,
    card against CPU); returns the CRF kernels' launch counts of the
    served run."""
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.flagship import (
        build_flagship_server,
        load_cfg,
        synthetic_images,
    )
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    kernels = (bilateral_message_cm, gauss_blur_cm)
    reset_cfg()
    src = load_cfg(cfg_name)
    if model_name:
        cfg.NET.MODEL = model_name
    check(cfg.TEST.CRF_MODE == "fast", f"{cfg_name}: not the fast CRF")
    server = build_flagship_server("cuda", seed=0)
    pp = server.postprocess
    pp_calls = [0]
    dispatch_group = pp.dispatch_group

    def counted_dispatch(*args, **kw):
        pp_calls[0] += 1
        return dispatch_group(*args, **kw)

    pp.dispatch_group = counted_dispatch
    images = synthetic_images(VOC_SIZES)
    sigs = {tuple(server.views.view_shapes(w, h)): (w, h)
            for (w, h) in VOC_SIZES}
    print(f"{tag} serving ({src}): {cfg.NET.MODEL}/{cfg.NET.BACKBONE}, "
          f"{next(server.model.parameters()).dtype}, scales "
          f"{list(cfg.TEST.SCALES)}, flip {cfg.TEST.FLIP}, pad "
          f"{list(cfg.TEST.PAD_SIZE)}, BG_POW {cfg.TEST.BG_POW}, view "
          f"shapes {sorted(sigs)[0]} ... ({card})", flush=True)
    try:
        t0 = time.perf_counter()
        for size in sigs.values():
            before = [f.launches for f in kernels]
            server.warmup([size])
            delta = [f.launches - n for f, n in zip(kernels, before)]
            check(delta == [12, 12], f"{tag} warm-up group {size}: {delta}")
        torch.cuda.synchronize()
        print(f"{tag} serving warm-up, one group per size signature: "
              f"{time.perf_counter() - t0:.2f} s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"({card})", flush=True)
        pp_calls[0] = 0
        for f in kernels:
            f.launches = 0
        t0 = time.perf_counter()
        futs = [server.submit(img, lab) for img, lab in images]
        results = [f.result(timeout=600) for f in futs]
        dt = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in kernels}
    finally:
        server.close()
    print(f"{tag} serving: {len(images)} images in {dt:.3f} s = "
          f"{len(images) / dt:.3f} images/s, {pp_calls[0]} postprocess "
          f"calls, launches {launches} ({card})", flush=True)
    check(pp_calls[0] >= len(sigs) and all(
        n == 12 * pp_calls[0] for n in launches.values()),
        f"{tag} serving launches {launches} for {pp_calls[0]} calls")
    check_results(tag, images, results)
    for k, (img, lab) in enumerate(images[:4]):
        total, cls_all, dst, u8 = image_merged_sums(server, img)
        check(bool(torch.isfinite(total).all()) and all(
            bool(torch.isfinite(c).all()) for c in cls_all),
            f"{tag}: non-finite scores for image {k}")
        if crf_check and k == 0:
            crf_on_merged_map(tag, server, total, lab, dst, u8, card)
    del server
    torch.cuda.empty_cache()
    return launches


def crf_on_merged_map(tag, server, total, lab, dst, u8, card,
                      bg_pow=None, hold_q=True) -> None:
    """The fast CRF (float32, the config's strides) on one image's
    cleaned merged map (BG^``bg_pow``, the server's by default): the
    card's run (bilateral-message and blur kernels) against the CPU's
    (their plain versions), max |dQ| <= ``CRF_Q_TOL`` (with ``hold_q``;
    else argmax agreement >= 0.99: near-tied classes let the mean field
    amplify summation order), and the launches of the card's run."""
    import torch

    from wseg_tpu_torch.engine.infer import _postprocess
    from wseg_tpu_torch.ops.crf import crf_inference_torch
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    kw = dict(server.postprocess._kw, n_views=server.views.num_views,
              crf_threshs=(), ret_merged=True)
    if bg_pow is not None:
        kw["bg_pow"] = float(bg_pow)
    labels = torch.from_numpy(lab[None]).to(total.device)
    _, merged = _postprocess(total, labels, dst, u8, **kw)
    h, w = merged.shape[1:3]
    ri = torch.arange(h, device=merged.device)[None, :, None]
    ci = torch.arange(w, device=merged.device)[None, None, :]
    win = dst.long()
    valid = ((ri >= win[:, 0, None, None])
             & (ri < (win[:, 0] + win[:, 2])[:, None, None])
             & (ci >= win[:, 1, None, None])
             & (ci < (win[:, 1] + win[:, 3])[:, None, None]))
    crf_kw = dict(t=CRF_ITERS, dtype=torch.float32,
                  bilateral_stride=int(kw["crf_stride"]),
                  tap_spacing_div=float(kw["crf_tap_div"]),
                  full_stride=int(kw["crf_full_stride"]),
                  refine_iters=int(kw["crf_refine_iters"]))
    before = (bilateral_message_cm.launches, gauss_blur_cm.launches)
    with torch.inference_mode():
        q_card = crf_inference_torch(u8.float(), merged, valid_mask=valid
                                     .float()[..., None], **crf_kw)
        torch.cuda.synchronize()
        n = (bilateral_message_cm.launches - before[0],
             gauss_blur_cm.launches - before[1])
        q_cpu = crf_inference_torch(u8.float().cpu(), merged.cpu(),
                                    valid_mask=valid.float()[..., None]
                                    .cpu(), **crf_kw)
    err = float((q_card.cpu() - q_cpu).abs().max())
    agree = float((q_card.argmax(-1).cpu() == q_cpu.argmax(-1)).float()
                  .mean())
    print(f"{tag} fast CRF on image 0's merged map {tuple(merged.shape)} "
          f"(float32, BG^{kw['bg_pow']:g}): kernels (bilateral, blur "
          f"launches {n}) vs plain on the CPU max |dQ| {err:.3e} "
          f"({f'tol {CRF_Q_TOL:g}' if hold_q else 'not held'}), argmax "
          f"agreement {agree:.5f}{'' if hold_q else ' (>= 0.99)'} ({card})",
          flush=True)
    check(n[0] > 0 and n[1] > 0, f"{tag}: the CRF launched {n}")
    if hold_q:
        check(err <= CRF_Q_TOL, f"{tag}: CRF kernels vs plain |dQ| {err}")
    else:
        check(agree >= 0.99, f"{tag}: CRF kernels vs plain argmax {agree}")


def phase_ae_serve(card: str) -> dict:
    """The ResNet-50 ``ae`` model serves the 8 images under
    ``voc_resnet50.yaml``'s TEST settings (scales 1/0.75/1.25/1.5 +
    flip on the 768 canvas)."""
    from wseg_tpu_torch.config import cfg

    launches = serve_slice("ae", "voc_resnet50.yaml", card)
    check(cfg.NET.MODEL == "ae" and list(cfg.TEST.PAD_SIZE) == [768, 768]
          and list(cfg.TEST.SCALES) == [1, 0.75, 1.25, 1.5],
          "not voc_resnet50's TEST settings")
    return launches


def phase_zoo_serve(card: str) -> dict:
    """The ``ZOO_SERVE`` models (the classic-CAM ``bsl`` and the
    two-window ``tf_v10`` on ResNet-50 under ``voc_resnet50.yaml``, the
    multi-level ``CAM_MF`` and the cross-query talking-heads ``tf_v9`` on
    WRN38 under ``voc_resnet38.yaml``) serve the 8 images through the
    fast CRF, each CRF also held against its plain version on one
    image's merged map; returns the summed launches."""
    total = {}
    for name, cfg_name in ZOO_SERVE:
        got = serve_slice(name, cfg_name, card, model_name=name,
                          crf_check=True)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def entry_journey(tag: str, cfg_name: str, card: str,
                  extra_sets=()) -> None:
    """``wseg_tpu_torch.train`` (one short epoch + validation),
    ``infer_val`` and ``eval_seg`` on ``configs/<cfg_name>`` (with
    ``--set extra_sets``) and a synthetic VOC directory."""
    import contextlib
    import io
    import math

    import torch

    from wseg_tpu_torch import eval_seg, infer_val, train
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.flagship import REPO, write_synthetic_voc

    tmp = tempfile.mkdtemp(prefix="wseg_smoke_entry_")
    try:
        root = write_synthetic_voc(os.path.join(tmp, "data"), n_train=16,
                                   n_val=4)
        common = ["--dataset", "pascal_voc",
                  "--cfg", os.path.join(REPO, "configs", cfg_name),
                  "--exp", "smoke_" + tag, "--run", "r0",
                  "--snapshot-dir", os.path.join(tmp, "snap"),
                  "--logdir", os.path.join(tmp, "logs"), "--workers", "2",
                  "--device", "cuda"]
        sets = ["--set", "DATASET.ROOT", root, "TEST.DATA_ROOT", root,
                "TRAIN.NUM_EPOCHS", "0", "TRAIN.PRETRAIN", "0",
                *extra_sets]
        reset_cfg()
        t0 = time.perf_counter()
        trainer = train.main(common + sets)
        check(trainer.checkpoint.checkpoints,
              f"the {tag} trainer saved nothing")
        suffix = trainer.checkpoint.checkpoints[-1]
        print(f"{tag} entry point: train.main ({cfg_name}), 1 epoch of 16 "
              f"+ validation of 4 synthetic 500x375 images in "
              f"{time.perf_counter() - t0:.2f} s, checkpoint {suffix} "
              f"({card})", flush=True)
        del trainer
        torch.cuda.empty_cache()

        reset_cfg()
        out = os.path.join(tmp, "masks")
        t0 = time.perf_counter()
        infer_val.main(common + ["--resume", suffix, "--infer-list",
                                 os.path.join(root, "val_voc.txt"),
                                 "--mask-output-dir", out] + sets)
        n = {sub: len(os.listdir(os.path.join(out + "_0", sub)))
             for sub in ("no_crf", "crf")}
        check(n == {"no_crf": 4, "crf": 4}, f"{tag} infer_val wrote {n}")
        print(f"{tag} entry point: infer_val loaded {suffix} and wrote {n} "
              f"PNGs at threshold 0.0 in {time.perf_counter() - t0:.2f} s "
              f"({card})", flush=True)

        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            stats = eval_seg.main([
                "--data", root, "--filelist",
                os.path.join(root, "val_voc.txt"),
                "--masks", os.path.join(out + "_0", "crf"),
                "--log-scores", os.path.join(tmp, "scores.log")])
        lines = [ln for ln in text.getvalue().splitlines()
                 if ln.startswith(("# of images", "mIoU"))]
        print(f"{tag} entry point: eval_seg: {' | '.join(lines)}",
              flush=True)
        check(len(lines) == 3 and "# of images: 4" in lines[0]
              and math.isfinite(stats["miou"]),
              f"eval_seg printed {lines}, mIoU {stats['miou']}")
    finally:
        reset_cfg()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_ae_entry(card: str) -> None:
    entry_journey("ae", "voc_resnet50.yaml", card)


def phase_zoo_entry(card: str) -> None:
    """``CAM_CASA_WGAP_v6`` on ``voc_resnet38.yaml`` and the talking-heads
    ``CAM_CASA_WGAP_tf_v7`` on ``voc_resnet50.yaml``."""
    for name, cfg_name in (("CAM_CASA_WGAP_v6", "voc_resnet38.yaml"),
                           ("CAM_CASA_WGAP_tf_v7", "voc_resnet50.yaml")):
        entry_journey(name, cfg_name, card, ("NET.MODEL", name))


SEAM_WARMUP_STEPS, SEAM_TIMED_STEPS = 2, 6
# card (float32, TF32 off) against CPU maps of the Grad-CAM engines on
# the flagship model: GradCAM differentiates the head only; FullGrad the
# whole WRN38, whose ReLU inputs within float32 noise of 0 flip between
# the two devices' sums and move the backbone's bias-site gradients
CAM_IMAGE = (256, 320)
GRADCAM_TOL, FULLGRAD_TOL = 1e-3, 2e-2


def phase_seam_train(card: str) -> dict:
    """Full-width SEAM steps (``engine/seam.seam_train_step``) of the
    flagship trainer's model: ``SEAM_WARMUP_STEPS + SEAM_TIMED_STEPS``
    steps with the mask and ER losses on, then one with ``er_on`` 0;
    two launches of each PAMR kernel a step (the full and the half-scale
    forward), finite losses and ``loss_er`` > 0; then, on the last ER
    step's batch, the refined masks of both scales from the kernels
    against the plain path, and both kernels against their plain
    versions at the half-scale plane; last, one step on a sharpened head
    (``sharpen_head_and_label``) whose mask loss must count.  Returns the
    PAMR launch counts of the first ``SEAM_WARMUP_STEPS +
    SEAM_TIMED_STEPS + 1`` steps."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.engine.seam import seam_train_step
    from wseg_tpu_torch.engine.train_loop import normalise_batch_image
    from wseg_tpu_torch.engine.trainer import build_train_model
    from wseg_tpu_torch.flagship import load_cfg, synthetic_train_batch
    from wseg_tpu_torch.models.stage_net import _clean_only
    from wseg_tpu_torch.ops.pamr import pamr, pamr_reference
    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_propagate_cm,
    )
    from wseg_tpu_torch.ops.resize import resize_bilinear
    from wseg_tpu_torch.optim import make_optimizer

    reset_cfg()
    src = load_cfg("voc_resnet38.yaml")
    crop, bs = int(cfg.DATASET.CROP_SIZE), int(cfg.TRAIN.BATCH_SIZE)
    check(crop == 384 and bs == 8 and cfg.NET.DTYPE == "bfloat16",
          f"not the flagship train config: crop {crop}, batch {bs}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_train_model(torch.device("cuda"), seed=0)
    opt, _ = make_optimizer(cfg.NET, model)
    rng = np.random.RandomState(5)
    n = SEAM_WARMUP_STEPS + SEAM_TIMED_STEPS
    batches = [synthetic_train_batch(rng, bs, crop) for _ in range(n + 1)]
    kw = dict(device_jitter=True, loss_name=str(cfg.NET.LOSS),
              mask_loss_bce=float(cfg.NET.MASK_LOSS_BCE))
    wall, issue, losses = [], [], []
    torch.cuda.synchronize()
    pamr_affinity_cm.launches = 0
    pamr_propagate_cm.launches = 0
    for i, batch in enumerate(batches):
        er_on = 0.0 if i == n else 1.0
        before = (pamr_affinity_cm.launches, pamr_propagate_cm.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = seam_train_step(model, opt, batch, 1.0, er_on, **kw)
        t_issue = time.perf_counter()
        torch.cuda.synchronize()
        if SEAM_WARMUP_STEPS <= i < n:
            wall.append((time.perf_counter() - t) * 1e3)
            issue.append((t_issue - t) * 1e3)
        delta = (pamr_affinity_cm.launches - before[0],
                 pamr_propagate_cm.launches - before[1])
        check(delta == (2, 2), f"SEAM step {i}: PAMR launches {delta}, "
              "expected two of each kernel")
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = {"pamr_affinity_cm": pamr_affinity_cm.launches,
                "pamr_propagate_cm": pamr_propagate_cm.launches}
    check(launches == {"pamr_affinity_cm": 2 * (n + 1),
                       "pamr_propagate_cm": 2 * (n + 1)},
          f"SEAM steps' PAMR launches {launches}")
    check(all(np.isfinite(v) for m in losses for v in m.values()),
          f"non-finite SEAM losses: {losses}")
    check(all(m["loss_er"] > 0 for m in losses),
          f"loss_er not > 0: {[m['loss_er'] for m in losses]}")
    wall.sort()
    issue.sort()
    print(f"SEAM train steps ({src}, batch {bs}, crop {crop} and its 0.5x "
          f"{crop // 2}, mask and ER losses on; after {SEAM_WARMUP_STEPS} "
          f"warm-up): median {wall[len(wall) // 2]:.2f} ms (min "
          f"{wall[0]:.2f}, max {wall[-1]:.2f}) over {SEAM_TIMED_STEPS}, "
          f"host issue median {issue[len(issue) // 2]:.2f} ms; PAMR "
          f"launches {launches} ({card})", flush=True)
    print(f"SEAM losses, first step / last ER step / the er_on 0 step: "
          f"{losses[0]} / {losses[n - 1]} / {losses[n]}", flush=True)

    # the refined masks of both forwards on the last ER step's batch:
    # kernel path vs plain path, then the kernels alone at the half plane
    model.eval()
    batch = batches[n - 1]
    with torch.no_grad():
        image, raw = normalise_batch_image(batch["image"], batch["jitter"])
        for scale in (1.0, 0.5):
            size = (int(crop * scale), int(crop * scale))
            img_s = resize_bilinear(image, size, align_corners=True)
            raw_s = resize_bilinear(raw, size, align_corners=True)
            with torch.autocast("cuda", dtype=model.amp_dtype):
                logits, _ = model._features(img_s)
            masks = _clean_only(torch.softmax(logits.float(), dim=-1),
                                batch["labels"])
            dec_k = pamr(raw_s, masks, model.pamr_kernel, model.pamr_iter)
            dec_p = pamr_reference(raw_s, masks, model.pamr_kernel,
                                   model.pamr_iter)
            err = float((dec_k - dec_p).abs().max())
            print(f"SEAM masks_dec at {scale}x {tuple(masks.shape)} kernel "
                  f"path vs plain path on the card: max_abs_err {err:.3e} "
                  f"(tol 1e-5)", flush=True)
            check(err <= 1e-5, f"SEAM masks_dec at {scale}x: {err}")
        check(tuple(masks.shape) == (bs, crop // 16, crop // 16, 21),
              f"half-scale plane {tuple(masks.shape)}")
        pamr_plane_report(raw_s, masks, card, "the SEAM half-scale plane")
    model.train()

    batch = synthetic_train_batch(rng, bs, crop)
    batch["labels"], n_counted = sharpen_head_and_label(model, batch)
    before = (pamr_affinity_cm.launches, pamr_propagate_cm.launches)
    metrics = {k: float(v) for k, v in seam_train_step(
        model, opt, batch, 1.0, 1.0, **kw).items()}
    delta = (pamr_affinity_cm.launches - before[0],
             pamr_propagate_cm.launches - before[1])
    print(f"SEAM mask-loss step: {n_counted} of {bs} images hold background "
          f"+ their labels in the pseudo-GT; losses {metrics}", flush=True)
    check(delta == (2, 2), f"SEAM mask-loss step: PAMR launches {delta}")
    check(n_counted > 0 and metrics["loss_mask"] > 0
          and metrics["loss_er"] > 0
          and all(np.isfinite(v) for v in metrics.values()),
          f"the refined masks did not reach the SEAM loss: {metrics}")
    del model, opt, batches
    torch.cuda.empty_cache()
    return launches


def phase_seam_entry(card: str):
    """``wseg_tpu_torch.train_SEAM.main``: validation first, then one
    epoch of 16 synthetic 500x375 images, on the flagship config; the
    checkpoint it saves.  Returns (temporary directory, VOC root, the
    entry points' common flags and ``--set`` list, snapshot directory,
    checkpoint suffix) for ``phase_cam_entry``, which removes the
    directory."""
    import torch

    from wseg_tpu_torch import train_SEAM
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.flagship import FLAGSHIP_CFG, write_synthetic_voc
    from wseg_tpu_torch.utils.checkpoints import model_file

    tmp = tempfile.mkdtemp(prefix="wseg_smoke_seam_")
    try:
        root = write_synthetic_voc(os.path.join(tmp, "data"), n_train=16,
                                   n_val=4)
        common = ["--dataset", "pascal_voc", "--cfg", FLAGSHIP_CFG,
                  "--exp", "smoke_seam", "--run", "r0",
                  "--snapshot-dir", os.path.join(tmp, "snap"),
                  "--logdir", os.path.join(tmp, "logs"), "--workers", "2",
                  "--device", "cuda"]
        sets = ["--set", "DATASET.ROOT", root, "TEST.DATA_ROOT", root,
                "TRAIN.NUM_EPOCHS", "0", "TRAIN.PRETRAIN", "0"]
        reset_cfg()
        t0 = time.perf_counter()
        trainer = train_SEAM.main(common + sets)
        dt = time.perf_counter() - t0
        check(trainer.checkpoint.checkpoints, "train_SEAM saved nothing")
        suffix = trainer.checkpoint.checkpoints[-1]
        check(os.path.isfile(model_file(trainer.args.snapshot_dir, suffix)),
              f"no checkpoint file for {suffix}")
        print(f"entry point: train_SEAM.main, validation of 4 then 1 SEAM "
              f"epoch of 16 synthetic 500x375 images in {dt:.2f} s, "
              f"checkpoint {suffix} ({card})", flush=True)
        snap = trainer.args.snapshot_dir
        del trainer
        torch.cuda.empty_cache()
        return tmp, root, common, sets, snap, suffix
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def phase_cam_entry(card: str, seam) -> None:
    """On ``phase_seam_entry``'s checkpoint: ``infer_cam.main`` with
    GradCAM on its 4 validation images (the PNG counts); one GradCAM and
    one FullGrad map of the float32 model on the card against the same on
    the CPU; ``cam.main`` on one image (three JPEGs)."""
    import numpy as np
    import torch
    from PIL import Image

    from wseg_tpu_torch import cam, infer_cam
    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.data.pascal_voc import MEAN, STD
    from wseg_tpu_torch.flagship import load_cfg
    from wseg_tpu_torch.gradcam import FullGrad, GradCAM
    from wseg_tpu_torch.infer_val import _find_snapshot
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.utils.convert import load_checkpoint

    tmp, root, common, sets, snap, suffix = seam
    cwd = os.getcwd()
    try:
        reset_cfg()
        out = os.path.join(tmp, "cam_masks")
        t0 = time.perf_counter()
        infer_cam.main(common + [
            "--resume", suffix, "--method", "gradcam", "--infer-list",
            os.path.join(root, "val_voc.txt"), "--mask-output-dir", out]
            + sets)
        n = {sub: len(os.listdir(os.path.join(out, sub)))
             for sub in ("no_crf", "vis")}
        check(n == {"no_crf": 4, "vis": 4}, f"infer_cam wrote {n}")
        print(f"entry point: infer_cam --method gradcam loaded {suffix} and "
              f"wrote {n} PNGs in {time.perf_counter() - t0:.2f} s ({card})",
              flush=True)

        # float32 maps of the checkpoint, card against CPU
        reset_cfg()
        load_cfg("voc_resnet38.yaml")
        cfg.NET.DTYPE = "float32"
        path = _find_snapshot(suffix, snap)
        check(path, f"no snapshot {suffix} under {snap}")
        with Image.open(os.path.join(root, "JPEGImages",
                                     "syn0016.jpg")) as im:
            arr = np.asarray(im.convert("RGB"), np.float32)[
                :CAM_IMAGE[0], :CAM_IMAGE[1]] / 255.0
        x = ((arr - np.asarray(MEAN, np.float32))
             / np.asarray(STD, np.float32))[None]
        maps = {}
        for dev in ("cuda", "cpu"):
            model = get_model(cfg.NET, num_classes=21)
            load_checkpoint(model, path)
            model = model.to(dev)
            t0 = time.perf_counter()
            maps[dev] = {"gradcam": GradCAM(model)(x, 0),
                         "fullgrad": FullGrad(model)(x, 0)}
            print(f"GradCAM + FullGrad maps on {dev} (float32, "
                  f"{CAM_IMAGE[0]}x{CAM_IMAGE[1]}): "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            del model
        torch.cuda.empty_cache()
        for name, tol in (("gradcam", GRADCAM_TOL),
                          ("fullgrad", FULLGRAD_TOL)):
            a, b = maps["cuda"][name], maps["cpu"][name]
            err = float(np.abs(a - b).max())
            print(f"{name} map, card vs CPU (float32): max_abs_err "
                  f"{err:.3e}, mean {float(np.abs(a - b).mean()):.3e} (tol "
                  f"{tol:g}); card map in [{a.min():.3f}, {a.max():.3f}] "
                  f"({card})", flush=True)
            check(a.shape == (1,) + CAM_IMAGE and np.isfinite(a).all()
                  and err <= tol, f"{name} card vs CPU: {err}")

        reset_cfg()
        work = os.path.join(tmp, "cam_demo")
        os.makedirs(work)
        os.chdir(work)
        t0 = time.perf_counter()
        target = cam.main(common + [
            "--resume", suffix, "--image-path",
            os.path.join(root, "JPEGImages", "syn0016.jpg")] + sets)
        files = sorted(os.listdir(work))
        check(files == ["gradcam_cam.jpg", "gradcam_cam_gb.jpg",
                        "gradcam_gb.jpg"], f"cam wrote {files}")
        print(f"entry point: cam (target {target}, the argmax) wrote "
              f"{files} in {time.perf_counter() - t0:.2f} s ({card})",
              flush=True)
    finally:
        os.chdir(cwd)
        reset_cfg()
        shutil.rmtree(tmp, ignore_errors=True)


# ---- int8 serving (NET.DTYPE int8) -----------------------------------

# the card's dense int8 tensor-core peak (H100 SXM data sheet)
INT8_OPS = 1979e12
# phase_qconv's bucket: the flagship's scale-1.0 views of a 500x375
# image, 8 slots with flip, as a served group runs them
# global batch, crop and steps of the data-parallel phase (the flagship
# trainer's); two ranks against one process (float32): each tensor's
# update within a share of its largest update, plus two float32
# spacings, that is the larger of DDP_REL_TOL and DDP_NOISE_FACTOR times
# what that update moves in one process when the batch's halves are
# swapped (the same function summed in another order: the ranks'
# batch-4 convs also sum otherwise than the batch-8 ones; the residual
# branches' zeroed last convs get updates of ~2e-6 that the swap alone
# moves by ~100%)
DDP_BATCH, DDP_CROP, DDP_STEPS = 8, 384, 2
DDP_REL_TOL = 1e-3
DDP_NOISE_FACTOR = 2.0
DDP_TIMEOUT_S = 600


def ddp_steps(batches, dtype: str, seed: int = 0):
    """``DDP_STEPS`` train steps of the flagship trainer's model (float32
    parameters, ``NET.DTYPE`` ``dtype``) on this process's rows of each
    global batch (``parallel.dist.rank_rows``; all of them without a
    group).  Returns (model, each parameter's update, metrics, LR
    labels, the float32 spacing of each parameter's largest start
    value)."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.engine.train_loop import train_step
    from wseg_tpu_torch.engine.trainer import build_train_model
    from wseg_tpu_torch.flagship import load_cfg
    from wseg_tpu_torch.optim import make_optimizer
    from wseg_tpu_torch.parallel import dist

    reset_cfg()
    load_cfg("voc_resnet38.yaml")
    cfg.NET.DTYPE = dtype
    model = build_train_model(
        torch.device("cuda", torch.cuda.current_device()), seed)
    opt, labels = make_optimizer(cfg.NET, model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    kw = dict(device_jitter=True, loss_name=str(cfg.NET.LOSS),
              mask_loss_bce=float(cfg.NET.MASK_LOSS_BCE))
    metrics = []
    for batch in batches:
        rows = {k: dist.rank_rows(v) for k, v in batch.items()}
        metrics.append({k: float(v) for k, v in
                        train_step(model, opt, rows, 1.0, **kw).items()})
    with torch.no_grad():
        deltas = {n: p - before[n] for n, p in model.named_parameters()}
        ulp = {n: float(np.spacing(b.abs().max().cpu().numpy()))
               for n, b in before.items()}
    return model, deltas, metrics, labels, ulp


def update_gaps(got, want, labels, ulp) -> dict:
    """{name: max(|got - want| - 2 spacings) / max |want|} over the
    trained tensors' updates; fails if a frozen tensor moved or a
    trained one did not."""
    from wseg_tpu_torch.optim import FROZEN

    gaps = {}
    for name, d1 in want.items():
        d2 = got[name]
        scale = float(d1.abs().max())
        if labels[name] == FROZEN:
            check(scale == 0 and float(d2.abs().max()) == 0,
                  f"frozen {name} moved")
            continue
        check(scale > 0, f"trained {name} did not move")
        gaps[name] = float(((d2 - d1).abs() - 2 * ulp[name]).max()) / scale
    return gaps


def ddp_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the phase's ``gloo`` group on card 0: the float32
    steps on its rows of ``tmp/batches.pt``; rank 0 saves its updates
    and metrics, rank 1 its metrics and whether its parameters equal
    rank 0's bit for bit (``tmp/rank<r>.pt``)."""
    import torch

    from wseg_tpu_torch.parallel import dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init(rank, world, "gloo", device="cuda:0",
              init_method="file://" + os.path.join(tmp, "rendezvous"))
    try:
        batches = [{k: v.cuda() for k, v in b.items()} for b in torch.load(
            os.path.join(tmp, "batches.pt"), weights_only=True)]
        model, deltas, metrics, _, _ = ddp_steps(batches, "float32")
        res = {"metrics": metrics}
        same = True
        for p in model.parameters():
            t = p.detach().clone()
            torch.distributed.broadcast(t, src=0)
            same = same and torch.equal(t, p.detach())
        if rank == 0:
            res["deltas"] = {n: d.cpu() for n, d in deltas.items()}
        else:
            res["same_as_rank0"] = same
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy()


def start_torchrun(module: str, argv, log: str):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1
    -m -- <module> <argv>`` from the repository root, its output into
    ``log``; returns (process, log file).  The ``--`` keeps torchrun's
    parser off the module's flags (Python 3.12.3's argparse reads
    ``--run`` as an abbreviation of torchrun's ``--run-path``)."""
    from wseg_tpu_torch.flagship import REPO

    out = open(log, "w")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "--", module, *argv],
        cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, out


def finish_torchrun(proc, out, log: str, what: str) -> str:
    """Wait for a ``start_torchrun`` process; fails (with the end of its
    output) unless it exits with 0.  Returns its output."""
    try:
        code = proc.wait(DDP_TIMEOUT_S)
    finally:
        out.close()
    with open(log) as f:
        text = f.read()
    check(code == 0, f"torchrun {what} exited with {code}:\n{text[-4000:]}")
    return text


def phase_ddp(card: str) -> dict:
    """Data parallelism (``wseg_tpu_torch/parallel``) on the one card.

    In this process, ``DDP_STEPS`` flagship steps (bfloat16 autocast,
    crop 384, batch 8) without a group, and both PAMR kernels against
    their plain versions at the per-rank planes of that global batch
    ((4, C, 48, 48) at 2 ranks, (1, C, 48, 48) at 8), timed alone.  Then
    at once: ``torchrun --standalone --nproc_per_node 1`` (NCCL) running
    ``wseg_tpu_torch.train`` (one epoch of 16 synthetic images +
    validation) and ``wseg_tpu_torch.infer_val`` (seeded weights); two
    ``gloo`` ranks (spawned, both on card 0, CUDA tensors) each taking 4
    rows of every global batch of 8 (float32); and here the same
    bfloat16 steps in an NCCL group of one, which must be bit-equal to
    those without a group (cuDNN deterministic for both), and one
    process on the whole float32 batch, against which the two ranks are
    held (``DDP_REL_TOL``, ``DDP_NOISE_FACTOR``).  Returns the PAMR
    launch counts of the group-of-one steps."""
    import multiprocessing

    import numpy as np
    import torch

    from wseg_tpu_torch.engine.train_loop import normalise_batch_image
    from wseg_tpu_torch.flagship import (
        FLAGSHIP_CFG,
        synthetic_train_batch,
        write_synthetic_voc,
    )
    from wseg_tpu_torch.models.stage_net import _clean_only
    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_propagate_cm,
    )
    from wseg_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    tmp = tempfile.mkdtemp(prefix="wseg_smoke_ddp_")
    procs, runs = [], []
    try:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        rng = np.random.RandomState(7)
        batches = [synthetic_train_batch(rng, DDP_BATCH, DDP_CROP)
                   for _ in range(DDP_STEPS)]
        torch.save([{k: v.cpu() for k, v in b.items()} for b in batches],
                   os.path.join(tmp, "batches.pt"))
        model, alone, m_alone, _, _ = ddp_steps(batches, "bfloat16")

        # the per-rank PAMR planes, timed with nothing else on the card
        model.eval()
        with torch.no_grad():
            image, raw = normalise_batch_image(batches[0]["image"],
                                               batches[0]["jitter"])
            with torch.autocast("cuda", dtype=model.amp_dtype):
                logits, _ = model._features(image)
            masks = _clean_only(torch.softmax(logits.float(), dim=-1),
                                batches[0]["labels"])
        del model
        for world in (2, 8):
            rows = DDP_BATCH // world
            pamr_plane_report(raw[:rows].contiguous(),
                              masks[:rows].contiguous(), card,
                              f"rank 0's plane of {world} ranks")
        del image, raw, masks, logits
        torch.cuda.empty_cache()

        # the entry points under torchrun and the gloo ranks, at once
        t0 = time.perf_counter()
        root = write_synthetic_voc(os.path.join(tmp, "data"), n_train=16,
                                   n_val=4)
        common = ["--dataset", "pascal_voc", "--cfg", FLAGSHIP_CFG,
                  "--exp", "smoke_ddp", "--run", "r0",
                  "--snapshot-dir", os.path.join(tmp, "snap"),
                  "--logdir", os.path.join(tmp, "logs"), "--workers", "2",
                  "--device", "cuda", "--set", "DATASET.ROOT", root,
                  "TEST.DATA_ROOT", root, "TRAIN.NUM_EPOCHS", "0",
                  "TRAIN.PRETRAIN", "0"]
        masks_out = os.path.join(tmp, "masks")
        logs = {what: os.path.join(tmp, what + ".log")
                for what in ("train", "infer_val")}
        runs.append(start_torchrun("wseg_tpu_torch.train", common,
                                   logs["train"]))
        runs.append(start_torchrun(
            "wseg_tpu_torch.infer_val",
            common + ["--infer-list", os.path.join(root, "val_voc.txt"),
                      "--mask-output-dir", masks_out], logs["infer_val"]))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=ddp_rank, args=(r, 2, tmp))
                 for r in range(2)]
        for p in procs:
            p.start()

        # an NCCL group of one: bit for bit the steps without a group
        pamr_affinity_cm.launches = 0
        pamr_propagate_cm.launches = 0
        dist.init(0, 1, "nccl", device="cuda:0",
                  init_method="file://" + os.path.join(tmp, "nccl1"))
        try:
            check(dist.world_size() == 1
                  and torch.distributed.get_backend() == "nccl",
                  "no NCCL group of one")
            _, grouped, m_grouped, _, _ = ddp_steps(batches, "bfloat16")
        finally:
            dist.destroy()
        launches = {"pamr_affinity_cm": pamr_affinity_cm.launches,
                    "pamr_propagate_cm": pamr_propagate_cm.launches}
        check(launches == {"pamr_affinity_cm": DDP_STEPS,
                           "pamr_propagate_cm": DDP_STEPS},
              f"NCCL group of one: PAMR launches {launches}")
        unequal = [n for n, d in alone.items()
                   if not torch.equal(grouped[n], d)]
        print(f"DDP: {DDP_STEPS} flagship steps (bfloat16, batch "
              f"{DDP_BATCH}, crop {DDP_CROP}) in an NCCL group of one vs "
              f"no group: {len(alone) - len(unequal)} of {len(alone)} "
              f"parameter updates bit-equal, metrics equal "
              f"{m_grouped == m_alone}; losses {m_grouped[-1]}; PAMR "
              f"launches {launches} ({card})", flush=True)
        check(not unequal and m_grouped == m_alone,
              f"NCCL group of one differs from no group: {unequal[:5]}, "
              f"{m_grouped} vs {m_alone}")
        del alone, grouped

        # two gloo ranks against one process on the whole batch
        _, solo, m_solo, labels, ulp = ddp_steps(batches, "float32")
        # the yardstick: one process on the same batches with their
        # halves swapped (the same function, summed in another order)
        half = DDP_BATCH // 2
        _, swapped, _, _, _ = ddp_steps(
            [{k: torch.cat([v[half:], v[:half]]) for k, v in b.items()}
             for b in batches], "float32")
        for p in procs:
            p.join(DDP_TIMEOUT_S)
        codes = [p.exitcode for p in procs]
        check(codes == [0, 0], f"gloo ranks exited with {codes}")
        r0, r1 = (torch.load(os.path.join(tmp, f"rank{r}.pt"),
                             weights_only=True) for r in range(2))
        check(r1["same_as_rank0"], "rank 1's parameters differ from rank 0's")
        two = {n: d.cuda() for n, d in r0["deltas"].items()}
        gap_ranks = update_gaps(two, solo, labels, ulp)
        gap_swap = update_gaps(swapped, solo, labels, ulp)
        tol = {n: max(DDP_REL_TOL, DDP_NOISE_FACTOR * g)
               for n, g in gap_swap.items()}
        over = [n for n, g in gap_ranks.items() if g > tol[n]]
        worst = sorted(gap_ranks, key=gap_ranks.get, reverse=True)[:3]
        rel_metrics = max(abs(m2[k] - m1[k]) / max(1.0, abs(m1[k]))
                          for res in (r0, r1)
                          for m2, m1 in zip(res["metrics"], m_solo)
                          for k in m1)
        print(f"DDP: 2 gloo ranks on card 0 (4 rows each of every batch of "
              f"{DDP_BATCH}, float32, crop {DDP_CROP}, {DDP_STEPS} steps) "
              f"vs one process on the batch, {len(gap_ranks)} trained "
              f"tensors: update difference beyond 2 float32 spacings, as a "
              f"share of the tensor's largest update (tol: the larger of "
              f"{DDP_REL_TOL:g} and {DDP_NOISE_FACTOR:g}x the one process's "
              f"own with the batch's halves swapped), worst three "
              + ", ".join(f"{n} {gap_ranks[n]:.3e} (swapped {gap_swap[n]:.3e}"
                          f", largest update {float(solo[n].abs().max()):.3e})"
                          for n in worst)
              + f"; {len(over)} over; metrics within {rel_metrics:.3e} (tol "
              f"1e-4); rank 1 bit-equal to rank 0; losses {m_solo[-1]} "
              f"({card})", flush=True)
        check(not over and rel_metrics <= 1e-4,
              f"two ranks vs one process: updates of {over}, metrics "
              f"{rel_metrics}")

        train_out = finish_torchrun(*runs[0], logs["train"], "train")
        snap = os.path.join(tmp, "snap", "pascal_voc", "smoke_ddp", "r0")
        saved = sorted(f for f in os.listdir(snap)
                       if f.startswith("model_enc_"))
        check(saved and "mAP:" in train_out and "Im/Sec" in train_out,
              f"torchrun train saved {saved}:\n{train_out[-2000:]}")
        finish_torchrun(*runs[1], logs["infer_val"], "infer_val")
        runs.clear()
        n = {sub: len(os.listdir(os.path.join(masks_out + "_0", sub)))
             for sub in ("no_crf", "crf")}
        check(n == {"no_crf": 4, "crf": 4}, f"torchrun infer_val wrote {n}")
        print(f"DDP entry points: torchrun --nproc_per_node 1 (NCCL) "
              f"wseg_tpu_torch.train (1 epoch of 16 + validation of 4, "
              f"checkpoint {saved[-1]}) and wseg_tpu_torch.infer_val "
              f"(seeded weights, {n} PNGs at threshold 0.0), beside the "
              f"gloo ranks and this process's steps: "
              f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        for proc, out in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


QCONV_IMAGE = (500, 375)
QCONV_SLOTS = 8
# (name, B, cin, H, W, cout, k, stride, dilation, bias) beside the
# flagship's convs: VGG16's fc6 at the ae config's 1.0 view (biased,
# dilation 12, as the LargeFOV fc6) and a ResNet-50 stride-2 3x3
# (layer2.0.conv2 at the same view)
QCONV_EXTRA = (("vgg16.fc6_d12", 8, 512, 48, 64, 1024, 3, 1, 12, True),
               ("resnet50.layer2.0.conv2", 8, 128, 192, 256, 128, 3, 2, 1,
                False))


def touched(n: int, k: int, stride: int, pad: int, dil: int,
            out: int) -> int:
    """Input rows (or columns) of n that a conv's taps read."""
    return len({o * stride - pad + t * dil for o in range(out)
                for t in range(k)} & set(range(n)))


def conv_bound(b, cin, cp, h, w, cout, k, ho, wo, stride=1, pad=0,
               dil=1) -> dict:
    """The least time of one w8a8 conv on the card: its int8 operations
    (true input channels) at the int8 peak, or the xq pixels its taps
    read, wq and the bf16 output moved once at the HBM rate (ms each,
    and the operations)."""
    ops = 2.0 * b * ho * wo * cout * k * k * cin
    pixels = (touched(h, k, stride, pad, dil, ho)
              * touched(w, k, stride, pad, dil, wo))
    nbytes = b * pixels * cp + cout * k * k * cp + 2 * b * ho * wo * cout
    return {"t_ops": ops / INT8_OPS * 1e3,
            "t_bytes": nbytes / HBM_BYTES_PER_S * 1e3, "ops": ops}


def flagship_conv_inputs(model, x):
    """[(QuantConv, its bf16 input)] of one forward of ``model`` on x."""
    import torch

    from wseg_tpu_torch.models.backbones.common import QuantConv

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args[0])))
        for m in model.modules() if isinstance(m, QuantConv)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return calls


def qconv_case(tag, x, weight, bias, stride, pad, dil, count, card) -> dict:
    """``quantize_act`` (dynamic and static) and ``qconv_s8`` against
    their plain versions on one conv's input: xq and sx equal, int32
    sums and bf16 outputs bit-equal; the dynamic mode's times (kernels,
    plain, ``F.unfold`` + ``torch._int_mm``, the bf16 cuDNN conv) and
    bounds."""
    import torch
    import torch.nn.functional as F

    from wseg_tpu_torch.ops import qconv as Q

    b, cin, h, w = x.shape
    cout, _, k, _ = weight.shape
    cp = Q.padded_channels(cin)
    for static in (False, True):
        sc = (Q.amax_scale(x.float().abs().amax(dim=(0, 2, 3)) * 0.9)
              if static else None)
        wq, sw = Q.quantize_weight(weight, sc)
        xq, sx = Q.quantize_act(x, sc)
        rxq, rsx = Q.quantize_act_reference(x, sc)
        check(torch.equal(xq, rxq) and (sx is None) == (rsx is None)
              and (sx is None or torch.equal(sx, rsx)),
              f"{tag}: quantize_act differs from plain (static {static})")
        acc = Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil,
                         acc_only=True)
        racc = Q.qconv_acc_reference(xq, wq, stride, pad, dil)
        check(torch.equal(acc, racc), f"{tag}: int32 sums differ from plain "
              f"(static {static}): max |d| "
              f"{(acc.long() - racc.long()).abs().max().item()}")
        y = Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil)
        ry = Q.dequantize_reference(racc, sx, sw, bias)
        check(torch.equal(y, ry), f"{tag}: bf16 output differs from plain "
              f"(static {static})")
    # the served (dynamic) mode's times; static mode's quantize is the
    # same pass without the |x| max and its wait, so the two split the
    # dynamic launch
    wq, sw = Q.quantize_weight(weight)
    xq, sx = Q.quantize_act(x)
    acc = Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil, acc_only=True)
    ho, wo = acc.shape[2], acc.shape[3]
    plan = Q.qconv_plan(h, w, cp, cout, k, k, stride, pad, dil)
    sc1 = Q.amax_scale(x.float().abs().amax(dim=(0, 2, 3)))
    # call times (CUDA events: the wrapper's host work shows where a call
    # is shorter than it) and the kernels' own device times (profiler,
    # one window for the three: the quantize kernel's first template
    # argument tells its dynamic launch from its static one)
    q_call = cuda_median_ms(lambda: Q.quantize_act(x), reps=20)
    q_plain = cuda_median_ms(lambda: Q.quantize_act_reference(x), reps=3)
    c_call = cuda_median_ms(
        lambda: Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil), reps=20)

    def three():
        Q.quantize_act(x)
        Q.quantize_act(x, sc1)
        Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil)

    q_ms, q_static, c_ms = device_ms_each(
        three, reps=20, matches=(Q.quantize_act.kernel_name + "<true",
                                 Q.quantize_act.kernel_name + "<false",
                                 Q.qconv_s8.kernel_name))
    c_plain = cuda_median_ms(
        lambda: Q.qconv_s8_reference(xq, wq, sx, sw, bias, stride, pad, dil),
        reps=2, warmup=1)
    xh = xq.permute(0, 3, 1, 2)
    wl = wq.permute(0, 3, 1, 2).reshape(cout, cp * k * k).t()

    def library():
        cols = F.unfold(xh.to(torch.float16), k, dilation=dil, padding=pad,
                        stride=stride)
        a = cols.transpose(1, 2).reshape(-1, cp * k * k).to(torch.int8)
        return torch._int_mm(a, wl)

    lib_ms = None
    try:
        lib = library().reshape(b, ho, wo, cout).permute(0, 3, 1, 2)
        check(torch.equal(lib, acc), f"{tag}: unfold + _int_mm differs")
        lib_ms = cuda_median_ms(library, reps=5)
    except RuntimeError as e:  # a shape _int_mm refuses
        print(f"  {tag}: no library yardstick: {e}", flush=True)
    wb = weight.to(torch.bfloat16)
    bb = None if bias is None else bias.to(torch.bfloat16)
    cudnn_ms = cuda_median_ms(
        lambda: F.conv2d(x, wb, bb, stride, pad, dil), reps=20)
    # bf16 x read once, xq written once
    q_bound = (2 * x.numel() + xq.numel()) / HBM_BYTES_PER_S * 1e3
    cb = conv_bound(b, cin, cp, h, w, cout, k, ho, wo, stride, pad, dil)
    c_bound = max(cb["t_ops"], cb["t_bytes"])
    c_by = "operations" if cb["t_ops"] >= cb["t_bytes"] else "bytes"
    print(f"qconv {tag} x{count}: ({b}, {cin}, {h}, {w}) -> {cout}, k{k} "
          f"s{stride} d{dil}{' +bias' if bias is not None else ''}: xq, sx "
          f"equal, int32 and bf16 bit-equal (dynamic and static); "
          f"quantize_act kernel {q_ms:.4f} ms = {q_bound / q_ms:.1%} of "
          f"its bound (static pass alone {q_static:.4f}; call {q_call:.4f}; "
          f"plain {q_plain:.4f}, bound {q_bound:.4f}); qconv_s8 kernel "
          f"{c_ms:.4f} ms = {cb['ops'] / c_ms / 1e9:.1f} TOPS = "
          f"{c_bound / c_ms:.1%} of its bound (call {c_call:.4f}; plan bn "
          f"{plan.bn} bk {plan.bk} patch {plan.mh}x{plan.mw} stages "
          f"{plan.stages}; plain {c_plain:.3f}, bound {c_bound:.4f} {c_by}, "
          f"unfold + _int_mm {'n/a' if lib_ms is None else f'{lib_ms:.4f}'}"
          f", bf16 cuDNN {cudnn_ms:.4f}) ({card})", flush=True)
    return {"count": count, "q_ms": q_ms, "q_static": q_static,
            "q_call": q_call, "c_call": c_call, "q_plain": q_plain,
            "q_bound": q_bound, "c_ms": c_ms, "c_plain": c_plain,
            "c_bound": c_bound, "c_ops": cb["ops"], "t_ops": cb["t_ops"],
            "t_bytes": cb["t_bytes"], "lib_ms": lib_ms,
            "cudnn_ms": cudnn_ms}


def phase_qconv(card: str) -> list:
    """``quantize_act`` and ``qconv_s8`` against their plain versions at
    every distinct conv of the flagship's int8 serving forward on one
    bucket (the scale-1.0 views of a 500x375 image, 8 slots with flip:
    the inputs the seeded model computes from a synthetic image), and at
    ``QCONV_EXTRA``; returns the two kernels' entries (times and bounds
    summed over one such forward's convs, each distinct conv times its
    count), without launches."""
    import numpy as np
    import torch

    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.data.multiscale import MultiscaleViews
    from wseg_tpu_torch.flagship import (
        build_flagship_server,
        load_cfg,
        synthetic_images,
    )

    reset_cfg()
    load_cfg("voc_resnet38.yaml")
    cfg.NET.DTYPE = "int8"
    server = build_flagship_server("cuda", seed=0)
    server.close()
    model = server.model
    img, _ = synthetic_images([QCONV_IMAGE])[0]
    views = MultiscaleViews(cfg.TEST.SCALES, bool(cfg.TEST.FLIP),
                            cfg.TEST.PAD_SIZE, bool(cfg.TEST.PAD_PER_SCALE),
                            int(cfg.TEST.PAD_ALIGN))
    vs, _, _ = views.build(img)
    x = torch.from_numpy(np.stack(vs[:2] * QCONV_SLOTS)).cuda()
    calls = flagship_conv_inputs(model, x)
    distinct = {}
    for mod, inp in calls:
        if not mod.quantized:
            continue
        key = (tuple(inp.shape), mod.out_channels, mod.kernel_size[0],
               mod.stride[0], mod.dilation[0], mod.bias is not None)
        if key in distinct:
            distinct[key][2] += 1
        else:
            distinct[key] = [mod, inp, 1]
    print(f"qconv: flagship int8 forward on {tuple(x.shape)} views: "
          f"{len(calls)} convs ({sum(m.quantized for m, _ in calls)} "
          f"quantized), {len(distinct)} distinct ({card})", flush=True)
    rows = []
    for key, (mod, inp, count) in distinct.items():
        name = next(n for n, m in model.named_modules() if m is mod)
        rows.append(qconv_case(name, inp, mod.weight.detach(),
                               None if mod.bias is None
                               else mod.bias.detach(), mod.stride[0],
                               mod.padding[0], mod.dilation[0], count,
                               card))
    del calls, distinct, model, server, x
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for tag, b, cin, h, w, cout, k, s, d, bias in QCONV_EXTRA:
        xe = torch.relu(torch.randn((b, cin, h, w), generator=gen,
                                    device="cuda")).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        we = torch.randn((cout, cin, k, k), generator=gen,
                         device="cuda") * (2.0 / (cin * k * k)) ** 0.5
        be = (torch.randn((cout,), generator=gen, device="cuda") * 0.1
              if bias else None)
        qconv_case(tag, xe, we, be, s, (k - 1) // 2 * d, d, 0, card)
    reset_cfg()

    def total(key):
        return sum(r[key] * r["count"] for r in rows)

    lib = (None if any(r["lib_ms"] is None for r in rows)
           else total("lib_ms"))
    n = sum(r["count"] for r in rows)
    c_by = "operations" if total("t_ops") >= total("t_bytes") else "bytes"
    print(f"qconv: one flagship bucket forward ({n} quantized convs): "
          f"quantize_act kernel {total('q_ms'):.3f} ms = "
          f"{total('q_bound') / total('q_ms'):.1%} of its bound (the "
          f"static pass alone {total('q_static'):.3f}, so the |x| max and "
          f"its wait {total('q_ms') - total('q_static'):.3f}; calls "
          f"{total('q_call'):.3f}; plain {total('q_plain'):.3f}, bound "
          f"{total('q_bound'):.3f}); qconv_s8 kernel {total('c_ms'):.3f} "
          f"ms = {total('c_ops') / total('c_ms') / 1e9:.1f} TOPS = "
          f"{total('c_bound') / total('c_ms'):.1%} of its bound (calls "
          f"{total('c_call'):.3f}; plain {total('c_plain'):.3f}, bound "
          f"{total('c_bound'):.3f}, unfold + _int_mm {lib}, bf16 cuDNN "
          f"convs {total('cudnn_ms'):.3f}) ({card})", flush=True)
    source = "wseg_tpu_torch/csrc/qconv.cu"
    return [{"name": "quantize_act", "route": "cuda", "source": source,
             "replaces": "wseg_tpu/models/backbones/common.py:173",
             "max_abs_err": 0.0, "ms": total("q_ms"),
             "plain_ms": total("q_plain"), "bound_ms": total("q_bound"),
             "bound_by": "bytes", "library_ms": None},
            {"name": "qconv_s8", "route": "cuda", "source": source,
             "replaces": "wseg_tpu/models/backbones/common.py:184",
             "max_abs_err": 0.0, "ms": total("c_ms"),
             "plain_ms": total("c_plain"), "bound_ms": total("c_bound"),
             "bound_by": c_by, "library_ms": lib}]


def int8_launches():
    from wseg_tpu_torch.ops.qconv import qconv_s8, quantize_act

    return {"quantize_act": quantize_act.launches,
            "qconv_s8": qconv_s8.launches}


def zero_int8_launches():
    from wseg_tpu_torch.ops.qconv import qconv_s8, quantize_act

    quantize_act.launches = qconv_s8.launches = 0


def phase_int8_serve(card: str) -> dict:
    """The flagship (``voc_resnet38.yaml``, seeded weights) serves the 8
    VOC-sized images in int8, dynamic and static (statistics written by
    ``quant_calibrate``'s CLI from the same images and weights), each in
    turns with bfloat16: bf16, int8, int8, bf16; label maps checked,
    images/s, the two kernels' launches of each int8 run (none in bf16),
    and ``quant_fidelity``'s label agreement of int8 against bf16.
    Returns the launches of the int8 runs."""
    import torch

    from wseg_tpu_torch import quant_calibrate
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.flagship import (
        FLAGSHIP_SET,
        load_cfg,
        synthetic_images,
    )
    from wseg_tpu_torch.quant_fidelity import (
        agreement,
        build_server,
        serve,
        warm,
    )

    images = synthetic_images(VOC_SIZES)
    launches = {"quantize_act": 0, "qconv_s8": 0}
    tmp = tempfile.mkdtemp(prefix="wseg_smoke_int8_")

    def server_of(dtype, act="dynamic", stats=None):
        reset_cfg()
        load_cfg("voc_resnet38.yaml")
        srv = build_server(dtype, "cuda", seed=0, quant_act=act,
                           stats=stats)
        t0 = time.perf_counter()
        warm(srv, images)
        print(f"int8 serving: {dtype} {act if dtype == 'int8' else ''} "
              f"server warm in {time.perf_counter() - t0:.2f} s ({card})",
              flush=True)
        return srv

    def run(tag, srv, int8: bool):
        zero_int8_launches()
        results, dt = serve(srv, images)
        got = int8_launches()
        check_results(tag, images, [(r, None) for r in results],
                      labels=False)
        if int8:
            check(got["qconv_s8"] > 0 and got["quantize_act"] > 0,
                  f"{tag}: the int8 kernels were not launched: {got}")
            for k in launches:
                launches[k] += got[k]
        else:
            check(got == {"quantize_act": 0, "qconv_s8": 0},
                  f"{tag}: bf16 serving launched int8 kernels: {got}")
        print(f"int8 serving {tag}: {len(images)} images in {dt:.3f} s = "
              f"{len(images) / dt:.3f} images/s, launches {got} ({card})",
              flush=True)
        return results

    try:
        bf16 = server_of("bfloat16")
        dyn = server_of("int8")
        ref = run("bf16 (1)", bf16, False)
        got_dyn = run("int8 dynamic (1)", dyn, True)
        run("int8 dynamic (2)", dyn, True)
        run("bf16 (2)", bf16, False)
        print(f"int8 serving fidelity, dynamic vs bf16: "
              f"{agreement(ref, got_dyn)} ({card})", flush=True)
        # quant_calibrate's CLI on the same weights and images
        snap = os.path.join(tmp, "int8.pth")
        torch.save(dyn.model.state_dict(), snap)
        dyn.close()
        del dyn
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        from PIL import Image

        for i, (img, _) in enumerate(images):
            Image.fromarray(img).save(os.path.join(img_dir, f"{i:02d}.png"))
        stats_file = os.path.join(tmp, "stats.pt")
        reset_cfg()
        t0 = time.perf_counter()
        quant_calibrate.main(["--out", stats_file, "--images", img_dir,
                              "--n", str(len(images)), "--snapshot", snap,
                              "--device", "cuda", "--set", *FLAGSHIP_SET])
        print(f"int8 serving: quant_calibrate over {len(images)} images in "
              f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
        stats = torch.load(stats_file, map_location="cpu",
                           weights_only=True)
        static = server_of("int8", "static", stats)
        got_static = run("int8 static (1)", static, True)
        run("int8 static (2)", static, True)
        run("bf16 (3)", bf16, False)
        print(f"int8 serving fidelity, static vs bf16: "
              f"{agreement(ref, got_static)} ({card})", flush=True)
        static.close()
        bf16.close()
    finally:
        reset_cfg()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def phase_int8_entry(card: str) -> dict:
    """``train`` with ``NET.OPT Adam`` (one short epoch + validation:
    finite losses) on a synthetic VOC; ``quant_calibrate`` on its
    checkpoint; ``infer_val`` in int8 static (scored by ``eval_seg``),
    and refused without statistics; ``infer_val`` in int8 dynamic with
    the exact CRF, multicrop and the per-image path.  Returns the int8
    kernels' launches of the ``infer_val`` runs."""
    import contextlib
    import io
    import math
    import re

    import torch

    from wseg_tpu_torch import infer_val, quant_calibrate, train
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.flagship import FLAGSHIP_CFG, write_synthetic_voc
    from wseg_tpu_torch.utils.checkpoints import model_file

    launches = {"quantize_act": 0, "qconv_s8": 0}
    tmp = tempfile.mkdtemp(prefix="wseg_smoke_int8e_")
    try:
        root = write_synthetic_voc(os.path.join(tmp, "data"), n_train=16,
                                   n_val=4)
        common = ["--dataset", "pascal_voc", "--cfg", FLAGSHIP_CFG,
                  "--exp", "smoke_int8", "--run", "r0",
                  "--snapshot-dir", os.path.join(tmp, "snap"),
                  "--logdir", os.path.join(tmp, "logs"), "--workers", "2",
                  "--device", "cuda"]
        sets = ["--set", "DATASET.ROOT", root, "TEST.DATA_ROOT", root,
                "TRAIN.NUM_EPOCHS", "0", "TRAIN.PRETRAIN", "0"]
        reset_cfg()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            trainer = train.main(common + sets + ["NET.OPT", "Adam"])
        dt = time.perf_counter() - t0
        check(isinstance(trainer.optimizer, torch.optim.Adam),
              f"NET.OPT Adam gave {type(trainer.optimizer).__name__}")
        losses = [float(v) for v in re.findall(
            r"\bloss\w*: (\S+?)\s", text.getvalue())]
        check(losses and all(math.isfinite(v) for v in losses),
              f"Adam training losses {losses}")
        check(all(bool(torch.isfinite(p).all())
                  for p in trainer.model.parameters()),
              "non-finite parameters after Adam steps")
        check(trainer.checkpoint.checkpoints, "the Adam trainer saved "
              "nothing")
        suffix = trainer.checkpoint.checkpoints[-1]
        snap = model_file(trainer.args.snapshot_dir, suffix)
        print(f"int8 entry: train.main with NET.OPT Adam, 1 epoch of 16 + "
              f"validation of 4 in {dt:.2f} s, losses {losses}, "
              f"checkpoint {suffix} ({card})", flush=True)
        del trainer
        torch.cuda.empty_cache()

        stats_file = os.path.join(tmp, "stats.pt")
        reset_cfg()
        quant_calibrate.main([
            "--out", stats_file, "--images",
            os.path.join(root, "JPEGImages"), "--n", "8", "--snapshot",
            snap, "--cfg", FLAGSHIP_CFG, "--device", "cuda"])
        infer = common + ["--resume", suffix, "--infer-list",
                          os.path.join(root, "val_voc.txt")]
        static = ["NET.DTYPE", "int8", "NET.QUANT_ACT", "static"]
        reset_cfg()
        try:
            infer_val.main(infer + ["--mask-output-dir",
                                    os.path.join(tmp, "refused")]
                           + sets + static)
            raise AssertionError("int8 static infer_val served without "
                                 "NET.QUANT_STATS")
        except FileNotFoundError as e:
            print(f"int8 entry: static without statistics refused: {e} "
                  f"({card})", flush=True)
        runs = (("static", static + ["NET.QUANT_STATS", stats_file]),
                ("dynamic exact CRF", ["NET.DTYPE", "int8",
                                       "TEST.CRF_MODE", "exact"]),
                ("dynamic multicrop", ["NET.DTYPE", "int8",
                                       *MULTICROP_SET]),
                ("dynamic per-image", ["NET.DTYPE", "int8",
                                       "TEST.DEVICE_MERGE", "False"]))
        for tag, extra in runs:
            reset_cfg()
            out = os.path.join(tmp, "masks_" + tag.replace(" ", "_"))
            zero_int8_launches()
            t0 = time.perf_counter()
            infer_val.main(infer + ["--mask-output-dir", out] + sets
                           + extra)
            dt = time.perf_counter() - t0
            got = int8_launches()
            check(got["qconv_s8"] > 0 and got["quantize_act"] > 0,
                  f"int8 infer_val ({tag}) launched {got}")
            for k in launches:
                launches[k] += got[k]
            n = {sub: len(os.listdir(os.path.join(out + "_0", sub)))
                 for sub in ("no_crf", "crf")}
            check(n == {"no_crf": 4, "crf": 4}, f"{tag} infer_val wrote {n}")
            miou = score_masks(root, out + "_0", tmp)
            print(f"int8 entry: infer_val ({tag}) wrote {n} PNGs in "
                  f"{dt:.2f} s, launches {got}; eval_seg mIoU {miou:.4f} "
                  f"({card})", flush=True)
    finally:
        reset_cfg()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def timed(phase, card: str, *args):
    """Run ``phase(card, *args)`` and print its wall seconds."""
    t0 = time.perf_counter()
    out = phase(card, *args)
    print(f"phase {phase.__name__}: {time.perf_counter() - t0:.2f} s",
          flush=True)
    return out


def main() -> int:
    card = phase_env()
    timed(phase_build, card)
    int8_kernels = timed(phase_qconv, card)
    kern = timed(phase_kernel, card)
    gauss = timed(phase_gauss, card)
    slice_launches = timed(phase_slice, card)
    ae_serve_launches = timed(phase_ae_serve, card)
    zoo_serve_launches = timed(phase_zoo_serve, card)
    for entry in (kern, gauss):
        name = entry["name"]
        check(slice_launches[name] > 0 and ae_serve_launches[name] > 0
              and zoo_serve_launches[name] > 0,
              f"a serving slice never launched {name}")
        entry["launches"] = (slice_launches[name] + ae_serve_launches[name]
                             + zoo_serve_launches[name])
    int8_launches_serve = timed(phase_int8_serve, card)
    crop_launches, crop_lattice = timed(phase_multicrop_serve, card)
    host_launches = timed(phase_host_paths, card)
    for entry in (kern, gauss):
        name = entry["name"]
        check(crop_launches[name] > 0 and host_launches[name] > 0,
              f"multicrop or host-view serving never launched {name}")
        entry["launches"] += crop_launches[name] + host_launches[name]
    lattice_kernels = timed(phase_lattice_kernels, card)
    exact_launches = timed(phase_exact_slice, card)
    for entry in lattice_kernels:
        entry["launches"] = (exact_launches[entry["name"]]
                             + crop_lattice[entry["name"]])
        check(exact_launches[entry["name"]] > 0
              and crop_lattice[entry["name"]] > 0,
              f"an exact slice never launched {entry['name']}")
    pamr_kernels = timed(phase_pamr_kernels, card)
    lab_kernels = timed(phase_pamr_variants, card)
    launches = timed(phase_train, card)
    ae_launches = timed(phase_ae_train, card)
    zoo_launches = timed(phase_zoo_train, card)
    seam_launches = timed(phase_seam_train, card)
    ddp_launches = timed(phase_ddp, card)
    for entry in pamr_kernels:
        name = entry["name"]
        check(launches[name] > 0 and ae_launches[name] > 0
              and zoo_launches[name] > 0 and seam_launches[name] > 0
              and ddp_launches[name] > 0,
              f"a train slice never launched {name}")
        entry["launches"] = (launches[name] + ae_launches[name]
                             + zoo_launches[name] + seam_launches[name]
                             + ddp_launches[name])
    print(f"main-path launches: fast CRF kernels {slice_launches} (flagship "
          f"slice) + {ae_serve_launches} (ae serving) + "
          f"{zoo_serve_launches} (zoo serving) + {crop_launches} (multicrop) "
          f"+ {host_launches} (host views); lattice kernels "
          f"{exact_launches} (exact slice) + {crop_lattice} (multicrop "
          f"exact); PAMR kernels {launches} "
          f"(flagship steps) + {ae_launches} (ae steps) + {zoo_launches} "
          f"(zoo steps) + {seam_launches} (SEAM steps) + {ddp_launches} "
          f"(NCCL group of one)", flush=True)
    timed(phase_entry, card)
    timed(phase_ae_entry, card)
    timed(phase_zoo_entry, card)
    timed(phase_cam_entry, card, timed(phase_seam_entry, card))
    int8_launches_entry = timed(phase_int8_entry, card)
    for entry in int8_kernels:
        name = entry["name"]
        check(int8_launches_serve[name] > 0 and int8_launches_entry[name] > 0,
              f"int8 serving never launched {name}")
        entry["launches"] = (int8_launches_serve[name]
                             + int8_launches_entry[name])
    print(f"main-path launches: int8 kernels {int8_launches_serve} (int8 "
          f"serving slice) + {int8_launches_entry} (int8 infer_val)",
          flush=True)
    import torch

    print(card, flush=True)
    print(json.dumps({"kernels": [kern, gauss] + pamr_kernels
                      + lattice_kernels + lab_kernels + int8_kernels}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
