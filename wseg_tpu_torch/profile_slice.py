"""Time and profile the port's serving slice on one CUDA card.

    python -m wseg_tpu_torch.profile_slice [--groups 3] [--out DIR]
        [--crf-mode fast|exact]

Flagship configuration (``configs/voc_resnet38.yaml``: WRN38 +
CAM_CASA_WGAP_tf in bfloat16, scales 1/0.5/1.5/2 with flip), seeded
random weights, with the fast coarse-to-fine CRF or (``--crf-mode
exact``) the exact permutohedral CRF.  Prints, each with the card's
name and power limit:

* images/s over ``--groups`` full groups (TEST.BATCH_SIZE images of one
  VOC size) with the CRF's kernels and with the same program using
  their plain versions, in turns kernel, plain, plain, kernel;
* device time per serving stage (the ``serve.*`` / ``crf.*`` profiler
  ranges; ``serve.crf`` with the fast CRF's two ctypes-launched kernels
  added by name), the top kernels, the CRF kernels, and the device's
  busy share of the wall time, over one profiled group (in exact mode
  until its last image's CRF is done).

With ``--out`` it also writes ``profile_slice.json`` and a Chrome trace
there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from wseg_tpu_torch.flagship import (
    build_flagship_server,
    card_line,
    load_cfg,
    synthetic_images,
)


@contextlib.contextmanager
def plain_kernels(crf_mode: str):
    """Run the CRF with its kernels' plain versions (the end-to-end
    baseline: the same program with the kernels off)."""
    from wseg_tpu_torch.ops import crf, crf_bilateral, crf_exact, crf_gauss
    from wseg_tpu_torch.ops import crf_lattice
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    if crf_mode == "fast":
        swaps = [(crf, "bilateral_message_cm",
                  crf_bilateral.bilateral_message_cm_reference),
                 (crf, "gauss_blur_cm", crf_gauss.gauss_blur_cm_reference)]
    else:
        swaps = [(crf_exact, "lattice_weights", k.lattice_weights_reference),
                 (crf_lattice, "lattice_filter_cuda",
                  k.lattice_filter_reference)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, kernel in kept:
            setattr(mod, name, kernel)


def serve_rate(server, images) -> float:
    """images/s of serving ``images`` (submitted at once)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [server.submit(img, lab) for img, lab in images]
    for f in futs:
        f.result(timeout=900)
    return len(images) / (time.perf_counter() - t0)


def _dev_us(evt, self_only=False) -> float:
    name = ("self_" if self_only else "") + "device_time_total"
    if hasattr(evt, name):
        return float(getattr(evt, name))
    return float(getattr(evt, name.replace("device", "cuda")))


def profile_group(server, group_images, trace_path=None) -> dict:
    """Profile one group, run on this thread; returns stage and kernel
    device times (ms) and the busy share of the group's wall time."""
    from concurrent.futures import Future

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    crf_ops = (bilateral_message_cm, gauss_blur_cm)
    group = [(img, lab, Future()) for img, lab in group_images]
    launched = [op.launches for op in crf_ops]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server._process(group)
        for _, _, fut in group:  # exact-CRF jobs resolve on their threads
            fut.result(timeout=900)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    stages, kernels, launches = {}, {}, 0
    for evt in prof.key_averages():
        if evt.key.startswith(("serve.", "crf.")):
            st = stages.setdefault(evt.key, {})
            if evt.device_type == DeviceType.CUDA:
                # the range as drawn on the device timeline (idle included)
                st["device_span_ms"] = _dev_us(evt) / 1e3
            else:
                st["host_ms"] = evt.cpu_time_total / 1e3
                st["kernel_ms"] = _dev_us(evt) / 1e3
        elif evt.device_type == DeviceType.CUDA:
            kernels[evt.key] = _dev_us(evt, self_only=True) / 1e3
            launches += evt.count
    # the fast CRF's two kernels launch through ctypes, outside any aten
    # op, so the profiler gives them to no range: they run under serve.crf
    crf = {}
    for op, before in zip(crf_ops, launched):
        mine = {k: v for k, v in kernels.items() if op.kernel_name in k}
        if kernels and op.launches > before and not mine:
            raise RuntimeError(
                f"{op.__name__} launched {op.launches - before} kernels but "
                f"the trace has none named {op.kernel_name!r}: was the "
                f"kernel renamed?")
        crf.update(mine)
    crf_ms = sum(crf.values())
    if crf_ms and "serve.crf" in stages:
        stages["serve.crf"]["kernel_ms"] = (
            stages["serve.crf"].get("kernel_ms", 0.0) + crf_ms)
        stages["serve.crf"]["crf_kernels_ms"] = crf_ms
    busy_ms = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "kernel_launches": launches,
            "stages_ms": stages, "top_kernels_ms": top,
            "crf_kernels_ms": crf}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--crf-mode", choices=("fast", "exact"), default="fast")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")
    card = card_line()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    from wseg_tpu_torch.config import cfg

    src = load_cfg("voc_resnet38.yaml")
    cfg.TEST.CRF_MODE = args.crf_mode
    server = build_flagship_server("cuda")
    bs = int(cfg.TEST.BATCH_SIZE)
    try:
        w, h = 500, 375
        server.warmup([(w, h)])
        images = synthetic_images([(w, h)] * (bs * args.groups), seed=1)
        rates = {"kernel": [], "plain": []}
        for mode in ("kernel", "plain", "plain", "kernel"):
            ctx = plain_kernels(args.crf_mode) if mode == "plain" else \
                contextlib.nullcontext()
            with ctx:
                rates[mode].append(serve_rate(server, images))
        for mode, r in rates.items():
            print(f"full groups of {bs} x {w}x{h}, {args.groups} groups, "
                  f"{args.crf_mode} CRF, kernels {mode}: {r[0]:.3f} / "
                  f"{r[1]:.3f} images/s ({card})", flush=True)
        trace = os.path.join(args.out, "slice_trace.json") \
            if args.out else None
        prof = profile_group(server, images[:bs], trace)
    finally:
        server.close()
    print(f"one profiled group of {bs}: wall {prof['wall_ms']:.2f} ms, "
          f"device busy {prof['device_busy_ms']:.2f} ms "
          f"({100 * prof['busy_share']:.1f}%), {prof['kernel_launches']} "
          f"kernel launches ({card})", flush=True)
    for k, v in sorted(prof["stages_ms"].items()):
        print(f"  stage {k}: " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in sorted(v.items())),
            flush=True)
    for k, v in prof["top_kernels_ms"].items():
        print(f"  kernel {v:9.3f} ms  {k[:100]}", flush=True)
    for k, v in prof["crf_kernels_ms"].items():
        print(f"  CRF kernel {v:9.3f} ms  {k[:100]}", flush=True)
    summary = {"card": card, "config": src, "crf_mode": args.crf_mode,
               "batch": bs,
               "image_wh": [w, h], "groups": args.groups,
               "images_per_s": rates, **prof}
    if args.out:
        with open(os.path.join(args.out, "profile_slice.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
