"""Time and profile the port's flagship train step on one CUDA card.

    python -m wseg_tpu_torch.profile_train [--steps 5] [--out DIR]

Flagship configuration (``configs/voc_resnet38.yaml``: WRN38 +
CAM_CASA_WGAP_tf, float32 parameters with bfloat16 compute, crop 384,
batch 8, PAMR 10 x dilations 1-24, mask loss on), seeded weights and
synthetic batches.  Every number comes from ``train_step`` itself.
Prints, each with the card's name and power limit:

* step ms and images/s over ``--steps`` steps with the PAMR kernels and
  with PAMR's plain versions swapped in for the model's ``pamr`` (the
  comparison only; the model never takes them on the card), in turns
  kernel, plain, plain, kernel;
* per unprofiled step, the host's time until ``train_step`` returns
  (it does not wait for the card at its end, only where the step itself
  synchronises) against the step's wall time: a step whose issue time
  is well below its wall time leaves the host ahead of the card;
* over one profiled step: wall time, the kernels' device time and its
  share of that wall time (the profiler's host overhead included), the
  host's synchronising calls, the kernels' device time under each
  ``train.*`` range (backward is the total less the other ranges: the
  autograd engine launches from its own thread, outside the range), and
  the top kernels.

With ``--out`` it also writes ``profile_train.json`` and a Chrome trace
there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from wseg_tpu_torch.flagship import (
    card_line,
    load_flagship_cfg,
    synthetic_train_batch,
)


def _step_ms(model, opt, batches, kw) -> float:
    from wseg_tpu_torch.engine.train_loop import train_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        train_step(model, opt, b, 1.0, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def plain_pamr_ms(model, opt, batches, kw) -> float:
    """``_step_ms`` with the model's PAMR on its plain versions."""
    from wseg_tpu_torch.models import stage_net
    from wseg_tpu_torch.ops.pamr import pamr_reference

    kernel_pamr = stage_net.pamr
    stage_net.pamr = lambda im, mask, dil, n, impl: pamr_reference(
        im, mask, dil, n)
    try:
        return _step_ms(model, opt, batches, kw)
    finally:
        stage_net.pamr = kernel_pamr


def issue_ms(model, opt, batches, kw) -> dict:
    """Medians over ``batches`` of the host's time to issue one step and
    of the step's wall time, the card idle before each step."""
    from wseg_tpu_torch.engine.train_loop import train_step

    issue, wall = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, opt, b, 1.0, **kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return {"issue_ms": float(np.median(issue)),
            "step_wall_ms": float(np.median(wall))}


def profile_step(model, opt, batch, kw, trace_path=None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wseg_tpu_torch.engine.train_loop import train_step
    from wseg_tpu_torch.profile_slice import _dev_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, batch, 1.0, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    ranges, kernels, syncs, launches = {}, {}, {}, 0
    for evt in prof.key_averages():
        if evt.key.startswith("train."):
            if evt.device_type != DeviceType.CUDA:
                ranges[evt.key[len("train."):]] = _dev_us(evt) / 1e3
        elif evt.device_type == DeviceType.CUDA:
            if not getattr(evt, "is_user_annotation", False):
                kernels[evt.key] = _dev_us(evt, self_only=True) / 1e3
                launches += evt.count
        elif "Synchronize" in evt.key:
            syncs[evt.key] = evt.count
    busy = sum(kernels.values())
    # the PAMR kernels launch through ctypes, outside any aten op, so the
    # profiler gives them to no range: they run under train.pamr
    pamr_ms = sum(v for k, v in kernels.items() if "pamr_" in k)
    for k in ("forward", "pamr"):
        ranges[k] = ranges.get(k, 0.0) + pamr_ms
    ranges["backward"] = busy - sum(ranges.get(k, 0.0) for k in
                                    ("forward", "loss", "optim"))
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])
    return {"wall_ms": wall_ms, "kernel_ms": busy,
            "pamr_kernels_ms": {k: v for k, v in kernels.items()
                                if "pamr_" in k},
            "busy_share": busy / wall_ms, "kernel_launches": launches,
            "host_syncs": syncs, "range_kernel_ms": ranges,
            "top_kernels_ms": top}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = card_line()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.trainer import build_train_model
    from wseg_tpu_torch.optim import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = load_flagship_cfg()
    crop, bs = int(cfg.DATASET.CROP_SIZE), int(cfg.TRAIN.BATCH_SIZE)
    model = build_train_model(torch.device("cuda"), seed=0)
    opt, _ = make_optimizer(cfg.NET, model)
    rng = np.random.RandomState(1)
    batches = [synthetic_train_batch(rng, bs, crop)
               for _ in range(args.steps)]
    kw = dict(device_jitter=True, loss_name=str(cfg.NET.LOSS),
              mask_loss_bce=float(cfg.NET.MASK_LOSS_BCE))
    _step_ms(model, opt, batches[:2], kw)                  # warm-up
    step = {"kernel": [], "plain": []}
    for mode in ("kernel", "plain", "plain", "kernel"):
        timer = plain_pamr_ms if mode == "plain" else _step_ms
        step[mode].append(timer(model, opt, batches, kw))
    for mode, ms in step.items():
        print(f"train step, PAMR {mode}: {ms[0]:.2f} / {ms[1]:.2f} ms = "
              f"{bs * 1e3 / ms[0]:.2f} / {bs * 1e3 / ms[1]:.2f} images/s "
              f"(batch {bs}, crop {crop}, {args.steps} steps; {card})",
              flush=True)
    issue = issue_ms(model, opt, batches, kw)
    print(f"unprofiled step, median of {args.steps}: host issues it in "
          f"{issue['issue_ms']:.2f} ms of {issue['step_wall_ms']:.2f} ms wall "
          f"({card})", flush=True)
    trace = os.path.join(args.out, "train_trace.json") if args.out else None
    prof = profile_step(model, opt, batches[0], kw, trace)
    print(f"one profiled step: wall {prof['wall_ms']:.2f} ms, kernels "
          f"{prof['kernel_ms']:.2f} ms ({100 * prof['busy_share']:.1f}% of "
          f"the wall, profiler overhead included), "
          f"{prof['kernel_launches']} kernel launches, host syncs "
          f"{prof['host_syncs']} ({card})", flush=True)
    print("kernel ms per range: " + ", ".join(
        f"{k} {v:.2f}" for k, v in prof["range_kernel_ms"].items()),
        flush=True)
    print("PAMR kernels: " + ", ".join(
        f"{k[:60]} {v:.4f} ms" for k, v in prof["pamr_kernels_ms"].items())
        + f" ({card})", flush=True)
    for k, v in prof["top_kernels_ms"].items():
        print(f"  kernel {v:9.3f} ms  {k[:100]}", flush=True)
    summary = {"card": card, "config": src, "batch": bs, "crop": crop,
               "steps": args.steps, "step_ms": step, **issue,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               **prof}
    if args.out:
        with open(os.path.join(args.out, "profile_train.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
