"""PAMR kernel lab: time the affinity and propagation variants.

    python -m wseg_tpu_torch.bench_pamr [--shape 8,96,96,21] [--iters 10]
        [--reps 20] [--device cuda]

The port of the JAX package's ``tools/bench_pamr.py``, in its row order:
the affinity kernel and its plain version, then the propagation as the
train step runs it (``pamr_propagate_cm``, "baseline"), the lab's three
variants (``ops/pamr_variants.py``: fold, dx-first, selector products on
the tensor cores) at the lab's block sizes and types, and the plain
propagation.  Inputs come from a seeded ``torch.Generator``: a random
guide, its affinities from ``pamr_affinity_cm``, a softmax mask.  Each
row prints its max |err| against the plain version
(``pamr_propagate_cm_reference``, or the plain affinity), the median ms
per call (CUDA events on the card, the host clock with ``--device
cpu``), the ms per call of ``CHAIN`` calls run back to back between two
events (each propagation feeding the next), and its kernel launches;
then the rows sorted by chained ms.  Every line carries the card's
``nvidia-smi`` name and power limit.  ``main`` returns the rows.

A row that fails raises: the lab does not skip it.  With ``--device
cpu`` every row runs its plain version, at whatever shape is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from wseg_tpu_torch.ops.pamr_cuda import (
    pamr_affinity_cm,
    pamr_affinity_cm_reference,
    pamr_propagate_cm,
    pamr_propagate_cm_reference,
)
from wseg_tpu_torch.ops.pamr_variants import (
    DILATIONS,
    propagate_dxfirst_cm,
    propagate_fold_cm,
    propagate_mxu_cm,
)

CHAIN = 10
_BF16 = {"store_dtype": torch.bfloat16}

# (name, function, keywords): the affinity rows take (guide, dilations),
# the propagation rows (aff, mask, dilations, iters, **keywords)
ROWS = (
    ("aff_kernel", pamr_affinity_cm, None),
    ("aff_plain", pamr_affinity_cm_reference, None),
    ("baseline", pamr_propagate_cm, {}),
    ("fold(nb=4)", propagate_fold_cm, {"block_b": 4}),
    ("fold_bf16(nb=4)", propagate_fold_cm, {"block_b": 4, **_BF16}),
    ("dxfirst(nb=1)", propagate_dxfirst_cm, {"block_b": 1}),
    ("dxfirst(nb=4)", propagate_dxfirst_cm, {"block_b": 4}),
    ("dxfirst_bf16(nb=4)", propagate_dxfirst_cm, {"block_b": 4, **_BF16}),
    ("mxu(nb=2,highest)", propagate_mxu_cm,
     {"block_b": 2, "precision": "highest"}),
    ("mxu(nb=2,default)", propagate_mxu_cm,
     {"block_b": 2, "precision": "default"}),
    ("plain", pamr_propagate_cm_reference, {}),
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed_ms(fn, device: torch.device) -> float:
    """ms of one call of ``fn``, to the end of its work on the device."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def time_row(call, chained, reps: int, device: torch.device):
    """(median ms of one call over ``reps``, ms per call of ``CHAIN``
    chained calls)."""
    call()
    _sync(device)
    times = sorted(_elapsed_ms(call, device) for _ in range(reps))
    return times[len(times) // 2], _elapsed_ms(chained, device) / CHAIN


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="8,96,96,21",
                    help="B,H,W,C of the mask")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)
    from wseg_tpu_torch.opts import get_device

    device = get_device(args)
    if device.type == "cuda":
        from wseg_tpu_torch.flagship import card_line

        card = card_line()
    else:
        card = "cpu"
    b, h, w, c = (int(v) for v in args.shape.split(","))
    ni, dil = args.iters, DILATIONS

    gen = torch.Generator(device=device).manual_seed(0)
    im = torch.rand((b, 3, h, w), generator=gen, device=device)
    mask = torch.softmax(torch.randn((b, c, h, w), generator=gen,
                                     device=device), dim=1)
    aff = pamr_affinity_cm(im, dil)
    aff_ref = pamr_affinity_cm_reference(im, dil)
    ref = pamr_propagate_cm_reference(aff, mask, dil, ni)
    _sync(device)
    print(f"shape=({b},{h},{w},{c}) x {ni} iters, dilations {dil} "
          f"({card})", flush=True)

    rows = []
    for name, fn, kw in ROWS:
        before = getattr(fn, "launches", 0)
        if kw is None:
            def call(fn=fn):
                return fn(im, dil)

            def chained(fn=fn):
                for _ in range(CHAIN):
                    fn(im, dil)
            want = aff_ref
        else:
            def call(fn=fn, kw=kw):
                return fn(aff, mask, dil, ni, **kw)

            def chained(fn=fn, kw=kw):
                m = mask
                for _ in range(CHAIN):
                    m = fn(aff, m, dil, ni, **kw)
            want = ref
        out = call()
        _sync(device)
        err = float((out - want).abs().max())
        ms, chained_ms = time_row(call, chained, args.reps, device)
        launches = getattr(fn, "launches", 0) - before
        rows.append({"name": name, "err": err, "ms": ms,
                     "chained_ms": chained_ms, "launches": launches})
        print(f"  {name}: max|err| = {err:.3e}, {ms:.4f} ms per call, "
              f"{chained_ms:.4f} ms chained, {launches} launches ({card})",
              flush=True)

    print(f"\nname dispatch_ms chained_ms err ({card})")
    for r in sorted(rows, key=lambda r: r["chained_ms"]):
        print(f"{r['name']:24s} {r['ms']:8.4f} {r['chained_ms']:8.4f} "
              f"{r['err']:.2e} ({card})", flush=True)
    return rows


if __name__ == "__main__":
    main()
