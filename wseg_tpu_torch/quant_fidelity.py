"""int8 serving-mode fidelity: the complete serving path run twice on the
same images and weights, ``NET.DTYPE bfloat16`` against ``int8``.

    python -m wseg_tpu_torch.quant_fidelity [n_images] [--device cuda] \\
        [--quant-act dynamic|static] [--quant-stats stats.pt] \\
        [--snapshot model.pth]

Mirror of ``tools/quant_fidelity.py``: WRN38 + ``CAM_CASA_WGAP_tf``
(``configs/voc_resnet38.yaml``: scales 1/0.5/1.5/2 + flip, GT labels),
device views -> forward -> merge -> fast CRF -> label maps through
``MultiScaleServer`` at thresholds 0.0 and 0.1, on 384x512 noise
images with GT classes 3 and 8; prints one JSON line with the mean and
least per-image agreement of ``pred`` and ``pred_crf`` between the two
modes.  Both models carry the same weights: ``--snapshot``'s, or the
float32 seeded weights that ``flagship.build_flagship_server`` draws
(the bfloat16 model holds them rounded, the int8 model quantizes them
from float32).  ``--quant-act static`` serves the int8 model on the
calibrated scales of ``--quant-stats`` (``quant_calibrate``'s file).
Random weights are the worst case for dynamic activation scales.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

THRESHS = (0.0, 0.1)


def build_server(dtype: str, device, seed: int = 0, snapshot: str = "",
                 quant_act: str = "dynamic", stats=None):
    """The loaded config's server (``flagship.build_flagship_server``)
    with ``NET.DTYPE dtype``; ``snapshot`` weights where given; in int8
    static mode ``stats`` ({conv name: amax}) loaded.  Reads and sets
    the port's global cfg."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.flagship import build_flagship_server
    from wseg_tpu_torch.models.backbones.common import load_quant_stats
    from wseg_tpu_torch.utils.convert import load_checkpoint

    cfg.NET.DTYPE = dtype
    cfg.NET.QUANT_ACT = quant_act
    server = build_flagship_server(device, seed=seed)
    if snapshot:
        load_checkpoint(server.model, snapshot)
    if dtype == "int8" and quant_act == "static":
        if stats is None:
            raise ValueError("int8 static serving needs calibrated stats")
        load_quant_stats(server.model, stats)
    return server


def warm(server, images: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
    """One warm-up group per size signature of ``images``."""
    sigs = {tuple(server.views.view_shapes(im.shape[1], im.shape[0])):
            (im.shape[1], im.shape[0]) for im, _ in images}
    for size in sigs.values():
        server.warmup([size])
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)


def serve(server, images: Sequence[Tuple[np.ndarray, np.ndarray]]
          ) -> Tuple[List[dict], float]:
    """(results, seconds) of ``images`` ((uint8 image, GT labels) pairs)
    through a warm ``server``; the seconds run from the first submit to
    the last resolved future."""
    t0 = time.perf_counter()
    futs = [server.submit(im, lab) for im, lab in images]
    results = [f.result(timeout=3600)[0] for f in futs]
    return results, time.perf_counter() - t0


def agreement(res_a: Sequence[dict], res_b: Sequence[dict],
              threshs=THRESHS) -> Dict[str, float]:
    """Mean and least per-image (and threshold) agreement of the label
    maps ``pred`` and ``pred_crf`` of two runs over the same images."""
    out = {}
    for key in ("pred", "pred_crf"):
        ag = [float((np.asarray(a[t][key]) == np.asarray(b[t][key])).mean())
              for a, b in zip(res_a, res_b) for t in threshs if key in a[t]]
        out[f"{key}_agreement_mean"] = float(np.mean(ag))
        out[f"{key}_agreement_min"] = float(np.min(ag))
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quant-act", default="dynamic",
                    choices=("dynamic", "static"))
    ap.add_argument("--quant-stats", default="")
    ap.add_argument("--snapshot", default="")
    args = ap.parse_args(argv)

    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.flagship import load_cfg
    from wseg_tpu_torch.opts import get_device

    device = get_device(args)
    stats = None
    if args.quant_act == "static":
        stats = torch.load(args.quant_stats, map_location="cpu",
                           weights_only=True)
    rng = np.random.RandomState(0)
    gt = np.zeros(20, np.float32)
    gt[[3, 8]] = 1.0
    images = [((rng.rand(384, 512, 3) * 255).astype(np.uint8), gt)
              for _ in range(args.n)]
    runs = {}
    for dtype in ("bfloat16", "int8"):
        reset_cfg()
        load_cfg("voc_resnet38.yaml")
        server = build_server(dtype, device, snapshot=args.snapshot,
                              quant_act=args.quant_act, stats=stats)
        try:
            warm(server, images)
            runs[dtype], _ = serve(server, images)
        finally:
            server.close()
    out = agreement(runs["bfloat16"], runs["int8"])
    out["n_images"] = args.n
    out["quant_act"] = args.quant_act
    out["weights"] = "snapshot" if args.snapshot else \
        "random-init (worst case)"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
