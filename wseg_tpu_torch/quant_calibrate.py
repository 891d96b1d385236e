"""int8 static-activation calibration (``NET.QUANT_ACT static``) with the
port: the statistics file that ``NET.QUANT_STATS`` names.

    python -m wseg_tpu_torch.quant_calibrate --out stats.pt \\
        [--images DIR] [--n 32] [--snapshot model.pth] \\
        [--cfg configs/voc_resnet38.yaml] [--set KEY VALUE ...] \\
        [--device cuda]

Mirror of ``tools/quant_calibrate.py``: builds the int8 model with
static activation scales (``NET.DTYPE int8``, ``NET.QUANT_ACT
static``), runs each image's multiscale views (host views,
``data/multiscale.MultiscaleViews`` at ``cfg.TEST``'s scales, flip and
padding), one forward per bucket of same-shape views, while every
``QuantConv`` max-accumulates its per-input-channel |x|
(``models/backbones/common.calibrating``), prints the count of
channels that stayed at zero, and writes ``torch.save`` of {conv name:
float32 (cin,) amax} to ``--out``.  Without ``--images`` it calibrates
on 500x375 noise images (program coverage only: use real VOC images for
production scales); without ``--snapshot`` on the random weights that
``infer_val`` serves without one (at its default ``--random-seed``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Sequence

import numpy as np
import torch

# infer_val's default --random-seed: without --snapshot, the weights it
# serves
RANDOM_SEED = 64


def calibrate(model, images: Sequence[np.ndarray],
              test_cfg) -> Dict[str, torch.Tensor]:
    """Max-accumulate the static ``QuantConv``s' input statistics of
    ``model`` over the multiscale views of ``images`` ((h, w, 3) uint8)
    and return them (``common.quant_stats``)."""
    from wseg_tpu_torch.data.multiscale import MultiscaleViews
    from wseg_tpu_torch.models.backbones.common import (
        calibrating,
        quant_stats,
    )

    views = MultiscaleViews(test_cfg.SCALES, bool(test_cfg.FLIP),
                            test_cfg.PAD_SIZE, bool(test_cfg.PAD_PER_SCALE),
                            int(test_cfg.PAD_ALIGN))
    dev = next(model.parameters()).device
    with calibrating(model), torch.inference_mode():
        for i, im in enumerate(images):
            vs, _, _ = views.build(im)
            buckets: dict = {}
            for v in vs:
                buckets.setdefault(v.shape[:2], []).append(v)
            for arrs in buckets.values():
                model(torch.from_numpy(np.stack(arrs)).to(dev))
            if (i + 1) % 8 == 0:
                print(f"[{i + 1}/{len(images)}]", flush=True)
    return quant_stats(model)


def read_images(directory: str, n: int):
    """The first ``n`` images of ``directory`` (sorted names) as (h, w,
    3) uint8 RGB, or ``n`` 500x375 noise images without a directory."""
    from PIL import Image

    if not directory:
        rng = np.random.RandomState(0)
        return [(rng.rand(375, 500, 3) * 255).astype(np.uint8)
                for _ in range(n)]
    out = []
    for name in sorted(os.listdir(directory))[:n]:
        with Image.open(os.path.join(directory, name)) as im:
            out.append(np.asarray(im.convert("RGB"), np.uint8))
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--images", default="",
                    help="directory of calibration images (else noise)")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--snapshot", default="",
                    help="port or reference .pth (else seeded random "
                         "weights)")
    ap.add_argument("--cfg", default="")
    ap.add_argument("--set", dest="set_cfgs", default=None,
                    nargs=argparse.REMAINDER)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)

    from wseg_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import (
        seeded_init_,
        stabilize_scratch_init,
    )
    from wseg_tpu_torch.opts import get_device
    from wseg_tpu_torch.utils.convert import load_checkpoint

    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    cfg.NET.DTYPE = "int8"
    cfg.NET.QUANT_ACT = "static"
    device = get_device(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model(cfg.NET, num_classes=int(cfg.TEST.NUM_CLASSES))
    if args.snapshot:
        load_checkpoint(model, args.snapshot)
        print("loaded", args.snapshot, flush=True)
    else:
        seeded_init_(model, torch.Generator().manual_seed(RANDOM_SEED))
        stabilize_scratch_init(model, 0.1)
    model = model.to(device)
    stats = calibrate(model, read_images(args.images, args.n), cfg.TEST)
    n_zero = int(sum(int((v == 0).sum()) for v in stats.values()))
    if n_zero:
        # channels at exactly 0 over the whole calibration set are
        # (almost surely) dead ReLU channels; they quantize to 0 when
        # serving too, so this is informational
        print(f"NOTE: {n_zero} always-zero input channels (dead upstream "
              "units)", flush=True)
    torch.save(stats, args.out)
    print("wrote", args.out, len(stats), "conv stats", flush=True)
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
