"""SBD ``.mat`` -> indexed ``.png`` ground truth (the port's copy of
``tools/convert_sbd.py``, reference tools/convert_sbd.py:28-53).

    python -m wseg_tpu_torch.convert_sbd --sbd-root SBD/cls --out OUT_DIR
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from wseg_tpu_torch.data.pascal_voc import get_palette


def convert(mat_path: str, out_path: str) -> None:
    """One SBD class-segmentation ``.mat`` -> one palette PNG."""
    import scipy.io
    from PIL import Image

    mat = scipy.io.loadmat(mat_path)
    seg = mat["GTcls"][0]["Segmentation"][0].astype(np.uint8)
    im = Image.fromarray(seg, mode="P")
    im.putpalette(get_palette())
    im.save(out_path)


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--sbd-root", required=True,
                   help="directory containing SBD cls/*.mat files")
    p.add_argument("--out", required=True, help="output directory")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    files = sorted(f for f in os.listdir(args.sbd_root)
                   if f.endswith(".mat"))
    for i, f in enumerate(files):
        convert(os.path.join(args.sbd_root, f),
                os.path.join(args.out, f[:-4] + ".png"))
        if i % 500 == 0:
            print(f"[{i}/{len(files)}]", flush=True)
    print(f"Converted {len(files)} masks to {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
