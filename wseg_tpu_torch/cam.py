"""Single-image CAM demo with the port (same flags as the root
``cam.py``, plus ``--device``).

    python -m wseg_tpu_torch.cam --cfg configs/voc_resnet38.yaml \\
        --resume snapshot.pth --image-path image.jpg --method gradcam \\
        [--target-category 3] [--device cuda]

Runs the chosen CAM method for ``--target-category`` (the model's
top-scoring class when it is not given) and writes, in the working
directory, ``{method}_cam.jpg`` (the map over the image in ``jet``),
``{method}_gb.jpg`` (guided backprop) and ``{method}_cam_gb.jpg``
(guided backprop weighted by the map).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from wseg_tpu_torch.config import cfg_from_file, cfg_from_list
from wseg_tpu_torch.infer_cam import METHODS
from wseg_tpu_torch.opts import (
    add_global_arguments,
    check_global_arguments,
    get_device,
)


def get_args(argv):
    parser = argparse.ArgumentParser(description="Single-image CAM")
    add_global_arguments(parser)
    parser.add_argument("--image-path", type=str, required=True)
    parser.add_argument("--method", type=str, default="gradcam",
                        choices=[m for m in METHODS
                                 if m != "guidedbackprop"])
    parser.add_argument("--target-category", type=int, default=None)
    parser.add_argument("--eigen_smooth", action="store_true")
    args = parser.parse_args(argv)
    check_global_arguments(args)
    return args


def overlay_cam(image01: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """Half the image, half the map in ``jet``, as uint8."""
    from wseg_tpu_torch.engine.writers import colormap

    out = 0.5 * image01 + 0.5 * colormap("jet", cam)
    return np.round(255 * out).astype(np.uint8)


def main(argv):
    args = get_args(argv)
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)

    from PIL import Image

    from wseg_tpu_torch.data.pascal_voc import MEAN, STD
    from wseg_tpu_torch.gradcam import GuidedBackprop, get_cam_method
    from wseg_tpu_torch.infer_val import load_serving_model

    device = get_device(args)
    model = load_serving_model(args, device)
    with Image.open(args.image_path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    x = ((arr - np.asarray(MEAN, np.float32))
         / np.asarray(STD, np.float32))[None]

    target = args.target_category
    if target is None:
        with torch.no_grad():
            cls = model(torch.from_numpy(x).to(device)).cls
        target = int(cls[0].float().argmax())
        print("Predicted target category:", target)

    m = get_cam_method(args.method)(model)(
        x, target_category=target, eigen_smooth=args.eigen_smooth)[0]
    out_path = f"{args.method}_cam.jpg"
    Image.fromarray(overlay_cam(arr, m)).save(out_path)
    print("Wrote", out_path)

    # guided backprop + guided grad-cam (reference cam.py:100-128)
    gb = GuidedBackprop(model)(x, target_category=target)[0]
    gb_vis = gb - gb.mean()
    gb_vis = np.clip(0.5 + 0.1 * gb_vis / (gb_vis.std() + 1e-8), 0, 1)
    Image.fromarray(np.round(255 * gb_vis).astype(np.uint8)).save(
        f"{args.method}_gb.jpg")
    cam_gb = np.clip(gb_vis * m[..., None], 0, 1)
    Image.fromarray(np.round(255 * cam_gb).astype(np.uint8)).save(
        f"{args.method}_cam_gb.jpg")
    print("Wrote", f"{args.method}_gb.jpg", f"{args.method}_cam_gb.jpg")
    return target


if __name__ == "__main__":
    main(sys.argv[1:])
