"""Grad-CAM mask inference with the port (same flags as the root
``infer_cam.py``, plus ``--device``).

    python -m wseg_tpu_torch.infer_cam --cfg configs/voc_resnet38.yaml \\
        --infer-list data/val_voc.txt --resume snapshot.pth \\
        --method gradcam --mask-output-dir results/cam [--device cuda]

Per image and per label (the GT mask's labels where there is one, else
all 20): the chosen CAM method's map goes into that label's channel of
an (H, W, C) score map, written through ``ResultWriter.save`` at
threshold 0.0 without CRF to ``<mask-output-dir>/{no_crf,vis}``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from wseg_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
from wseg_tpu_torch.opts import (
    add_global_arguments,
    check_global_arguments,
    get_device,
)

METHODS = ["gradcam", "gradcam++", "scorecam", "xgradcam", "ablationcam",
           "eigencam", "eigengradcam", "layercam", "fullgrad",
           "guidedbackprop"]


def get_cam_arguments(argv):
    parser = argparse.ArgumentParser(description="CAM inference")
    add_global_arguments(parser)
    parser.add_argument("--method", type=str, default="gradcam",
                        choices=METHODS)
    parser.add_argument("--eigen_smooth", action="store_true")
    parser.add_argument("--aug_smooth", action="store_true")
    parser.add_argument("--pad-align", type=int, default=64,
                        help="Pad each normalised image with zeros at the "
                             "bottom and right up to a multiple of this "
                             "before the forward, and cut the maps back "
                             "to the image (0 = no padding)")
    args = parser.parse_args(argv)
    check_global_arguments(args)
    return args


def guided_to_map(m: np.ndarray) -> np.ndarray:
    """Guided backprop's (B, H, W, 3) gradient -> a (B, H, W) map in
    [0, 1]: max |g| over RGB, min-max scaled over the whole batch."""
    g = np.abs(m).max(-1)
    span = g.max() - g.min()
    return (g - g.min()) / (span if span > 0 else 1.0)


def main(argv):
    args = get_cam_arguments(argv)
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)

    from PIL import Image

    from wseg_tpu_torch.data.pascal_voc import (
        MEAN,
        STD,
        labels_from_mask,
        read_filelist,
    )
    from wseg_tpu_torch.engine.writers import ResultWriter
    from wseg_tpu_torch.gradcam import aug_smooth, get_cam_method
    from wseg_tpu_torch.infer_val import load_serving_model

    device = get_device(args)
    num_classes = int(cfg.TEST.NUM_CLASSES)
    model = load_serving_model(args, device)
    cam = get_cam_method(args.method)(model)
    writer = ResultWriter(args.mask_output_dir, prospect_thresh=0.0,
                          use_crf=False)

    entries = read_filelist(args.infer_list, cfg.TEST.DATA_ROOT)
    mean = np.asarray(MEAN, np.float32)
    std = np.asarray(STD, np.float32)
    align = int(args.pad_align)
    for i, (img_path, mask_path) in enumerate(entries):
        with Image.open(img_path) as im:
            image = np.asarray(im.convert("RGB"), np.uint8)
        gt_mask = None
        if mask_path and os.path.isfile(mask_path):
            with Image.open(mask_path) as m:
                gt_mask = np.asarray(m, np.int32)
        labels = (labels_from_mask(gt_mask, num_class=num_classes)
                  if gt_mask is not None
                  else np.ones(num_classes - 1, np.float32))

        arr = (image.astype(np.float32) / 255.0 - mean) / std
        h, w = arr.shape[:2]
        if align > 0:
            arr = np.pad(arr, ((0, -h % align), (0, -w % align), (0, 0)))
        x = arr[None]
        masks_pred = np.zeros((h, w, num_classes), np.float32)
        for label in np.nonzero(labels)[0]:
            if args.aug_smooth:
                m = aug_smooth(cam, x, target_category=int(label),
                               eigen_smooth=args.eigen_smooth)
            else:
                m = cam(x, target_category=int(label),
                        eigen_smooth=args.eigen_smooth)
            if m.ndim == 4:  # guided backprop's (B, H, W, 3) gradient
                m = guided_to_map(m)
            masks_pred[..., int(label) + 1] = m[0, :h, :w]

        writer.save(img_path, image.astype(np.float32) / 255.0, masks_pred,
                    gt_mask)
        if i % 50 == 0:
            print(f"[{i}/{len(entries)}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
