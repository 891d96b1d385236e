"""Mask evaluation of the port (same flags, output table and score log
as the root ``eval_seg.py``).

    python -m wseg_tpu_torch.eval_seg --data DATA_ROOT \\
        --filelist DATA_ROOT/val_voc.txt --masks MASK_DIR/crf \\
        [--oracle-from HxW] [--log-scores scores.log]

Reads predicted and GT PNGs from a filelist, accumulates a confusion
matrix, prints per-class IoU/Pr/Re with and without background, and
logs per-image scores sorted per class.  Host only (numpy and PIL; the
GT oracle also needs OpenCV).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from wseg_tpu_torch.data.pascal_voc import CLASSES, CLASS_IDX
from wseg_tpu_torch.utils.metrics import (
    confusion_matrix,
    iou_from_confusion,
    per_image_score,
)

parser = argparse.ArgumentParser(description="Mask Evaluation")
parser.add_argument("--data", type=str, default="./data/annotation")
parser.add_argument("--filelist", type=str, default="./data/val.txt")
parser.add_argument("--masks", type=str, default="./masks")
parser.add_argument("--oracle-from", type=str, default="",
                    help="Use GT masks but down- then upscale them (HxW)")
parser.add_argument("--log-scores", type=str, default="./scores.log")


def oracle_lower(mask: np.ndarray, h: int, w: int,
                 alpha: float = 0.5) -> np.ndarray:
    """GT down/up-scale oracle (reference eval_seg.py:192-215): each
    class's 0/1 mask is resized to h x w, quantised x255 to uint8 (as
    ``scipy.misc.imresize`` rescaled it), resized back, and kept where it
    exceeds ``alpha``.  Both resizes are OpenCV's INTER_LINEAR."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("--oracle-from needs OpenCV (cv2), which is not "
                           "installed") from e
    new_mask = np.zeros_like(mask)
    H, W = mask.shape
    for label in np.unique(mask):
        if label in (0, 255):
            continue
        m = (mask == label).astype(np.float32)
        down = cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)
        down = np.clip(np.round(down * 255.0), 0, 255).astype(np.uint8)
        up = cv2.resize(down, (W, H), interpolation=cv2.INTER_LINEAR)
        new_mask[up > alpha] = label
    return new_mask


def evaluate_all(args):
    """Confusion matrix (21, 21) over the filelist; writes the per-class
    score log to ``args.log_scores``."""
    from PIL import Image

    with_oracle = False
    if args.oracle_from:
        oh, ow = (int(x) for x in args.oracle_from.split("x"))
        with_oracle = oh > 1 and ow > 1
        if with_oracle:
            print(f">>> Using oracle {oh}x{ow}")

    M = np.zeros((21, 21))
    class_stats = {i: [] for i in range(21)}
    num_im = 0

    with open(args.filelist) as fd:
        lines = fd.readlines()

    for line in lines:
        files = [x.strip("/ \n") for x in line.split(" ")]
        if len(files) < 2:
            print("No path to GT mask found in line\n\t{}".format(line))
            continue
        gt_path = os.path.join(args.data, files[1])
        if not os.path.isfile(gt_path):
            print("File not found (GT): {}".format(gt_path))
            continue
        mask_gt = np.asarray(Image.open(gt_path))

        if with_oracle:
            mask = oracle_lower(mask_gt, oh, ow)
        else:
            base = os.path.basename(files[1]).split(".")[0] + ".png"
            pred_path = os.path.join(args.masks, base)
            if not os.path.isfile(pred_path):
                print("File not found: {}".format(pred_path))
                continue
            mask = np.asarray(Image.open(pred_path))

        if mask.shape != mask_gt.shape:
            print("Mask shape mismatch:", mask.shape, "vs", mask_gt.shape)
            continue

        M_one = confusion_matrix(mask_gt, mask)
        M += M_one
        name = os.path.basename(files[0]).replace(".jpg", "")
        scores = per_image_score(M_one, np.unique(mask_gt))
        for cls_i, sc in scores.items():
            class_stats[cls_i].append((name, sc))
        num_im += 1

    print("# of images: {}".format(num_im))

    data = ""
    for cat in CLASSES:
        if cat == "ambiguous":
            continue
        i = CLASS_IDX[cat]
        data += cat + "\n"
        for name, score in sorted(class_stats[i], key=lambda x: -x[1]):
            data += "{:05d} | {}\n".format(int(score), name)
    with open(args.log_scores, "w") as f:
        f.write(data)

    return M


def summarise_stats(M):
    """Print the per-class table and the mIoU lines; returns the stats."""
    stats = iou_from_confusion(M)
    head_fmt = "{:>12} | {:>5}" + " | {:>5}" * 3
    row_fmt = "{:>12} | {:>5}" + " | {:>5.1f}" * 3
    split = "-" * 44
    print(head_fmt.format("Class", "#", "IoU", "Pr", "Re"))
    print(split)
    for cat in CLASSES:
        if cat == "ambiguous":
            continue
        i = CLASS_IDX[cat]
        count = int(np.sum(M[i, :]))
        print(row_fmt.format(cat, count, stats["iou"][i],
                             stats["precision"][i], stats["recall"][i]))
    print(split)
    print("mIoU: {:.2f}\t  Pr: {:.2f}\t  Re: {:.2f}".format(
        stats["miou"], stats["mprecision"], stats["mrecall"]))
    print(split)
    print("With background: ")
    print("mIoU: {:.2f}\t  Pr: {:.2f}\t  Re: {:.2f}".format(
        stats["miou_bkg"], stats["mprecision_bkg"], stats["mrecall_bkg"]))
    return stats


def main(argv):
    args = parser.parse_args(argv)
    print(args)
    return summarise_stats(evaluate_all(args))


if __name__ == "__main__":
    main(sys.argv[1:])
