"""Pascal VOC host helpers and the training dataset.

Filelists, labels from masks, the palette (what inference needs, with
no image-library import at module level) and ``VOCSegmentation``, the
augmenting train/validation dataset of ``wseg_tpu/data/pascal_voc.py``
(uint8 transfer; PIL is imported when the dataset is built).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "potted-plant", "sheep", "sofa", "train",
    "tv/monitor", "ambiguous",
]
CLASS_IDX = {name: (255 if name == "ambiguous" else i)
             for i, name in enumerate(CLASSES)}
NUM_CLASS = 21
AMBIGUOUS = 255

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def voc_colormap(n: int = 256) -> np.ndarray:
    """VOC bit-twiddle colormap."""
    def bitget(v, i):
        return (v >> i) & 1

    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def get_palette() -> List[int]:
    """Flat 768-entry palette for indexed PNGs."""
    return voc_colormap().reshape(-1).tolist()


def labels_from_mask(mask: np.ndarray, num_class: int = NUM_CLASS
                     ) -> np.ndarray:
    """Multi-hot (C-1,) image labels from a GT index mask, ignoring
    background and ambiguous."""
    unique = np.unique(mask)
    unique = unique[(unique != 0) & (unique != AMBIGUOUS)
                    & (unique < num_class)]
    labels = np.zeros(num_class - 1, np.float32)
    labels[unique - 1] = 1.0
    return labels


def read_filelist(path: str, root: str = "") -> List[Tuple[str, str]]:
    """Parse '<image> <mask>' lines; paths joined onto ``root``."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(" ")
            img = os.path.join(root, parts[0].lstrip("/"))
            msk = os.path.join(root, parts[1].lstrip("/")) \
                if len(parts) > 1 else ""
            entries.append((img, msk))
    return entries


class VOCSegmentation:
    """Training/validation dataset with joint augmentation.

    ``__getitem__`` -> (image uint8 HWC, labels (C-1,) float32, name,
    mask HW int32[, jitter (9,) float32]).  ``augment`` (training):
    random resized crop to ``CROP_SIZE``, horizontal flip, and colour
    jitter, either on the host or, with ``device_jitter``, sampled here
    after the pipeline from the same rng (its position in the stream is
    the host jitter's) and applied by the train step on the device.
    Without ``augment`` (validation): resize + centre crop.
    """

    def __init__(self, data_cfg, split: str, augment: bool = True,
                 seed: int = 0, device_jitter: bool = False):
        from wseg_tpu_torch.data import transforms as tf

        self.root = data_cfg.ROOT
        self.split = split
        self.entries = read_filelist(
            os.path.join(self.root, split + ".txt"), self.root)
        self.augment = augment
        crop = int(data_cfg.CROP_SIZE)
        self.device_jitter = bool(device_jitter and augment)
        if augment:
            jit = [] if self.device_jitter else [tf.MaskColourJitter(p=1.0)]
            self.transform = tf.Compose([
                tf.MaskRandResizedCrop(crop, float(data_cfg.SCALE_FROM),
                                       float(data_cfg.SCALE_TO)),
                tf.MaskHFlip(), *jit, tf.MaskToUint8()])
        else:
            self.transform = tf.Compose([tf.MaskCenterCrop(crop),
                                         tf.MaskToUint8()])
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index: int):
        from PIL import Image

        from wseg_tpu_torch.ops.jitter import sample_colour_jitter

        img_path, mask_path = self.entries[index]
        with Image.open(img_path) as im:
            image = im.convert("RGB")
        with Image.open(mask_path) as m:
            mask = m.copy()
        image, mask = self.transform(image, mask, self.rng)
        mask_np = np.asarray(mask, np.int32)
        out = (image, labels_from_mask(mask_np), os.path.basename(img_path),
               mask_np)
        if self.device_jitter:
            out = out + (sample_colour_jitter(self.rng, p=1.0),)
        return out
