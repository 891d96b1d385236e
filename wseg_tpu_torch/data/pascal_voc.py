"""Pascal VOC host helpers: filelists, labels from masks, the palette.

The pieces of ``wseg_tpu/data/pascal_voc.py`` that inference needs,
without its image-library imports.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

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
