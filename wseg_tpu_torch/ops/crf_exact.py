"""Exact mean-field dense CRF over the permutohedral lattice (the port's
counterpart of ``wseg_tpu/ops/crf_mm.py``'s ``build_mm_lattice`` and
``crf_exact_mm``).

The host builds each lattice (``build_exact_lattice``): the C++ hash
over the image's real pixels, embedded in the padded merge canvas the
device maps live on, with the vertex-major splat table and its split
table beside the pixel-major one.  ``crf_exact`` then runs where the
tables are: the two norm filters with the raw weights,
``lattice_weights`` to fold the norm into both weight layouts, and t
mean-field iterations of one Gaussian and one bilateral filter each,
the elementwise update in torch.  The
semantics are those of the host oracle (``crf_native.
crf_inference_native``, pydensecrf's): unary ``-log(max(p, 1e-8))``, Q
starts at p, ``softmax(-unary + 3 K_g(Q) + 10 K_b(Q))`` with the
symmetric norm, the self term included.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wseg_tpu_torch.ops.crf_lattice import (
    LatticeTables,
    kernel_norm,
    lattice_filter,
    split_table,
)
from wseg_tpu_torch.ops.crf_lattice_cuda import lattice_weights
from wseg_tpu_torch.ops.crf_native import (
    COMPAT_BILATERAL,
    COMPAT_GAUSSIAN,
    build_lattice_tables,
)


def build_exact_lattice(features: np.ndarray, n_pix: Optional[int] = None,
                        valid_mask: Optional[np.ndarray] = None
                        ) -> LatticeTables:
    """Host lattice build -> CPU ``LatticeTables``.

    ``features``: (N, d) float32, pre-divided by the kernel sigmas, one
    row per real pixel in canvas order.  ``n_pix``/``valid_mask``: the
    canvas has ``n_pix`` pixels of which ``valid_mask`` (n_pix,) marks
    the N real ones; the rest get the zero slot and weight 0.  Without
    them the features are the whole canvas."""
    pix = None
    if n_pix is not None:
        pix = np.flatnonzero(valid_mask).astype(np.int32)
        if pix.shape[0] != features.shape[0]:
            raise ValueError(f"{pix.shape[0]} valid pixels for "
                             f"{features.shape[0]} feature rows")
    lat = build_lattice_tables(features, pix)
    ids, w = lat.offsets, lat.bary
    if pix is not None:
        d1 = ids.shape[1]
        ids = np.full((n_pix, d1), lat.m, np.int32)
        w = np.zeros((n_pix, d1), np.float32)
        ids[pix] = lat.offsets
        w[pix] = lat.bary
    return LatticeTables(*(torch.from_numpy(a) for a in (
        ids, w, lat.nbr, lat.entries, lat.w_csr,
        *split_table(lat.row_ptr))), lat.m)


def crf_exact(probs: torch.Tensor, lat_g: LatticeTables,
              lat_b: LatticeTables, t: int = 10,
              compat_gaussian: float = COMPAT_GAUSSIAN,
              compat_bilateral: float = COMPAT_BILATERAL) -> torch.Tensor:
    """Exact mean-field dense CRF for one image: probs (H, W, C) on the
    tables' canvas -> Q (H, W, C) float32.  Padded canvas pixels may
    hold anything; their weight-0 tables keep them inert."""
    h, w, c = probs.shape
    p = probs.reshape(h * w, c).float()
    folded = []
    for lat in (lat_g, lat_b):
        norm = kernel_norm(lat)
        folded.append(lattice_weights(lat.w, lat.w_csr, lat.entries, norm))
    unary = -torch.log(torch.clamp(p, min=1e-8))
    q = p
    for _ in range(int(t)):
        mg = lattice_filter(q, lat_g, *folded[0])
        mb = lattice_filter(q, lat_b, *folded[1])
        q = torch.softmax(-unary + compat_gaussian * mg
                          + compat_bilateral * mb, dim=-1)
    return q.reshape(h, w, c)
