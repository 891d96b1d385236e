"""Exact permutohedral lattice filter (the port's counterpart of
``wseg_tpu/ops/crf_lattice.py``).

The SAME splat -> blur -> slice arithmetic as the host library
(``csrc/permutohedral_host.cc``, ``Permutohedral::compute``): splat with
the barycentric weights, a [1, 2, 1]/2 blur along each of the d+1
lattice axes reading neighbour rows by index, slice with the gain
``1/(1 + 2^-d)``.  The lattice hash is built on the host
(``ops/crf_exact.build_exact_lattice``); every filter step runs where
the tables are, through the wrappers of ``ops/crf_lattice_cuda``: the
plain torch versions for CPU tensors, the CUDA kernels on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from wseg_tpu_torch.ops.crf_lattice_cuda import (
    lattice_blur,
    lattice_slice,
    lattice_splat,
)


class LatticeTables(NamedTuple):
    """One image's lattice on a canvas of Np pixels.

    ``ids``/``w``: (Np, d+1) int32/float32 splat/slice vertex ids and
    barycentric weights per pixel; padded canvas pixels hold the zero
    slot ``m`` and weight 0.  ``nbr``: (d+1, m, 2) int32 blur neighbours
    per axis, missing ones encoded as ``m``.  ``row_ptr`` (m+1,),
    ``entries`` (E,) and ``w_csr`` (E,): the splat table vertex-major,
    each entry ``pixel*(d+1) + slot`` with its weight, over the real
    pixels only.  ``m``: lattice points.
    """
    ids: torch.Tensor
    w: torch.Tensor
    nbr: torch.Tensor
    row_ptr: torch.Tensor
    entries: torch.Tensor
    w_csr: torch.Tensor
    m: int

    @property
    def d1(self) -> int:
        return self.ids.shape[1]

    @property
    def alpha(self) -> float:
        return 1.0 / (1.0 + 2.0 ** -(self.d1 - 1))

    def to(self, device) -> "LatticeTables":
        return LatticeTables(*(t.to(device) for t in self[:-1]), self.m)


def bilateral_features(img_rgb: np.ndarray, sxy: float,
                       srgb: float) -> np.ndarray:
    """(H, W, 3) uint8 -> (H*W, 5) float32 bilateral lattice features
    (x/sxy, y/sxy, rgb/srgb)."""
    h, w, _ = img_rgb.shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.empty((h, w, 5), np.float32)
    f[..., 0] = x / sxy
    f[..., 1] = y / sxy
    f[..., 2:] = img_rgb.astype(np.float32) / srgb
    return f.reshape(-1, 5)


def gaussian_features(hw, sxy: float) -> np.ndarray:
    """(h, w) -> (h*w, 2) float32 spatial lattice features (x/sxy,
    y/sxy); image-independent."""
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([x / sxy, y / sxy], axis=-1).reshape(-1, 2)


def lattice_filter(values: torch.Tensor, tables: LatticeTables,
                   w_pix: Optional[torch.Tensor] = None,
                   w_csr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact permutohedral filter: values (Np, C) float32 -> (Np, C).

    ``w_pix``/``w_csr`` replace the tables' weights on the slice and the
    splat side (the norm-folded weights of ``lattice_weights``); the
    raw barycentric weights by default.  The d+1 blurs read one buffer
    and write a new one, so the zero slot stays zero."""
    d1 = tables.d1
    lat = lattice_splat(tables.row_ptr, tables.entries,
                        tables.w_csr if w_csr is None else w_csr,
                        values.contiguous(), d1)
    for j in range(d1):
        lat = lattice_blur(lat, tables.nbr[j])
    return lattice_slice(lat, tables.ids,
                         tables.w if w_pix is None else w_pix, tables.alpha)


def kernel_norm(tables: LatticeTables) -> torch.Tensor:
    """Symmetric normalisation 1/sqrt(K(1)) per pixel, (Np,) float32;
    padded pixels (weight 0) get 0 so they stay inert."""
    ones = torch.ones((tables.ids.shape[0], 1), dtype=torch.float32,
                      device=tables.ids.device)
    k1 = lattice_filter(ones, tables)[:, 0]
    return torch.where(k1 > 1e-20, torch.rsqrt(torch.clamp(k1, min=1e-20)),
                       torch.zeros_like(k1))
