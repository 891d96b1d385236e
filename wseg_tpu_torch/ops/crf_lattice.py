"""Exact permutohedral lattice filter (the port's counterpart of
``wseg_tpu/ops/crf_lattice.py``).

The SAME splat -> blur -> slice arithmetic as the host library
(``csrc/permutohedral_host.cc``, ``Permutohedral::compute``): splat with
the barycentric weights, a [1, 2, 1]/2 blur along each of the d+1
lattice axes reading neighbour rows by index, slice with the gain
``1/(1 + 2^-d)``.  The lattice hash is built on the host
(``ops/crf_exact.build_exact_lattice``); every filter runs where the
tables are, through ``ops/crf_lattice_cuda.lattice_filter_cuda``: the
plain torch versions for CPU tensors, one host call of the CUDA kernels
on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from wseg_tpu_torch.ops.crf_lattice_cuda import lattice_filter_cuda

# Entries per chunk of the splat's split table: one warp of the splat
# kernel loads a chunk's entries in one pass, a lane each (chunks of 32,
# 64, 128 and 256 were timed on the H100; 32 was the fastest).
SPLAT_CHUNK = 32


class LatticeTables(NamedTuple):
    """One image's lattice on a canvas of Np pixels.

    ``ids``/``w``: (Np, d+1) int32/float32 splat/slice vertex ids and
    barycentric weights per pixel; padded canvas pixels hold the zero
    slot ``m`` and weight 0.  ``nbr``: (d+1, m, 2) int32 blur neighbours
    per axis, missing ones encoded as ``m``.  ``entries`` (E,) and
    ``w_csr`` (E,): the splat table vertex-major, each entry
    ``pixel*(d+1) + slot`` with its weight, over the real pixels only,
    cut into chunks by ``chunk_ptr``, ``chunk_row`` and ``splits`` (the
    split table, ``split_table``).  ``m``: lattice points.
    """
    ids: torch.Tensor
    w: torch.Tensor
    nbr: torch.Tensor
    entries: torch.Tensor
    w_csr: torch.Tensor
    chunk_ptr: torch.Tensor
    chunk_row: torch.Tensor
    splits: torch.Tensor
    m: int

    @property
    def d1(self) -> int:
        return self.ids.shape[1]

    @property
    def alpha(self) -> float:
        return 1.0 / (1.0 + 2.0 ** -(self.d1 - 1))

    @property
    def row_ptr(self) -> torch.Tensor:
        """The CSR row pointers (m+1,) of ``entries``: the first chunk of
        each row and of the zero slot starts its row."""
        first = torch.ones_like(self.chunk_row, dtype=torch.bool)
        first[1:] = self.chunk_row[1:] != self.chunk_row[:-1]
        return self.chunk_ptr[:-1][first]

    def to(self, device) -> "LatticeTables":
        return LatticeTables(*(t.to(device) for t in self[:-1]), self.m)


def split_table(row_ptr: np.ndarray):
    """The splat's work table for the CSR ``row_ptr`` (m+1,): every row
    cut into chunks of at most ``SPLAT_CHUNK`` entries, in entry order;
    an empty row, and the zero slot m after the last row, are one empty
    chunk each.  Returns int32 ``chunk_ptr`` (n+1,), chunk c spanning
    entries [chunk_ptr[c], chunk_ptr[c+1]); ``chunk_row`` (n,), its row;
    ``splits`` (s, 2), the [first, end) chunks of each row cut in
    several, in row order."""
    k = SPLAT_CHUNK
    row_ptr = np.asarray(row_ptr, np.int64)
    lens = np.diff(row_ptr)
    n_ch = np.append(np.maximum(1, -(-lens // k)), 1)
    first = np.cumsum(n_ch) - n_ch
    chunk_row = np.repeat(np.arange(n_ch.size), n_ch)
    chunk_ptr = np.append(
        row_ptr[chunk_row] + (np.arange(chunk_row.size) - first[chunk_row]) * k,
        row_ptr[-1])
    cut = np.flatnonzero(n_ch > 1)
    splits = np.stack([first[cut], first[cut] + n_ch[cut]], axis=1)
    return (chunk_ptr.astype(np.int32), chunk_row.astype(np.int32),
            splits.astype(np.int32).reshape(-1, 2))


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
    raw barycentric weights by default.  The zero slot stays zero
    through the d+1 blurs."""
    return lattice_filter_cuda(values.contiguous(), tables,
                               tables.w if w_pix is None else w_pix,
                               tables.w_csr if w_csr is None else w_csr)


def kernel_norm(tables: LatticeTables) -> torch.Tensor:
    """Symmetric normalisation 1/sqrt(K(1)) per pixel, (Np,) float32;
    padded pixels (weight 0) get 0 so they stay inert."""
    ones = torch.ones((tables.ids.shape[0], 1), dtype=torch.float32,
                      device=tables.ids.device)
    k1 = lattice_filter(ones, tables)[:, 0]
    return torch.where(k1 > 1e-20, torch.rsqrt(torch.clamp(k1, min=1e-20)),
                       torch.zeros_like(k1))
