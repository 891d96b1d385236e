"""ctypes binding for the host permutohedral lattice (the port's copy of
``wseg_tpu/ops/crf_native.py``).

The C++ source is ``csrc/permutohedral_host.cc``, built with the host
C++ compiler on first use (``_build``).  It gives the exact dense-CRF
mean field of the reference's pydensecrf semantics
(``crf_inference_native``, the host oracle), the raw lattice filter
(``permutohedral_filter``) and the lattice tables that the device path
runs on (``build_lattice_tables``).  Where the JAX
module falls back to an approximate numpy CRF, this one raises: the
library is built from the checkout or nothing runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np

from wseg_tpu_torch import _build

_P = ctypes.c_void_p

# the reference's dense-CRF parameters (its utils/dcrf.py): Gaussian
# kernel x/y scale and weight, bilateral x/y and colour scales and weight
SXY_GAUSSIAN, COMPAT_GAUSSIAN = 3.0, 3.0
SXY_BILATERAL, SRGB, COMPAT_BILATERAL = 80.0, 13.0, 10.0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("permutohedral_host")
    lib.wseg_densecrf_inference.restype = ctypes.c_int
    lib.wseg_densecrf_inference.argtypes = [
        _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float]
    lib.wseg_permutohedral_filter.restype = ctypes.c_int
    lib.wseg_permutohedral_filter.argtypes = [
        _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P]
    lib.wseg_permutohedral_build.restype = ctypes.c_void_p
    lib.wseg_permutohedral_build.argtypes = [
        _P, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.wseg_permutohedral_export.restype = ctypes.c_int
    lib.wseg_permutohedral_export.argtypes = [_P, _P, _P, _P]
    lib.wseg_permutohedral_export_csr.restype = ctypes.c_int
    lib.wseg_permutohedral_export_csr.argtypes = [_P, _P, _P, _P, _P]
    lib.wseg_permutohedral_free.restype = None
    lib.wseg_permutohedral_free.argtypes = [_P]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class HostLattice(NamedTuple):
    """One lattice's tables, as the C++ build exports them.

    ``offsets``/``bary``: (N, d+1) int32/float32 splat/slice vertex ids
    and weights per feature row.  ``nbr``: (d+1, m, 2) int32 blur
    neighbours per axis, a missing neighbour encoded as ``m`` (the zero
    slot).  ``row_ptr`` (m+1,), ``entries`` (N*(d+1),) and ``w_csr``
    (N*(d+1),): the splat table transposed to vertex-major order, each
    entry ``pixel*(d+1) + slot`` with its weight, ascending within a
    vertex's row.  ``m``: lattice points.
    """
    offsets: np.ndarray
    bary: np.ndarray
    nbr: np.ndarray
    row_ptr: np.ndarray
    entries: np.ndarray
    w_csr: np.ndarray
    m: int


def build_lattice_tables(features: np.ndarray,
                         pixel_of_row: Optional[np.ndarray] = None
                         ) -> HostLattice:
    """Hash ``features`` (N, d) float32 into a permutohedral lattice and
    export its tables; the first four fields are what
    ``wseg_tpu.ops.crf_native.build_lattice_tables`` returns.
    ``pixel_of_row`` (N,) increasing int32: the canvas pixel of each
    feature row, used for the CSR's entries (the identity when None)."""
    lib = _library()
    n, d = features.shape
    f = np.ascontiguousarray(features, np.float32)
    m_out = ctypes.c_int(0)
    handle = lib.wseg_permutohedral_build(_ptr(f), d, n, ctypes.byref(m_out))
    if not handle:
        raise RuntimeError("permutohedral lattice build failed")
    m = int(m_out.value)
    offsets = np.empty((n, d + 1), np.int32)
    bary = np.empty((n, d + 1), np.float32)
    nbr = np.empty((d + 1, m, 2), np.int32)
    row_ptr = np.empty(m + 1, np.int32)
    entries = np.empty(n * (d + 1), np.int32)
    w_csr = np.empty(n * (d + 1), np.float32)
    pix = None
    if pixel_of_row is not None:
        pix = np.ascontiguousarray(pixel_of_row, np.int32)
        if pix.shape != (n,):
            raise ValueError(f"pixel_of_row {pix.shape} for {n} rows")
    try:
        rc = lib.wseg_permutohedral_export(handle, _ptr(offsets), _ptr(bary),
                                           _ptr(nbr))
        rc |= lib.wseg_permutohedral_export_csr(
            handle, None if pix is None else _ptr(pix), _ptr(row_ptr),
            _ptr(entries), _ptr(w_csr))
    finally:
        lib.wseg_permutohedral_free(handle)
    if rc != 0:
        raise RuntimeError("permutohedral table export failed")
    return HostLattice(offsets, bary, nbr, row_ptr, entries, w_csr, m)


def permutohedral_filter(features: np.ndarray,
                         values: np.ndarray) -> np.ndarray:
    """Raw lattice filter: features (N, d), values (N, C) -> (N, C)."""
    lib = _library()
    n, d = features.shape
    f = np.ascontiguousarray(features, np.float32)
    v = np.ascontiguousarray(values, np.float32)
    out = np.empty_like(v)
    if lib.wseg_permutohedral_filter(_ptr(f), d, n, _ptr(v), v.shape[1],
                                     _ptr(out)) != 0:
        raise RuntimeError("permutohedral filter failed")
    return out


def crf_inference_native(img: np.ndarray, probs: np.ndarray,
                         t: int = 10) -> np.ndarray:
    """Exact mean-field dense CRF on the host with the reference's
    parameters: img (H, W, 3) uint8, probs (H, W, C) float32 -> Q
    (H, W, C) float32."""
    lib = _library()
    h, w, c = probs.shape
    img_c = np.ascontiguousarray(img, np.uint8)
    if img_c.shape != (h, w, 3):
        raise ValueError(f"image {img_c.shape} for probs {probs.shape}")
    probs_c = np.ascontiguousarray(probs, np.float32)
    out = np.empty_like(probs_c)
    rc = lib.wseg_densecrf_inference(
        _ptr(img_c), h, w, c, _ptr(probs_c), _ptr(out), int(t),
        SXY_GAUSSIAN, COMPAT_GAUSSIAN, SXY_BILATERAL, SRGB, COMPAT_BILATERAL)
    if rc != 0:
        raise RuntimeError("dense CRF inference failed")
    return out
