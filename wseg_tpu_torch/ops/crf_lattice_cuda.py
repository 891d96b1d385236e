"""Exact permutohedral filter steps: CUDA kernel wrappers and their plain
versions.

Port of the TPU kernels of ``wseg_tpu/ops/crf_mm.py`` (``_ohgen_call``,
``_splat_call``, ``_gather_call``), which build the filter from dense
multi-hot matmuls; here the same operators run over the sparse lattice
tables (``csrc/crf_lattice.cu``, whose header says how):

- ``lattice_weights``: the splat/slice weights with the symmetric norm
  folded in, pixel-major and vertex-major;
- ``lattice_splat``: lattice rows from pixel values along the CSR;
- ``lattice_blur``: the [1, 2, 1]/2 blur along one lattice axis;
- ``lattice_slice``: pixel values from their d+1 lattice vertices.

Each wrapper dispatches on the tensors' device: CPU tensors go to the
``*_reference`` version (``index_add_``, indexing, ``einsum``), CUDA
tensors launch the kernel (built on first use) or raise.  Each wrapper's
``.launches`` counts its kernel launches.  The lattice has m vertex rows
plus the zero slot, row m.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from wseg_tpu_torch import _build

_count_lock = threading.Lock()


def _count(fn) -> None:
    with _count_lock:  # the serving CRF pool launches from two threads
        fn.launches += 1


# ------------------------------------------------------- plain versions
def lattice_weights_reference(w_pix: torch.Tensor, w_csr: torch.Tensor,
                              entries: torch.Tensor, norm: torch.Tensor):
    """(w_pix * norm[pixel], w_csr * norm[entries // (d+1)])."""
    d1 = w_pix.shape[1]
    return (w_pix * norm[:, None],
            w_csr * norm[torch.div(entries.long(), d1,
                                   rounding_mode="floor")])


def lattice_splat_reference(row_ptr: torch.Tensor, entries: torch.Tensor,
                            w_csr: torch.Tensor, q: torch.Tensor,
                            d1: int) -> torch.Tensor:
    """(m+1, C) lattice, row v the weighted sum of its CSR row's pixel
    values, row m zero; ``index_add_`` in entry order."""
    m = row_ptr.numel() - 1
    vertex = torch.repeat_interleave(
        torch.arange(m, device=q.device), (row_ptr[1:] - row_ptr[:-1]).long())
    pix = torch.div(entries.long(), d1, rounding_mode="floor")
    lat = torch.zeros((m + 1, q.shape[1]), dtype=torch.float32,
                      device=q.device)
    return lat.index_add_(0, vertex, w_csr[:, None] * q[pix])


def lattice_blur_reference(lat: torch.Tensor,
                           nbr: torch.Tensor) -> torch.Tensor:
    """One axis: rows v < m become lat[v] + (lat[n1] + lat[n2]) / 2 with
    ``nbr`` (m, 2); the zero slot stays zero."""
    m = nbr.shape[0]
    n = nbr.long()
    body = lat[:m] + 0.5 * (lat[n[:, 0]] + lat[n[:, 1]])
    return torch.cat([body, torch.zeros_like(lat[m:])], dim=0)


def lattice_slice_reference(lat: torch.Tensor, ids: torch.Tensor,
                            wn: torch.Tensor, alpha: float) -> torch.Tensor:
    """(Np, C): alpha * sum over the d+1 slots of wn * lat[ids]."""
    return alpha * torch.einsum("ps,psc->pc", wn, lat[ids.long()])


# ------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("crf_lattice")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wseg_lattice_weights.argtypes = [p, p, p, p, ll, ll, i, p, p, p]
    lib.wseg_lattice_splat.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.wseg_lattice_blur.argtypes = [p, p, i, i, p, p]
    lib.wseg_lattice_slice.argtypes = [p, p, p, i, i, i, ctypes.c_float, p, p]
    for name in ("wseg_lattice_weights", "wseg_lattice_splat",
                 "wseg_lattice_blur", "wseg_lattice_slice"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(name: str, **tensors: Tuple[torch.Tensor, torch.dtype, int]):
    """dtype and rank of each tensor; one device for all.  Returns the
    device type: "cpu" for the plain version, "cuda" for the kernel."""
    devices = set()
    for arg, (t, dtype, dim) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name}: {arg} must be {dim}-D, got "
                             f"{tuple(t.shape)}")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t, _, _ in tensors.values()):
        raise ValueError(f"{name}: kernel tensors must be contiguous")
    return "cuda"


def _launch(fn, what: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def lattice_weights(w_pix: torch.Tensor, w_csr: torch.Tensor,
                    entries: torch.Tensor, norm: torch.Tensor):
    """Fold the per-pixel norm into the splat/slice weights: w_pix (Np,
    d+1), w_csr (E,), entries (E,) int32, norm (Np,) -> (wn_pix, wn_csr).
    """
    f32, i32 = torch.float32, torch.int32
    where = _check("lattice_weights", w_pix=(w_pix, f32, 2),
                   w_csr=(w_csr, f32, 1), entries=(entries, i32, 1),
                   norm=(norm, f32, 1))
    if norm.shape[0] != w_pix.shape[0] or w_csr.shape != entries.shape:
        raise ValueError(f"lattice_weights: w_pix {tuple(w_pix.shape)}, "
                         f"norm {tuple(norm.shape)}, w_csr "
                         f"{tuple(w_csr.shape)}, entries "
                         f"{tuple(entries.shape)}")
    if where == "cpu":
        return lattice_weights_reference(w_pix, w_csr, entries, norm)
    wn_pix, wn_csr = torch.empty_like(w_pix), torch.empty_like(w_csr)
    _launch(_library().wseg_lattice_weights, "lattice_weights", w_pix.device,
            w_pix.data_ptr(), w_csr.data_ptr(), entries.data_ptr(),
            norm.data_ptr(), w_pix.numel(), w_csr.numel(), w_pix.shape[1],
            wn_pix.data_ptr(), wn_csr.data_ptr())
    _count(lattice_weights)
    return wn_pix, wn_csr


def lattice_splat(row_ptr: torch.Tensor, entries: torch.Tensor,
                  w_csr: torch.Tensor, q: torch.Tensor,
                  d1: int) -> torch.Tensor:
    """row_ptr (m+1,) int32, entries/w_csr (E,), q (Np, C) float32 with
    C <= 32 -> (m+1, C) float32 lattice (row m zero).  Deterministic."""
    f32, i32 = torch.float32, torch.int32
    where = _check("lattice_splat", row_ptr=(row_ptr, i32, 1),
                   entries=(entries, i32, 1), w_csr=(w_csr, f32, 1),
                   q=(q, f32, 2))
    if w_csr.shape != entries.shape or not 1 <= q.shape[1] <= 32:
        raise ValueError(f"lattice_splat: entries {tuple(entries.shape)}, "
                         f"w_csr {tuple(w_csr.shape)}, q {tuple(q.shape)} "
                         "(1 to 32 channels)")
    if where == "cpu":
        return lattice_splat_reference(row_ptr, entries, w_csr, q, d1)
    m = row_ptr.numel() - 1
    lat = torch.empty((m + 1, q.shape[1]), dtype=f32, device=q.device)
    _launch(_library().wseg_lattice_splat, "lattice_splat", q.device,
            row_ptr.data_ptr(), entries.data_ptr(), w_csr.data_ptr(),
            q.data_ptr(), m, q.shape[1], int(d1), lat.data_ptr())
    _count(lattice_splat)
    return lat


def lattice_blur(lat: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """lat (m+1, C) float32, nbr (m, 2) int32 neighbours along one axis
    (missing = m) -> a new (m+1, C) lattice; ``lat`` is not written."""
    where = _check("lattice_blur", lat=(lat, torch.float32, 2),
                   nbr=(nbr, torch.int32, 2))
    m = nbr.shape[0]
    if lat.shape[0] != m + 1 or nbr.shape[1] != 2:
        raise ValueError(f"lattice_blur: lat {tuple(lat.shape)}, nbr "
                         f"{tuple(nbr.shape)}")
    if where == "cpu":
        return lattice_blur_reference(lat, nbr)
    out = torch.empty_like(lat)
    _launch(_library().wseg_lattice_blur, "lattice_blur", lat.device,
            lat.data_ptr(), nbr.data_ptr(), m, lat.shape[1], out.data_ptr())
    _count(lattice_blur)
    return out


def lattice_slice(lat: torch.Tensor, ids: torch.Tensor, wn: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    """lat (m+1, C), ids (Np, d+1) int32, wn (Np, d+1) float32 ->
    (Np, C) float32 pixel values."""
    f32 = torch.float32
    where = _check("lattice_slice", lat=(lat, f32, 2),
                   ids=(ids, torch.int32, 2), wn=(wn, f32, 2))
    if ids.shape != wn.shape:
        raise ValueError(f"lattice_slice: ids {tuple(ids.shape)}, wn "
                         f"{tuple(wn.shape)}")
    if where == "cpu":
        return lattice_slice_reference(lat, ids, wn, alpha)
    out = torch.empty((ids.shape[0], lat.shape[1]), dtype=f32,
                      device=lat.device)
    _launch(_library().wseg_lattice_slice, "lattice_slice", lat.device,
            lat.data_ptr(), ids.data_ptr(), wn.data_ptr(), ids.shape[0],
            lat.shape[1], ids.shape[1], float(alpha), out.data_ptr())
    _count(lattice_slice)
    return out


for _fn in (lattice_weights, lattice_splat, lattice_blur, lattice_slice):
    _fn.launches = 0
