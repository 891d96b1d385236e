"""Exact permutohedral filter steps: CUDA kernel wrappers and their plain
versions.

Port of the TPU kernels of ``wseg_tpu/ops/crf_mm.py`` (``_ohgen_call``,
``_splat_call``, ``_gather_call``), which build the filter from dense
multi-hot matmuls; here the same operators run over the sparse lattice
tables (``csrc/crf_lattice.cu``, whose header says how):

- ``lattice_weights``: the splat/slice weights with the symmetric norm
  folded in, pixel-major and vertex-major;
- ``lattice_splat``: lattice rows from pixel values along the CSR, its
  rows cut into chunks by the tables' split table;
- ``lattice_blur``: the [1, 2, 1]/2 blur along every lattice axis, one
  launch;
- ``lattice_slice``: pixel values from their d+1 lattice vertices;
- ``lattice_filter_cuda``: the three in one host call (the filter of
  ``ops/crf_lattice.lattice_filter``).

Each wrapper dispatches on the tensors' device: CPU tensors go to the
``*_reference`` version (``index_add_``, indexing, ``einsum``), CUDA
tensors launch the kernel (built on first use) or raise.  Each kernel's
wrapper has ``.launches``, the count of its kernel's launches, also of
those made by ``lattice_filter_cuda``.  The lattice has m vertex rows
plus the zero slot, row m.  ``tables`` arguments are
``ops/crf_lattice.LatticeTables``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from wseg_tpu_torch import _build

_count_lock = threading.Lock()


def _count(*fns) -> None:
    with _count_lock:  # the serving CRF pool launches from two threads
        for fn in fns:
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


def lattice_splat_split_reference(chunk_ptr: torch.Tensor,
                                  chunk_row: torch.Tensor,
                                  entries: torch.Tensor, w_csr: torch.Tensor,
                                  q: torch.Tensor, d1: int) -> torch.Tensor:
    """The splat in the kernel's order: each chunk's entries summed into a
    partial, then each row's partials summed in chunk order (the last
    chunk is the zero slot's, an empty one, so row m is zero)."""
    n_chunks = chunk_row.numel()
    chunk_of = torch.repeat_interleave(
        torch.arange(n_chunks, device=q.device),
        (chunk_ptr[1:] - chunk_ptr[:-1]).long())
    pix = torch.div(entries.long(), d1, rounding_mode="floor")
    part = torch.zeros((n_chunks, q.shape[1]), dtype=torch.float32,
                       device=q.device)
    part.index_add_(0, chunk_of, w_csr[:, None] * q[pix])
    lat = torch.zeros((int(chunk_row[-1]) + 1, q.shape[1]),
                      dtype=torch.float32, device=q.device)
    return lat.index_add_(0, chunk_row.long(), part)


def lattice_blur_reference(lat: torch.Tensor,
                           nbr: torch.Tensor) -> torch.Tensor:
    """One axis: rows v < m become lat[v] + (lat[n1] + lat[n2]) / 2 with
    ``nbr`` (m, 2); the zero slot stays zero."""
    m = nbr.shape[0]
    n = nbr.long()
    body = lat[:m] + 0.5 * (lat[n[:, 0]] + lat[n[:, 1]])
    return torch.cat([body, torch.zeros_like(lat[m:])], dim=0)


def lattice_blur_axes_reference(lat: torch.Tensor,
                                nbr: torch.Tensor) -> torch.Tensor:
    """Every axis of ``nbr`` (axes, m, 2) in turn (a (m, 2) ``nbr`` is one
    axis): the chain of ``lattice_blur_reference``."""
    for axis in (nbr[None] if nbr.dim() == 2 else nbr):
        lat = lattice_blur_reference(lat, axis)
    return lat


def lattice_slice_reference(lat: torch.Tensor, ids: torch.Tensor,
                            wn: torch.Tensor, alpha: float) -> torch.Tensor:
    """(Np, C): alpha * sum over the d+1 slots of wn * lat[ids]."""
    return alpha * torch.einsum("ps,psc->pc", wn, lat[ids.long()])


def lattice_filter_reference(values: torch.Tensor, tables,
                             w_pix: torch.Tensor,
                             w_csr: torch.Tensor) -> torch.Tensor:
    """The plain filter: split splat, the d+1 blurs, slice."""
    lat = lattice_splat_split_reference(tables.chunk_ptr, tables.chunk_row,
                                        tables.entries, w_csr, values,
                                        tables.d1)
    lat = lattice_blur_axes_reference(lat, tables.nbr)
    return lattice_slice_reference(lat, tables.ids, w_pix, tables.alpha)


# ------------------------------------------------------------- kernels
# the slice kernel's limits (csrc/crf_lattice.cu); ``_library`` checks
# them against the built kernel's: d+1 of its instances (the host lattice
# library packs at most 5 coordinates, d+1 = 6), threads of a block
SLICE_MAX_D1 = 8
SLICE_LIMITS = (SLICE_MAX_D1, 128)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("crf_lattice")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.wseg_lattice_weights.argtypes = [p, p, p, p, ll, ll, i, p, p, p]
    # the splat's and the blur's last int is their cooperative grid: the
    # wrappers pass 0, as many blocks as the card holds at once
    lib.wseg_lattice_splat.argtypes = [p, p, p, i, i, p, p, p, i, i, p, p, i,
                                       p]
    lib.wseg_lattice_blur.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.wseg_lattice_slice.argtypes = [p, p, p, i, i, i, i, f, p, p]
    lib.wseg_lattice_slice_limits.argtypes = [p]
    lib.wseg_lattice_filter.argtypes = [p, p, p, i, i, p, p, p, i, i, p, i,
                                        p, p, i, f, p, p, p]
    for name in ("wseg_lattice_weights", "wseg_lattice_splat",
                 "wseg_lattice_blur", "wseg_lattice_slice",
                 "wseg_lattice_slice_limits", "wseg_lattice_filter"):
        getattr(lib, name).restype = ctypes.c_int
    got = (ctypes.c_int * 4)()
    limits = tuple(got[:lib.wseg_lattice_slice_limits(ctypes.addressof(got))])
    if limits != SLICE_LIMITS:
        raise RuntimeError(
            f"csrc/crf_lattice.cu's slice limits {limits} differ from "
            f"ops/crf_lattice_cuda.py's {SLICE_LIMITS}: change both "
            "together")
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


def _check_slots(name: str, d1: int) -> None:
    if not 1 <= d1 <= SLICE_MAX_D1:
        raise ValueError(f"{name}: {d1} slots a pixel; the slice kernel "
                         f"takes 1 to {SLICE_MAX_D1}")


def _launch(fn, what: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _splat_tables(name: str, tables, w_csr: torch.Tensor, q: torch.Tensor,
                  **more) -> str:
    f32, i32 = torch.float32, torch.int32
    where = _check(name, chunk_ptr=(tables.chunk_ptr, i32, 1),
                   chunk_row=(tables.chunk_row, i32, 1),
                   splits=(tables.splits, i32, 2),
                   entries=(tables.entries, i32, 1), w_csr=(w_csr, f32, 1),
                   q=(q, f32, 2), **more)
    if (w_csr.shape != tables.entries.shape
            or tables.chunk_ptr.numel() != tables.chunk_row.numel() + 1
            or not 1 <= q.shape[1] <= 32):
        raise ValueError(f"{name}: entries {tuple(tables.entries.shape)}, "
                         f"w_csr {tuple(w_csr.shape)}, chunk_ptr "
                         f"{tuple(tables.chunk_ptr.shape)}, chunk_row "
                         f"{tuple(tables.chunk_row.shape)}, q "
                         f"{tuple(q.shape)} (1 to 32 channels)")
    return where


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


def lattice_splat(tables, w_csr: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """S'^T q over the tables' split table: w_csr (E,) the splat weights,
    q (Np, C) float32 with C <= 32 -> (m+1, C) float32 lattice (row m
    zero).  Deterministic."""
    where = _splat_tables("lattice_splat", tables, w_csr, q)
    if where == "cpu":
        return lattice_splat_split_reference(
            tables.chunk_ptr, tables.chunk_row, tables.entries, w_csr, q,
            tables.d1)
    c, n_chunks, rows = q.shape[1], tables.chunk_row.numel(), tables.m + 1
    buf = torch.empty(((rows + n_chunks) * c,), dtype=torch.float32,
                      device=q.device)  # the lattice, then the partials
    _launch(_library().wseg_lattice_splat, "lattice_splat", q.device,
            tables.chunk_ptr.data_ptr(), tables.chunk_row.data_ptr(),
            tables.splits.data_ptr(), n_chunks, tables.splits.shape[0],
            tables.entries.data_ptr(), w_csr.data_ptr(), q.data_ptr(), c,
            tables.d1, buf.data_ptr(), buf.data_ptr() + 4 * rows * c, 0)
    _count(lattice_splat)
    return buf[:rows * c].view(rows, c)


def lattice_blur(lat: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """lat (m+1, C) float32, nbr (axes, m, 2) int32 neighbours per axis
    (missing = m), or (m, 2) for one axis -> a new (m+1, C) lattice
    blurred along every axis in turn, in one launch; ``lat`` is not
    written."""
    axes = nbr[None] if nbr.dim() == 2 else nbr
    where = _check("lattice_blur", lat=(lat, torch.float32, 2),
                   nbr=(axes, torch.int32, 3))
    n_axes, m = axes.shape[:2]
    if lat.shape[0] != m + 1 or axes.shape[2] != 2 or n_axes == 0:
        raise ValueError(f"lattice_blur: lat {tuple(lat.shape)}, nbr "
                         f"{tuple(nbr.shape)}")
    if where == "cpu":
        return lattice_blur_axes_reference(lat, axes)
    out = torch.empty_like(lat)
    other = torch.empty_like(lat) if n_axes > 1 else out
    # axis j writes buffer j % 2; the last one must be `out`
    bufs = (out, other) if n_axes % 2 else (other, out)
    _launch(_library().wseg_lattice_blur, "lattice_blur", lat.device,
            lat.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            axes.data_ptr(), m, lat.shape[1], n_axes, 0)
    _count(lattice_blur)
    return out


def lattice_slice(lat: torch.Tensor, ids: torch.Tensor, wn: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    """lat (m+1, C), ids (Np, d+1) int32 in [0, m], wn (Np, d+1) float32
    -> (Np, C) float32 pixel values.  Row m of ``lat`` is the zero slot
    and must hold zeros, as every lattice of the exact CRF does (the
    splat leaves it empty, the blur rewrites it): the kernel reads
    nothing for a slot on it and adds 0, whatever the row holds, where
    the plain version gathers it."""
    f32 = torch.float32
    where = _check("lattice_slice", lat=(lat, f32, 2),
                   ids=(ids, torch.int32, 2), wn=(wn, f32, 2))
    if ids.shape != wn.shape:
        raise ValueError(f"lattice_slice: ids {tuple(ids.shape)}, wn "
                         f"{tuple(wn.shape)}")
    if where == "cpu":
        return lattice_slice_reference(lat, ids, wn, alpha)
    _check_slots("lattice_slice", ids.shape[1])
    out = torch.empty((ids.shape[0], lat.shape[1]), dtype=f32,
                      device=lat.device)
    _launch(_library().wseg_lattice_slice, "lattice_slice", lat.device,
            lat.data_ptr(), ids.data_ptr(), wn.data_ptr(), ids.shape[0],
            lat.shape[1], ids.shape[1], lat.shape[0] - 1, float(alpha),
            out.data_ptr())
    _count(lattice_slice)
    return out


def lattice_filter_cuda(values: torch.Tensor, tables, w_pix: torch.Tensor,
                        w_csr: torch.Tensor) -> torch.Tensor:
    """One exact filter, values (Np, C) float32 with C <= 32 -> (Np, C):
    splat with ``w_csr``, blur along the d+1 axes, slice with ``w_pix``.
    On the card one host call launches the three kernels back to back
    (each counted on its own wrapper); on the CPU the plain filter."""
    f32, i32 = torch.float32, torch.int32
    where = _splat_tables("lattice_filter", tables, w_csr, values,
                          nbr=(tables.nbr, i32, 3),
                          ids=(tables.ids, i32, 2), w_pix=(w_pix, f32, 2))
    n_pix, c = values.shape
    d1, m = tables.d1, tables.m
    if (tables.ids.shape != (n_pix, d1) or w_pix.shape != (n_pix, d1)
            or tables.nbr.shape != (d1, m, 2)):
        raise ValueError(f"lattice_filter: values {tuple(values.shape)}, "
                         f"ids {tuple(tables.ids.shape)}, w_pix "
                         f"{tuple(w_pix.shape)}, nbr "
                         f"{tuple(tables.nbr.shape)}, m {m}")
    if where == "cpu":
        return lattice_filter_reference(values, tables, w_pix, w_csr)
    _check_slots("lattice_filter", d1)
    n_chunks = tables.chunk_row.numel()
    buf = torch.empty(((n_pix + 2 * (m + 1) + n_chunks) * c,), dtype=f32,
                      device=values.device)  # the output, then scratch
    _launch(_library().wseg_lattice_filter, "lattice_filter", values.device,
            tables.chunk_ptr.data_ptr(), tables.chunk_row.data_ptr(),
            tables.splits.data_ptr(), n_chunks, tables.splits.shape[0],
            tables.entries.data_ptr(), w_csr.data_ptr(), values.data_ptr(),
            c, d1, tables.nbr.data_ptr(), m, tables.ids.data_ptr(),
            w_pix.data_ptr(), n_pix, float(tables.alpha),
            buf.data_ptr() + 4 * n_pix * c, buf.data_ptr())
    _count(lattice_splat, lattice_blur, lattice_slice)
    return buf[:n_pix * c].view(n_pix, c)


for _fn in (lattice_weights, lattice_splat, lattice_blur, lattice_slice):
    _fn.launches = 0
