"""Dense-CRF bilateral message: CUDA kernel wrapper and plain versions.

``out[b, c](y, x) = sum_k w[b, k](y, x) * q[b, c](y + dy_k, x + dx_k)``
with zero fill, channels-major.  Port of the TPU kernel
``wseg_tpu/ops/crf_pallas.py::bilateral_message_pallas_cm``; the CUDA
source is ``csrc/crf_bilateral.cu``.

``bilateral_message_cm`` dispatches on the tensors' device: a CPU
tensor goes to ``bilateral_message_cm_reference``, a CUDA tensor
launches the kernel (building it on first use) or raises.
``bilateral_message_cm.launches`` counts kernel launches, and
``.kernel_name`` is the kernel's name in profiler traces.

The kernel works on row-residue classes of the taps' row pitch, in
bands of class rows staged in shared memory; ``band_plan`` is its host
plan and ``bilateral_message_cm_banded_reference`` the same schedule in
plain torch (nothing on the main path calls it).
"""

from __future__ import annotations

import ctypes
import functools
import math
import dataclasses
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import torch

from wseg_tpu_torch import _build

Taps = Tuple[Tuple[int, int], ...]

# the kernel's limits (csrc/crf_bilateral.cu); ``_library`` checks them
# against the built kernel's.  ``band_plan`` alone picks a launch's
# geometry within them, and the C entry only checks it.
MAX_CHANNELS = 32    # channels a call may have
MAX_TAPS = 1024      # taps a call may have
BLOCK = 128          # threads per block, one output column each
MAX_GROUP = 8        # channels per block
MAX_ROWS = 10        # output rows per thread (band height)
MAX_SLOTS = 32       # weight rows per stage of the weight ring
SMEM_LIMIT = 232448  # dynamic shared memory a block may use (H100)
LIMITS = (MAX_CHANNELS, MAX_TAPS, BLOCK, MAX_GROUP, MAX_ROWS, MAX_SLOTS,
          SMEM_LIMIT)


def bilateral_message_cm_reference(q: torch.Tensor, w: torch.Tensor,
                                   taps: Sequence[Tuple[int, int]]):
    """Plain torch loop over taps: q (B, C, H, W), w (B, T, H, W) ->
    (B, C, H, W) float32, accumulated in float32 in tap order."""
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    qf = q.float()
    h, w_ = q.shape[2], q.shape[3]
    for k, (dy, dx) in enumerate(taps):
        if abs(dy) >= h or abs(dx) >= w_:
            continue
        yd = slice(max(0, -dy), min(h, h - dy))
        ys = slice(max(0, dy), min(h, h + dy))
        xd = slice(max(0, -dx), min(w_, w_ - dx))
        xs = slice(max(0, dx), min(w_, w_ + dx))
        out[:, :, yd, xd] += w[:, k:k + 1, yd, xd].float() * qf[:, :, ys, xs]
    return out


@dataclass(frozen=True)
class BandPlan:
    """The kernel's schedule for one tap tuple at one (C, H, W).

    Taps that reach no pixel (|dy| >= H or |dx| >= W) are left out.
    Output row y = rho + j * pitch reads q rows rho + i * pitch with
    i - j = dy / pitch in [dy_lo, dy_lo + ndy).  ``cells[(l * len(dx) +
    d) * ndy + r]`` is the tap (list index) with dx = ``dx[d]`` and
    dy / pitch = dy_lo + r in layer l, or -1: layer l holds the l-th
    tap of each (dx, dy) in list order, so repeated taps fall in later
    layers.  A band is ``rows`` class rows; a block stages ``staged``
    class rows of ``stride`` floats for ``group`` channels, and each
    stage of its weight ring holds ``chunk`` dx values x ``kernel_rows``
    output rows (the rows a thread holds: the kernel's template)."""

    pitch: int
    dy_lo: int
    ndy: int
    dx: Tuple[int, ...]  # distinct dx, descending
    cells: Tuple[int, ...]
    rows: int
    group: int
    staged: int
    stride: int
    chunk: int
    kernel_rows: int

    @property
    def layers(self) -> int:
        return len(self.cells) // max(1, len(self.dx) * self.ndy)

    @property
    def table(self) -> Tuple[int, ...]:
        """The device table: dx | cells."""
        return self.dx + self.cells

    def smem_bytes(self) -> int:
        return (4 * self.group * self.staged * self.stride
                + 2 * 2 * self.chunk * self.kernel_rows * BLOCK
                + 4 * len(self.table))

    def host_ints(self, qvec: bool, wvec: bool) -> Tuple[int, ...]:
        """{P, dy_lo, ndy, ndx, dx_lo, dx_hi, J, JT, G, S, SW, D, L, qvec,
        wvec, smem}, the C entry's ``Plan`` in its order."""
        return (self.pitch, self.dy_lo, self.ndy, len(self.dx),
                self.dx[-1] if self.dx else 0, self.dx[0] if self.dx else 0,
                self.rows, self.kernel_rows, self.group, self.staged,
                self.stride, self.chunk, self.layers, int(qvec), int(wvec),
                self.smem_bytes())

    def bands(self, h: int) -> Iterator[Tuple[int, int, int, int, int]]:
        """(rho, j0, j1, i_lo, i_hi) of every band: output class rows
        [j0, j1), staged class rows [i_lo, i_hi)."""
        for rho in range(self.pitch):
            n = -(-(h - rho) // self.pitch)
            for j0 in range(0, n, self.rows):
                j1 = min(n, j0 + self.rows)
                yield (rho, j0, j1, max(0, j0 + self.dy_lo),
                       min(n, j1 + self.dy_lo + self.ndy - 1))

    def tap(self, layer: int, d: int, r: int) -> int:
        """The tap of cell (dx[d], dy_lo + r) in ``layer``, or -1."""
        if not 0 <= r < self.ndy:
            return -1
        return self.cells[(layer * len(self.dx) + d) * self.ndy + r]


def _stride(w: int, dx_lo: int, dx_hi: int) -> int:
    """The widest staged q row of any column segment, in floats: the
    segment's columns plus the dx reach, clipped to the image, widened
    to multiples of 4 (as the kernel stages it)."""
    widest = 0
    for x0 in range(0, w, BLOCK):
        xs = max(0, x0 + dx_lo) // 4 * 4
        xe = min(w, x0 + BLOCK + dx_hi)
        widest = max(widest, (xe + 3) // 4 * 4 - xs)
    return max(4, widest)


@functools.lru_cache(maxsize=256)
def band_plan(taps: Taps, c: int, h: int, w: int) -> BandPlan:
    """The host plan of ``taps`` for q of shape (., c, h, w).  Picks the
    largest channel group (<= 8) and band height (<= 10 rows; 2 for one
    or two channels, for more blocks) whose staged band and weight ring
    fit in shared memory; raises ValueError when none does."""
    keep = [k for k, (dy, dx) in enumerate(taps)
            if abs(dy) < h and abs(dx) < w]
    pitch = functools.reduce(math.gcd, (abs(taps[k][0]) for k in keep), 0)
    pitch = pitch or 1
    dyq = {k: taps[k][0] // pitch for k in keep}
    dy_lo = min(dyq.values(), default=0)
    ndy = max(dyq.values(), default=0) - dy_lo + 1
    dxs = tuple(sorted({taps[k][1] for k in keep}, reverse=True))
    per_layer = len(dxs) * ndy
    cells = []
    for k in keep:
        cell = dxs.index(taps[k][1]) * ndy + dyq[k] - dy_lo
        while cell < len(cells) and cells[cell] >= 0:
            cell += per_layer  # repeated tap: the next layer
        cells += [-1] * (cell + 1 - len(cells))
        cells[cell] = k
    cells += [-1] * (-len(cells) % max(1, per_layer))
    cells = tuple(cells)
    nq = -(-h // pitch)
    stride = _stride(w, dxs[-1] if dxs else 0, dxs[0] if dxs else 0)
    groups = -(-c // MAX_GROUP)
    top_rows = 2 if -(-c // groups) <= 2 else MAX_ROWS
    for group in range(-(-c // groups), 0, -1):
        for rows in range(top_rows, 0, -1):
            # the kernel is built for 2 rows a thread at one or two
            # channels (more blocks for the norm filter) and MAX_ROWS
            jt = 2 if rows <= 2 and group <= 2 else MAX_ROWS
            chunk = max(1, min(len(dxs), MAX_SLOTS // jt))
            plan = BandPlan(pitch, dy_lo, ndy, dxs, cells, rows, group,
                            min(nq, rows + ndy - 1), stride, chunk, jt)
            if plan.smem_bytes() <= SMEM_LIMIT:
                # spread the channels evenly over the groups this needs
                return dataclasses.replace(
                    plan, group=-(-c // -(-c // group)))
    need = BandPlan(pitch, dy_lo, ndy, dxs, cells, 1, 1, min(nq, ndy),
                    stride, 1, 2).smem_bytes()
    raise ValueError(
        f"a band of the bilateral message does not fit in shared memory: "
        f"{len(taps)} taps of row pitch {pitch} reach {ndy} class rows; one "
        f"row and one channel of them need {need} B, over {SMEM_LIMIT} B")


def band_steps(plan: BandPlan, h: int
               ) -> Iterator[Tuple[int, int, int, int]]:
    """The kernel's (output row, tap, q row, dx) steps in its order: per
    band and layer, staged rows descending, dx descending, then each
    output row of the band with the tap of its cell."""
    for rho, j0, j1, i_lo, i_hi in plan.bands(h):
        for layer in range(plan.layers):
            for i in range(i_hi - 1, i_lo - 1, -1):
                for d, dx in enumerate(plan.dx):
                    for j in range(j0, j1):
                        k = plan.tap(layer, d, i - j - plan.dy_lo)
                        if k >= 0:
                            yield (rho + j * plan.pitch, k,
                                   rho + i * plan.pitch, dx)


def bilateral_message_cm_banded_reference(
        q: torch.Tensor, w: torch.Tensor,
        taps: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Plain torch version of the kernel's schedule: residue classes,
    bands and per-output tap order of ``band_plan``, one output row and
    tap at a time, accumulated in float32."""
    taps = tuple((int(dy), int(dx)) for dy, dx in taps)
    b, c, h, w_ = q.shape
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    qf = q.float()
    for y, k, yq, dx in band_steps(band_plan(taps, c, h, w_), h):
        xd = slice(max(0, -dx), min(w_, w_ - dx))
        xs = slice(max(0, dx), min(w_, w_ + dx))
        out[:, :, y, xd] += w[:, k:k + 1, y, xd].float() * qf[:, :, yq, xs]
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("crf_bilateral")
    fn = lib.wseg_crf_bilateral_message
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wseg_crf_bilateral_limits.argtypes = [ctypes.c_void_p]
    lib.wseg_crf_bilateral_limits.restype = ctypes.c_int
    got = (ctypes.c_int * 16)()
    n = lib.wseg_crf_bilateral_limits(ctypes.addressof(got))
    if tuple(got[:n]) != LIMITS:
        raise RuntimeError(
            f"csrc/crf_bilateral.cu's limits {tuple(got[:n])} differ from "
            f"ops/crf_bilateral.py's {LIMITS}: change both together")
    return lib


@functools.lru_cache(maxsize=64)
def _table_on(plan: BandPlan, device: torch.device) -> torch.Tensor:
    return torch.tensor(plan.table, dtype=torch.int32, device=device)


def bilateral_message_cm(q: torch.Tensor, w: torch.Tensor,
                         taps: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """q (B, C, H, W) float32, w (B, T, H, W) bfloat16, T static (dy, dx)
    taps -> (B, C, H, W) float32 message."""
    taps = tuple((int(dy), int(dx)) for dy, dx in taps)
    if q.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected 4-D q and w, got {tuple(q.shape)}, "
                         f"{tuple(w.shape)}")
    b, c, h, w_ = q.shape
    if tuple(w.shape) != (b, len(taps), h, w_):
        raise ValueError(f"weights {tuple(w.shape)} do not match q "
                         f"{tuple(q.shape)} and {len(taps)} taps")
    if q.dtype != torch.float32 or w.dtype != torch.bfloat16:
        raise TypeError(f"expected float32 q and bfloat16 w, got {q.dtype}"
                        f" and {w.dtype}")
    if q.device != w.device:
        raise ValueError(f"q on {q.device}, w on {w.device}")
    if q.device.type == "cpu":
        return bilateral_message_cm_reference(q, w, taps)
    if q.device.type != "cuda":
        raise ValueError(f"no bilateral kernel for device {q.device}")
    if not (q.is_contiguous() and w.is_contiguous()):
        raise ValueError("q and w must be contiguous")
    lib = _library()
    if c > MAX_CHANNELS:
        raise ValueError(f"{c} channels exceed the kernel's {MAX_CHANNELS}")
    if len(taps) > MAX_TAPS:
        raise ValueError(f"{len(taps)} taps exceed the kernel's {MAX_TAPS}")
    out = torch.empty_like(q)
    if not taps or q.numel() == 0:
        return out.zero_()
    plan = band_plan(taps, c, h, w_)
    qvec = w_ % 4 == 0 and q.data_ptr() % 16 == 0
    wvec = w_ % 8 == 0 and w.data_ptr() % 16 == 0
    ints = (ctypes.c_int * 16)(*plan.host_ints(qvec, wvec))
    with torch.cuda.device(q.device):
        table = _table_on(plan, q.device)
        rc = lib.wseg_crf_bilateral_message(
            q.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(),
            b, c, len(taps), h, w_, ctypes.addressof(ints),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bilateral message kernel launch failed: CUDA "
                           f"error {rc}")
    bilateral_message_cm.launches += 1
    return out


bilateral_message_cm.launches = 0
# the kernel's name in profiler traces (a template: its instances' names
# hold it)
bilateral_message_cm.kernel_name = "bilateral_band_kernel"
