"""Dense-CRF Gaussian blur: CUDA kernel wrapper and plain versions.

``out = correlate1d(correlate1d(x * mask, k, axis=H), k, axis=W)`` with
zero fill, over 2r+1 taps ``k``, channels-major (B, C, H, W) float32;
the mask is optional, (B, 1, H, W) float32, broadcast over C.  Port of
the TPU kernel ``wseg_tpu/ops/crf_pallas.py::gauss_blur_pallas_cm``
(which takes no mask: its caller multiplies first); the CUDA source is
``csrc/crf_gauss.cu``.

``gauss_blur_cm`` dispatches on the tensor's device: a CPU tensor goes
to ``gauss_blur_cm_reference`` (a slice-sum), a CUDA tensor launches
the kernel (building it on first use) or raises.
``gauss_blur_cm.launches`` counts kernel launches, and ``.kernel_name``
is the kernel's name in profiler traces.

The kernel works on (plane, column band, row segment) tiles;
``gauss_plan`` is its host plan and ``gauss_blur_cm_tiled_reference``
the same schedule in plain torch (nothing on the main path calls it).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from wseg_tpu_torch import _build

# the kernel's limits (csrc/crf_gauss.cu); ``_library`` checks them
# against the built kernel's.  ``gauss_plan`` alone picks a launch's
# geometry within them, and the C entry only checks it.
MAX_R = 16           # largest radius
MAX_THREADS = 160    # threads of a block: a 128-column band + 2 x 16
STAGES = 3           # input row groups in the kernel's cp.async ring
SMEM_LIMIT = 232448  # dynamic shared memory a block may use (H100)
LIMITS = (MAX_R, MAX_THREADS, STAGES, SMEM_LIMIT)
BANDS = (128, 64, 32)  # output columns of a band, widest first
WAVES = 2            # the grid fills at least this many waves ...
HALO_SHARE = 2       # ... with at least this many output rows a segment
                     # for each of its 2r halo rows


def _round4(r: int) -> int:
    return (r + 3) // 4 * 4


def block_threads(r: int, bw: int) -> int:
    """Threads of a block: one per column of the staged span, whole
    warps."""
    return -(-(bw + 2 * _round4(r)) // 32) * 32


@dataclass(frozen=True)
class GaussPlan:
    """The kernel's schedule for ``planes`` (h, w) planes at radius r.

    A block owns one plane, a band of ``bw`` output columns and a
    segment of ``sh`` output rows.  It stages the span of ``bw + 2 R4``
    columns from ``x0 - R4`` (R4 = r rounded up to 4) of the segment's
    ``sh + 2r`` input rows from ``y0 - r``, one thread per span column,
    and walks down them in groups of 2r+1 rows."""

    planes: int
    h: int
    w: int
    r: int
    bw: int
    sh: int
    masked: bool
    blocks_per_sm: int
    sms: int

    @property
    def span(self) -> int:
        return self.bw + 2 * _round4(self.r)

    @property
    def threads(self) -> int:
        return block_threads(self.r, self.bw)

    @property
    def bands(self) -> int:
        return -(-self.w // self.bw)

    @property
    def segments(self) -> int:
        return -(-self.h // self.sh)

    @property
    def blocks(self) -> int:
        return self.planes * self.bands * self.segments

    @property
    def waves(self) -> float:
        return self.blocks / (self.sms * self.blocks_per_sm)

    def smem_bytes(self) -> int:
        return smem_bytes(self.r, self.bw, self.masked)

    def host_ints(self, vec: bool) -> Tuple[int, ...]:
        """{bw, sh, threads, smem, vec}, the C entry's plan in its
        order."""
        return (self.bw, self.sh, self.threads, self.smem_bytes(),
                int(vec))

    def tiles(self) -> Iterator[Tuple[int, int, int, int]]:
        """(y0, y1, x0, x1) of every block's output tile, for each plane;
        the block stages input rows [y0 - r, y1 + r) and columns
        [x0 - R4, x0 + bw + R4)."""
        for y0 in range(0, self.h, self.sh):
            for x0 in range(0, self.w, self.bw):
                yield (y0, min(self.h, y0 + self.sh), x0,
                       min(self.w, x0 + self.bw))


def smem_bytes(r: int, bw: int, masked: bool) -> int:
    """Dynamic shared memory of a block: STAGES row groups of x (and of
    the mask), 2r+1 rows of the span each; the H pass writes its rows
    over the x group it has read."""
    groups = STAGES * (2 if masked else 1)
    return 4 * (2 * r + 1) * (bw + 2 * _round4(r)) * groups


@functools.lru_cache(maxsize=256)
def gauss_plan(planes: int, h: int, w: int, r: int, masked: bool,
               per_sm: Tuple[int, ...], sms: int) -> GaussPlan:
    """The host plan for ``planes`` (h, w) planes at radius r, on a card
    of ``sms`` SMs of which each holds ``per_sm[i]`` blocks of band
    width ``BANDS[i]`` (on the card: ``_occupancy``, the CUDA occupancy
    calculator's count for the instance).

    A segment has at least ``HALO_SHARE`` output rows per halo row (its
    2r halo rows cost the H pass and the L2 as much as output rows), and
    among the band widths and segment heights that allow, the plan takes
    those whose grid fills at least WAVES waves.  Of these it picks the
    least modelled time: the (row, thread) steps of all blocks,
    stretched by the share of the last wave left idle.  Where none
    fills the waves (a small tensor: the C = 1 norm filters), it takes
    the shortest segments the halo share allows."""
    if not 0 <= r <= MAX_R:
        raise ValueError(f"radius {r} exceeds the kernel's {MAX_R}")
    if planes <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"no plan for {planes} planes of {h} x {w}")
    if len(per_sm) != len(BANDS):
        raise ValueError(f"{len(per_sm)} occupancies for the "
                         f"{len(BANDS)} band widths {BANDS}")
    sh_min = min(h, max(1, HALO_SHARE * 2 * r))
    best = None
    for bw, fit in zip(BANDS, per_sm):
        if smem_bytes(r, bw, masked) > SMEM_LIMIT or fit <= 0:
            continue
        bands = -(-w // bw)
        for sh in range(sh_min, h + 1):  # the evenest sh of a count first
            segs = -(-h // sh)
            waves = planes * bands * segs / (sms * fit)
            # every block's threads walk its sh + 2r rows (the last
            # segment's fewer)
            cells = (planes * bands * (h + segs * 2 * r)
                     * block_threads(r, bw))
            cost = cells * math.ceil(waves) / waves
            key = ((False, cost) if waves >= WAVES else (True, -segs), cost)
            if best is None or key < best[0]:
                best = (key, GaussPlan(planes, h, w, r, bw, sh, masked,
                                       fit, sms))
    if best is None:
        raise ValueError(f"no band of the Gaussian blur fits at radius {r}")
    return best[1]


def gauss_blur_cm_reference(x: torch.Tensor, k1d: Sequence[float], r: int,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain slice-sum: x times the mask, then the H pass over a
    zero-padded copy, then the W pass, taps summed in index order."""
    if mask is not None:
        x = x * mask
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x, (0, 0, r, r))
    acc = sum(k1d[i] * xp[:, :, i:i + h] for i in range(2 * r + 1))
    xp = F.pad(acc, (r, r))
    return sum(k1d[i] * xp[:, :, :, i:i + w] for i in range(2 * r + 1))


def gauss_blur_cm_tiled_reference(x: torch.Tensor, k1d: Sequence[float],
                                  r: int, mask: Optional[torch.Tensor],
                                  plan: GaussPlan) -> torch.Tensor:
    """Plain torch version of the kernel's schedule: each tile of
    ``plan`` computed from its own staged span and rows only, zeros
    outside the plane, H pass then W pass in tap order, and stitched."""
    b, c, h, w = x.shape
    r4 = _round4(r)
    if mask is not None:
        x = x * mask
    # zeros around the plane: every tile's staged rows and span lie in it
    pad = F.pad(x, (r4, plan.bands * plan.bw - w + r4,
                    r, plan.segments * plan.sh - h + r))
    out = torch.empty_like(x)
    for y0, y1, x0, x1 in plan.tiles():
        rows, span = y1 - y0, plan.span
        staged = pad[:, :, y0:y1 + 2 * r, x0:x0 + span]
        hp = sum(k1d[i] * staged[:, :, i:i + rows] for i in range(2 * r + 1))
        o = r4 - r
        tile = sum(k1d[i] * hp[:, :, :, o + i:o + i + x1 - x0]
                   for i in range(2 * r + 1))
        out[:, :, y0:y1, x0:x1] = tile
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("crf_gauss")
    fn = lib.wseg_crf_gauss_blur
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wseg_crf_gauss_limits.argtypes = [ctypes.c_void_p]
    lib.wseg_crf_gauss_limits.restype = ctypes.c_int
    lib.wseg_crf_gauss_occupancy.argtypes = [ctypes.c_int] * 3
    lib.wseg_crf_gauss_occupancy.restype = ctypes.c_int
    got = (ctypes.c_int * 8)()
    n = lib.wseg_crf_gauss_limits(ctypes.addressof(got))
    if tuple(got[:n]) != LIMITS:
        raise RuntimeError(
            f"csrc/crf_gauss.cu's limits {tuple(got[:n])} differ from "
            f"ops/crf_gauss.py's {LIMITS}: change both together")
    return lib


@functools.lru_cache(maxsize=None)
def _occupancy(r: int, masked: bool, index: int) -> Tuple[int, ...]:
    """Blocks an SM of card ``index`` holds of the radius-r instance at
    each band width of BANDS (0 where its shared memory does not fit)."""
    lib = _library()
    fits = []
    with torch.cuda.device(index):
        for bw in BANDS:
            smem = smem_bytes(r, bw, masked)
            n = (lib.wseg_crf_gauss_occupancy(r, block_threads(r, bw),
                                              smem)
                 if smem <= SMEM_LIMIT else 0)
            if n < 0:
                raise RuntimeError(f"no occupancy for the Gaussian blur of "
                                   f"radius {r}: CUDA error {-n}")
            fits.append(n)
    return tuple(fits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gauss_blur_cm(x: torch.Tensor, k1d: Sequence[float], r: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, C, H, W) float32, contiguous; ``k1d`` 2r+1 host floats;
    ``mask`` None or (B, 1, H, W) float32 on x's device -> (B, C, H, W)
    float32, zero-padded separable blur of ``x * mask``."""
    r = int(r)
    k1d = [float(v) for v in k1d]
    if x.dim() != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous channels-major (B, C, H, W)")
    if r < 0 or len(k1d) != 2 * r + 1:
        raise ValueError(f"{len(k1d)} taps for radius {r}, expected "
                         f"{2 * r + 1}")
    b, c, h, w = x.shape
    if mask is not None:
        if tuple(mask.shape) != (b, 1, h, w):
            raise ValueError(f"mask {tuple(mask.shape)} does not match x "
                             f"{tuple(x.shape)}: expected {(b, 1, h, w)}")
        if mask.dtype != torch.float32:
            raise TypeError(f"expected a float32 mask, got {mask.dtype}")
        if mask.device != x.device:
            raise ValueError(f"x on {x.device}, mask on {mask.device}")
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous (B, 1, H, W)")
    if x.device.type == "cpu":
        return gauss_blur_cm_reference(x, k1d, r, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no Gaussian blur kernel for device {x.device}")
    if r > MAX_R:
        raise ValueError(f"radius {r} exceeds the kernel's {MAX_R}")
    lib = _library()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    index = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    masked = mask is not None
    plan = gauss_plan(b * c, h, w, r, masked, _occupancy(r, masked, index),
                      _sm_count(index))
    vec = (w % 4 == 0 and x.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0
           and (mask is None or mask.data_ptr() % 16 == 0))
    ints = (ctypes.c_int * 5)(*plan.host_ints(vec))
    taps = (ctypes.c_float * len(k1d))(*k1d)
    with torch.cuda.device(x.device):
        rc = lib.wseg_crf_gauss_blur(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), ctypes.addressof(taps), r, b, c, h, w,
            ctypes.addressof(ints),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Gaussian blur kernel launch failed: CUDA "
                           f"error {rc}")
    gauss_blur_cm.launches += 1
    return out


gauss_blur_cm.launches = 0
# the kernel's name in profiler traces (a template: its instances' names
# hold it)
gauss_blur_cm.kernel_name = "gauss_band_kernel"
