"""PAMR affinity and propagation: CUDA kernel wrappers and plain versions.

Port of the TPU kernels ``wseg_tpu/ops/pamr_pallas.py``:
``pamr_affinity_pallas`` -> ``pamr_affinity_cm`` and
``pamr_propagate_pallas`` -> ``pamr_propagate_cm``; the CUDA source is
``csrc/pamr.cu`` (its header says what bounds each kernel and what the
design does about it).  Both are forward only: PAMR runs on
stop-gradient masks, and the TPU kernels have no backward either.

Tensors are channels-major (B, ., H, W) float32, the layout the kernels
read and write; ``ops/pamr.py`` keeps the NHWC contract around them.
Each wrapper dispatches on the tensor's device: a CPU tensor goes to
the plain version beside it (``*_reference``), a CUDA tensor launches
the kernel (building it on first use) or raises.  ``.launches`` counts
kernel launches.

Each kernel's launch comes from a pure Python host plan, which the C
entry only checks (``csrc/pamr.cu`` says why each is shaped so):
``affinity_plan`` gives the affinity a CTA per tile of an image row,
with the guide's window in shared memory and 4 lanes a pixel;
``propagate_plan`` gives the propagation a thread-block cluster per
(image, group of G channels), its CTAs splitting the plane's rows.

Taps are ``pamr_taps(dilations)``: for each dilation d, the 8
neighbours of a row-major 3x3 scan without its centre, times d (the
order of ``wseg_tpu/ops/pamr.py::_OFFSETS``).  Edge replication is
coordinate clamping, since no offset exceeds ``max(dilations)``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F

from wseg_tpu_torch import _build

_OFFSETS = ((-1, -1), (-1, 0), (-1, 1),
            (0, -1), (0, 1),
            (1, -1), (1, 0), (1, 1))


def _dilations(dilations: Sequence[int]) -> Tuple[int, ...]:
    dil = tuple(int(d) for d in dilations)
    if not dil or min(dil) <= 0:
        raise ValueError(f"dilations must be positive, got {dilations}")
    return dil


def pamr_taps(dilations: Sequence[int]):
    """[(dy, dx), ...] of the 8 * len(dilations) taps, in kernel order."""
    return [(dy * d, dx * d) for d in _dilations(dilations)
            for dy, dx in _OFFSETS]


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def pamr_affinity_cm_reference(im: torch.Tensor,
                               dilations: Sequence[int]) -> torch.Tensor:
    """Plain torch affinity, as ``wseg_tpu/ops/pamr.py::pamr_affinity``:
    guide (B, K, H, W) -> (B, T, H, W) softmax affinities, sigma per
    channel over the 9 * D taps (centre once per dilation), two-pass
    Bessel-corrected variance."""
    dil = _dilations(dilations)
    im = im.float()
    h, w = im.shape[2], im.shape[3]
    pad = max(dil)
    padded = _edge_pad(im, pad)

    def shift(dy, dx):
        return padded[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    diffs, neigh = [], []
    for d in dil:
        for dy, dx in _OFFSETS:
            n = shift(dy * d, dx * d)
            diffs.append(im - n)
            neigh.append(n)
        neigh.append(im)
    diffs = torch.stack(diffs, dim=1)                    # (B, T, K, H, W)
    neigh = torch.stack(neigh, dim=1)                    # (B, 9D, K, H, W)
    mean = neigh.mean(dim=1, keepdim=True)
    var = torch.sum(torch.square(neigh - mean), dim=1, keepdim=True) / (
        neigh.shape[1] - 1)
    aff = -torch.abs(diffs) / (1e-8 + 0.1 * torch.sqrt(var))
    return torch.softmax(aff.mean(dim=2), dim=1)


def pamr_propagate_cm_reference(aff: torch.Tensor, mask: torch.Tensor,
                                dilations: Sequence[int],
                                num_iter: int) -> torch.Tensor:
    """Plain torch propagation, as ``wseg_tpu/ops/pamr.py::
    pamr_propagate``: ``num_iter`` steps m <- sum_t aff_t * shift_t(m),
    edge-replicated, accumulated in tap order in float32."""
    taps = pamr_taps(dilations)
    aff = aff.float()
    m = mask.float()
    h, w = m.shape[2], m.shape[3]
    pad = max(abs(v) for tap in taps for v in tap)
    for _ in range(int(num_iter)):
        padded = _edge_pad(m, pad)
        acc = torch.zeros_like(m)
        for t, (dy, dx) in enumerate(taps):
            acc = acc + aff[:, t:t + 1] * padded[
                :, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        m = acc
    return m


# the affinity kernel's limits (csrc/pamr.cu); ``_library`` checks them
# against the built kernel's.  ``affinity_plan`` alone picks a launch
# within them, and the C entry only checks it.
AFFINITY_LANES = 4  # lanes a pixel
AFFINITY_MAX_THREADS = 512
AFFINITY_LIMITS = (AFFINITY_LANES, AFFINITY_MAX_THREADS)


def affinity_reach(dil: Sequence[int], h: int, w: int) -> int:
    """Rows and columns a tap reaches: the largest dilation, no more than
    max(h, w) (a larger one clamps every tap the same)."""
    return min(max(dil), max(h, w))


def affinity_pitch(px: int) -> int:
    """Floats between two taps' planes of a CTA's softmax tile: an odd
    multiple of a warp's 32 / AFFINITY_LANES pixels at least ``px``
    (conflict-free stores; csrc/pamr.cu ``affinity_pitch``)."""
    lanes = 32 // AFFINITY_LANES
    return (-(-px // lanes) | 1) * lanes


def affinity_smem(cols: int, dil: Sequence[int], h: int, w: int) -> int:
    """Dynamic shared memory of an affinity CTA: three guide planes of
    the widest tile's window (one row of ``cols`` pixels and its clamped
    +-reach halo, rounded up to 4 floats) and its 8 * D softmax planes
    (csrc/pamr.cu ``affinity_smem``)."""
    reach = affinity_reach(dil, h, w)
    window = min(h, 1 + 2 * reach) * min(w, cols + 2 * reach)
    return 4 * (3 * (-(-window // 4) * 4)
                + 8 * len(dil) * affinity_pitch(cols))


@dataclass(frozen=True)
class AffinityPlan:
    """The affinity kernel's launch for a (b, 3, h, w) guide: a CTA per
    tile of ``cols`` pixels of one image row, ``AFFINITY_LANES`` lanes a
    pixel, ``threads`` threads."""

    b: int
    h: int
    w: int
    dil: Tuple[int, ...]
    cols: int
    threads: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(column tiles, rows, images)."""
        return -(-self.w // self.cols), self.h, self.b

    @property
    def ctas(self) -> int:
        return math.prod(self.grid)

    def tiles(self) -> Iterator[Tuple[int, int, int]]:
        """(y, x0, x1) of each tile of an image."""
        for y in range(self.h):
            for x0 in range(0, self.w, self.cols):
                yield y, x0, min(self.w, x0 + self.cols)

    def smem_bytes(self) -> int:
        return affinity_smem(self.cols, self.dil, self.h, self.w)

    def host_ints(self) -> Tuple[int, ...]:
        """{columns, threads, shared bytes}, the C entry's plan in its
        order."""
        return (self.cols, self.threads, self.smem_bytes())


def affinity_plan(b: int, h: int, w: int,
                  dilations: Sequence[int]) -> AffinityPlan:
    """The affinity's launch for a (b, 3, h, w) guide: a CTA per tile of
    one row, the fewest column tiles whose pixels fit a CTA's threads and
    whose window fits shared memory.  Raises where no launch fits: a
    window of one column is (1 + 2 reach)^2 pixels of three planes, so a
    largest dilation above about 68 on a plane of more than 137 rows and
    columns."""
    dil = _dilations(dilations)
    if not (0 < b <= 65535 and 0 < h <= 65535 and w > 0):
        raise ValueError(f"no affinity plan for ({b}, 3, {h}, {w})")
    n_cols = -(-w // (AFFINITY_MAX_THREADS // AFFINITY_LANES))
    while affinity_smem(-(-w // n_cols), dil, h, w) > SMEM_LIMIT:
        if -(-w // n_cols) == 1:
            raise ValueError(
                f"the affinity's guide window for a {h}x{w} plane with "
                f"dilations {dil} exceeds the shared-memory limit of "
                f"{SMEM_LIMIT} B")
        n_cols += 1
    cols = -(-w // n_cols)
    return AffinityPlan(b, h, w, dil, cols,
                        -(-(cols * AFFINITY_LANES) // 32) * 32)


# the propagation kernel's limits (csrc/pamr.cu); ``_library`` checks
# them against the built kernel's.  ``propagate_plan`` alone picks a
# launch within them, and the C entry only checks it.
GROUPS = (1, 2, 3, 4, 8)  # channels of a unit: the kernel's instances
MAX_CLUSTER = 16     # CTAs of a cluster (above 8 non-portable)
MAX_THREADS = 768    # threads of a CTA
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may use (H100)
MAX_PIXELS = 2       # pixels a thread takes together
MAX_DILATIONS = 8    # dilations of a call (both kernels)
LIMITS = (sum(1 << g for g in GROUPS), MAX_CLUSTER, MAX_THREADS, SMEM_LIMIT,
          MAX_PIXELS)
# largest plane: G = 1, two planes of a pitch rounded up to 4 floats
MAX_PLANE = SMEM_LIMIT // 8 // 4 * 4
# the plan's cost model, in ns, fitted to a sweep of the plans on an
# H100 (PERF.md, PR 9): a step takes STEP_NS_PER_BYTE for each byte an
# SM's shared memory and L1 serve (the G plane values and the affinity
# of every tap, the replica writes of the CTA's peers), and PEER_NS
# more for each peer of a cluster; staging takes STAGE_NS and
# STAGE_NS_PER_BYTE for each byte staged
STEP_NS_PER_BYTE = 5.2e-3
PEER_NS = 300.0
STAGE_NS = 3000.0
STAGE_NS_PER_BYTE = 2e-3


def propagate_smem(g: int, sdil: int, n: int, h: int, w: int) -> int:
    """Dynamic shared memory of a CTA: two replicas of the unit's g
    planes at a pitch of h * w rounded up to 4 floats, and the largest
    band's affinities of ``sdil`` dilations (csrc/pamr.cu
    ``propagate_smem``)."""
    band = -(-h // n) * w
    return 4 * (2 * g * (-(-(h * w) // 4) * 4) + 8 * sdil * band)


@dataclass(frozen=True)
class PropagatePlan:
    """The propagation kernel's launch for (b, c, h, w) with ``n_dil``
    dilations: one cluster of ``n`` CTAs per unit (image, group of ``g``
    channels); CTA r owns rows [r h / n, (r + 1) h / n) of its unit and
    keeps replicas of the unit's g planes and its band's affinities of
    the first ``sdil`` dilations (as many as fit); a thread takes ``p``
    of its pixels together.  ``clusters``: clusters the card holds at
    once; ``cost``: the model's ns."""

    b: int
    c: int
    h: int
    w: int
    n_dil: int
    g: int
    n: int
    threads: int
    p: int
    sdil: int
    clusters: int
    sms: int
    cost: float

    @property
    def groups(self) -> int:
        return -(-self.c // self.g)

    @property
    def units(self) -> int:
        return self.b * self.groups

    @property
    def total_ctas(self) -> int:
        return self.units * self.n

    @property
    def waves(self) -> float:
        return self.units / self.clusters

    def bands(self) -> Iterator[Tuple[int, int]]:
        """(y0, y1) of each cluster rank's rows."""
        for r in range(self.n):
            yield r * self.h // self.n, (r + 1) * self.h // self.n

    def channel_groups(self) -> Iterator[Tuple[int, int]]:
        """(c0, c1) of each unit's channels within an image."""
        for k in range(self.groups):
            yield k * self.g, min(self.c, (k + 1) * self.g)

    def smem_bytes(self) -> int:
        return propagate_smem(self.g, self.sdil, self.n, self.h, self.w)

    def host_ints(self) -> Tuple[int, ...]:
        """{G, N, threads, shared bytes, staged dilations, pixels a
        thread takes together}, the C entry's plan in its order."""
        return (self.g, self.n, self.threads, self.smem_bytes(), self.sdil,
                self.p)

    def occupancy_args(self) -> Tuple[int, ...]:
        """(g, p, n, threads, smem), the arguments of ``fit``."""
        return (self.g, self.p, self.n, self.threads, self.smem_bytes())


def propagate_candidates(b: int, c: int, h: int, w: int, n_dil: int,
                         num_iter: int,
                         fit: Callable[..., int],
                         sms: int) -> Iterator[PropagatePlan]:
    """Every launch the kernel takes for the shape, with its modelled
    cost.  ``fit(g, p, n, threads, smem)`` gives the clusters of that
    launch the card holds at once (on the card: ``_active_clusters``,
    from cudaOccupancyMaxActiveClusters; 0 where none fits).  G is one
    of ``GROUPS`` up to C (21 channels in groups of 8: 8 + 8 + 5)."""
    if b <= 0 or c <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"no propagation plan for ({b}, {c}, {h}, {w})")
    if h * w > MAX_PLANE:
        raise ValueError(
            f"a {h}x{w} plane exceeds the propagation kernel's "
            f"shared-memory limit of {MAX_PLANE} pixels (two float32 "
            "planes a CTA)")
    taps = 8 * n_dil
    for g in (g for g in GROUPS if g <= c):
        units = b * -(-c // g)
        if propagate_smem(g, 0, 1, h, w) > SMEM_LIMIT:
            continue
        for n in range(1, min(MAX_CLUSTER, h) + 1):
            px = -(-h // n) * w
            # the band's pixels evenly over the fewest passes of a thread
            passes = -(-px // MAX_THREADS)
            threads = -(-px // (passes * 32)) * 32
            # as many dilations' affinities as fit beside the replicas
            sdil = min(n_dil, (SMEM_LIMIT - propagate_smem(g, 0, n, h, w))
                       // (4 * 8 * px))
            for p in range(1, min(passes, MAX_PIXELS) + 1):
                smem = propagate_smem(g, sdil, n, h, w)
                clusters = fit(g, p, n, threads, smem)
                if clusters <= 0:
                    continue
                waves = math.ceil(units / clusters)
                # CTAs on the busiest SM
                share = max(1, -(-min(units, clusters) * n // sms))
                per_px = 4 * (taps * (g + 1) + g * (n - 1))
                step = (px * per_px * STEP_NS_PER_BYTE * share
                        + PEER_NS * (n - 1))
                stage = STAGE_NS + STAGE_NS_PER_BYTE * 4 * (
                    g * h * w + 8 * sdil * px) * share
                cost = waves * (num_iter * step + stage)
                yield PropagatePlan(b, c, h, w, n_dil, g, n, threads, p,
                                    sdil, clusters, sms, cost)


def propagate_plan(b: int, c: int, h: int, w: int, n_dil: int,
                   num_iter: int,
                   fit: Callable[..., int],
                   sms: int) -> PropagatePlan:
    """The least-cost launch of ``propagate_candidates``; raises where
    none fits."""
    best = min(propagate_candidates(b, c, h, w, n_dil, num_iter, fit, sms),
               key=lambda p: (p.cost, -p.g, p.n, -p.p),
               default=None)
    if best is None:
        raise ValueError(f"no propagation launch fits ({b}, {c}, {h}, {w}) "
                         f"with {n_dil} dilations")
    return best


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("pamr")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.wseg_pamr_affinity.argtypes = [ptr, ptr, ptr, i, i, i, i, ptr, ptr]
    lib.wseg_pamr_affinity_limits.argtypes = [ptr]
    lib.wseg_pamr_propagate.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i,
                                        i, ptr, ptr]
    lib.wseg_pamr_propagate_clusters.argtypes = [i] * 5
    lib.wseg_pamr_propagate_limits.argtypes = [ptr]
    for name in ("wseg_pamr_affinity", "wseg_pamr_affinity_limits",
                 "wseg_pamr_propagate",
                 "wseg_pamr_max_dilations", "wseg_pamr_propagate_max_plane",
                 "wseg_pamr_propagate_clusters",
                 "wseg_pamr_propagate_limits"):
        getattr(lib, name).restype = ctypes.c_int
    lib.wseg_pamr_max_dilations.argtypes = []
    lib.wseg_pamr_propagate_max_plane.argtypes = []
    got = (ctypes.c_int * 8)()
    n = lib.wseg_pamr_propagate_limits(ctypes.addressof(got))
    limits = tuple(got[:n]) + (lib.wseg_pamr_max_dilations(),)
    n = lib.wseg_pamr_affinity_limits(ctypes.addressof(got))
    limits += tuple(got[:n])
    want = LIMITS + (MAX_DILATIONS,) + AFFINITY_LIMITS
    if limits != want:
        raise RuntimeError(
            f"csrc/pamr.cu's limits {limits} differ from ops/pamr_cuda.py's "
            f"{want}: change both together")
    return lib


@functools.lru_cache(maxsize=None)
def _active_clusters(index: int, g: int, p: int, n: int, threads: int,
                     smem: int) -> int:
    """Clusters of a launch that card ``index`` holds at once
    (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(index):
        k = _library().wseg_pamr_propagate_clusters(g, p, n, threads, smem)
    if k < 0:
        raise RuntimeError(f"no occupancy for the propagation launch (G "
                           f"{g}, N {n}): CUDA error {-k}")
    return k


@functools.lru_cache(maxsize=256)
def _plan(b: int, c: int, h: int, w: int, dil: Tuple[int, ...],
          num_iter: int, index: int):
    """(plan, the C entry's plan ints, its dilation ints) of a
    propagation on card ``index``, cached by shape."""
    plan = propagate_plan(b, c, h, w, len(dil), num_iter,
                          functools.partial(_active_clusters, index),
                          torch.cuda.get_device_properties(index)
                          .multi_processor_count)
    return (plan, (ctypes.c_int * 6)(*plan.host_ints()),
            (ctypes.c_int * len(dil))(*dil))


def _check(t: torch.Tensor, name: str) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (B, ., H, W), got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no PAMR kernel for device {t.device}")


def _check_kernel_args(max_dil: int, dil: Tuple[int, ...],
                       *tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("PAMR kernel tensors must be contiguous "
                         "channels-major (B, ., H, W)")
    if len(dil) > max_dil:
        raise ValueError(f"{len(dil)} dilations exceed the kernel's "
                         f"{max_dil}")


@functools.lru_cache(maxsize=256)
def _affinity_launch(b: int, h: int, w: int, dil: Tuple[int, ...]):
    """(plan, the C entry's plan ints, its dilation ints) of an affinity,
    cached by shape and dilations."""
    plan = affinity_plan(b, h, w, dil)
    return (plan, (ctypes.c_int * 3)(*plan.host_ints()),
            (ctypes.c_int * len(dil))(*dil))


def affinity_plan_for(im: torch.Tensor,
                      dilations: Sequence[int]) -> AffinityPlan:
    """The plan ``pamr_affinity_cm`` launches for guide ``im``."""
    b, _, h, w = im.shape
    return _affinity_launch(b, h, w, _dilations(dilations))[0]


def _launch_affinity(im: torch.Tensor, dil: Tuple[int, ...], plan_ints,
                     dil_ints) -> torch.Tensor:
    """Launch the affinity kernel with a plan's C ints (checked
    arguments, a CUDA guide) and count it; enters the guide's device
    only where it is not the current one."""
    b, _, h, w = im.shape
    out = im.new_empty((b, 8 * len(dil), h, w))
    args = (im.data_ptr(), out.data_ptr(), ctypes.addressof(dil_ints),
            len(dil), b, h, w, ctypes.addressof(plan_ints))
    lib = _library()
    if im.device.index == torch.cuda.current_device():
        rc = lib.wseg_pamr_affinity(*args,
                                    torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(im.device):
            rc = lib.wseg_pamr_affinity(
                *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PAMR affinity kernel launch failed: CUDA "
                           f"error {rc}")
    pamr_affinity_cm.launches += 1
    return out


def pamr_affinity_cm(im: torch.Tensor,
                     dilations: Sequence[int]) -> torch.Tensor:
    """Guide (B, 3, H, W) float32 -> (B, 8 * D, H, W) float32 softmax
    affinities.  On the card, raises ``ValueError`` where the guide's
    window does not fit a CTA's shared memory (``affinity_plan``)."""
    dil = _dilations(dilations)
    _check(im, "guide")
    if im.device.type == "cpu":
        return pamr_affinity_cm_reference(im, dil)
    _require_cuda(im)
    _check_kernel_args(MAX_DILATIONS, dil, im)
    b, k, h, w = im.shape
    if k != 3:
        raise ValueError(f"the affinity kernel takes 3 guide channels, got "
                         f"{k}")
    if im.numel() == 0:
        return torch.empty((b, 8 * len(dil), h, w), dtype=torch.float32,
                           device=im.device)
    _, plan_ints, dil_ints = _affinity_launch(b, h, w, dil)
    return _launch_affinity(im, dil, plan_ints, dil_ints)


def _propagate_args(aff: torch.Tensor, mask: torch.Tensor,
                    dilations: Sequence[int],
                    num_iter: int) -> Tuple[int, ...]:
    """Check a propagation's arguments; returns the dilations."""
    dil = _dilations(dilations)
    _check(aff, "aff")
    _check(mask, "mask")
    b, c, h, w = mask.shape
    if tuple(aff.shape) != (b, 8 * len(dil), h, w):
        raise ValueError(f"aff {tuple(aff.shape)} does not match mask "
                         f"{tuple(mask.shape)} and {len(dil)} dilations")
    if aff.device != mask.device:
        raise ValueError(f"aff on {aff.device}, mask on {mask.device}")
    if int(num_iter) < 0:
        raise ValueError(f"num_iter must be >= 0, got {num_iter}")
    return dil


def propagate_plan_for(mask: torch.Tensor, dilations: Sequence[int],
                       num_iter: int) -> PropagatePlan:
    """The plan ``pamr_propagate_cm`` launches for ``mask`` on its card."""
    b, c, h, w = mask.shape
    return _plan(b, c, h, w, _dilations(dilations), int(num_iter),
                 mask.device.index)[0]


def _launch_propagate(aff: torch.Tensor, mask: torch.Tensor,
                      dil: Tuple[int, ...], num_iter: int, plan_ints,
                      dil_ints) -> torch.Tensor:
    """Launch the propagation kernel with a plan's C ints (checked
    arguments, CUDA tensors) and count it."""
    b, c, h, w = mask.shape
    with torch.cuda.device(mask.device):
        lib = _library()
        out = torch.empty_like(mask)
        rc = lib.wseg_pamr_propagate(
            aff.data_ptr(), mask.data_ptr(), out.data_ptr(),
            ctypes.addressof(dil_ints), len(dil), b, c, h, w, num_iter,
            ctypes.addressof(plan_ints),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PAMR propagation kernel launch failed: CUDA "
                           f"error {rc}")
    pamr_propagate_cm.launches += 1
    return out


def pamr_propagate_cm(aff: torch.Tensor, mask: torch.Tensor,
                      dilations: Sequence[int],
                      num_iter: int = 10) -> torch.Tensor:
    """aff (B, 8 * D, H, W), mask (B, C, H, W), both float32 ->
    (B, C, H, W) float32 after ``num_iter`` Jacobi steps, one launch."""
    dil = _propagate_args(aff, mask, dilations, num_iter)
    if mask.device.type == "cpu":
        return pamr_propagate_cm_reference(aff, mask, dil, num_iter)
    _require_cuda(mask)
    _check_kernel_args(MAX_DILATIONS, dil, aff, mask)
    if mask.numel() == 0:
        return torch.empty_like(mask)
    b, c, h, w = mask.shape
    num_iter = int(num_iter)
    _, plan_ints, dil_ints = _plan(b, c, h, w, dil, num_iter,
                                   mask.device.index)
    return _launch_propagate(aff, mask, dil, num_iter, plan_ints, dil_ints)


pamr_affinity_cm.launches = 0
pamr_propagate_cm.launches = 0
pamr_affinity_cm.kernel_name = "pamr_affinity_kernel"
pamr_propagate_cm.kernel_name = "pamr_propagate_cluster_kernel"
