"""The PAMR propagation variants of the kernel lab: CUDA kernel wrappers
and plain versions.

Ports of the three TPU kernels of ``tools/bench_pamr.py`` (the JAX
package's PAMR kernel lab): ``propagate_fold``, ``propagate_dxfirst``
and ``propagate_mxu``, with its names and its NHWC contract: aff
(B, H, W, 8 * D), mask (B, H, W, C) -> (B, H, W, C) float32 after
``num_iter`` steps of ``m <- sum_t aff_t * shift_t(m)``, edge
replicated.  They compute the function of ``ops/pamr_cuda.py::
pamr_propagate_cm`` and differ from it, and from each other, in the
order of the sum and in what is rounded:

* fold: taps summed in ``_dy_groups`` order (sorted dy, then tap order);
  the input and each step's result stored as ``store_dtype`` (float32
  or bfloat16), products accumulated in float32;
* dxfirst: the same, summed in ``_dx_groups`` order (sorted dx, then
  tap order);
* mxu: planes stay float32, ``_dy_groups`` order; with
  ``precision="default"`` every shifted read is rounded to bfloat16
  before its multiply by aff (a single-pass bf16 selector product, the
  TPU's DEFAULT), ``"highest"`` reads exact float32.

``block_b`` is the number of (batch, channel) planes of one image that
a thread block holds: channels, not batch items as on the TPU, because
the affinities are per image.  It changes how the kernels run, never
the result.  The CUDA source is ``csrc/pamr_variants.cu`` (its header
says what each design tests and what bounds it).

Each ``*_cm`` wrapper takes channels-major tensors and dispatches as
``ops/pamr_cuda.py`` does: a CPU tensor goes to the plain version beside
it (``*_cm_reference``), a CUDA tensor launches the kernel (building it
on first use) or raises, naming the limit a shape exceeds.  ``.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from wseg_tpu_torch import _build
from wseg_tpu_torch.ops.pamr_cuda import (
    _edge_pad,
    _check_kernel_args,
    _propagate_args,
    _require_cuda,
    pamr_taps,
)

DILATIONS = (1, 2, 4, 8, 12, 24)
PRECISIONS = ("highest", "default")
_STORE = {torch.float32: 0, torch.bfloat16: 1}


def _dy_groups(taps):
    """Group tap indices by their row offset: [(dy, [(t, dx), ...]), ...]"""
    groups = {}
    for t, (dy, dx) in enumerate(taps):
        groups.setdefault(dy, []).append((t, dx))
    return sorted(groups.items())


def _dx_groups(taps):
    """Group tap indices by their column offset: [(dx, [(t, dy), ...])]."""
    groups = {}
    for t, (dy, dx) in enumerate(taps):
        groups.setdefault(dx, []).append((t, dy))
    return sorted(groups.items())


def _order(groups) -> List[int]:
    """Tap indices in summation order."""
    return [t for _, group in groups for t, _ in group]


def _plan(taps, groups):
    """The kernels' plan: (dy, dx, t) per tap in summation order, then
    the start of each group and the end, as a ctypes int array."""
    rows, starts = [], [0]
    for _, group in groups:
        for t, _ in group:
            rows.extend((*taps[t], t))
        starts.append(starts[-1] + len(group))
    vals = rows + starts
    return (ctypes.c_int * len(vals))(*vals), len(groups)


def _propagate_plain(aff: torch.Tensor, mask: torch.Tensor,
                     dilations: Sequence[int], num_iter: int,
                     order: Sequence[int], store_dtype: torch.dtype,
                     read_dtype: torch.dtype) -> torch.Tensor:
    """Plain propagation summed in ``order``: the planes stored as
    ``store_dtype``, each shifted read rounded to ``read_dtype`` and
    multiplied by aff in float32, accumulated in float32."""
    taps = pamr_taps(dilations)
    aff = aff.float()
    m = mask.float().to(store_dtype)
    h, w = m.shape[2], m.shape[3]
    pad = max(abs(v) for tap in taps for v in tap)
    for _ in range(int(num_iter)):
        padded = _edge_pad(m.float(), pad)
        acc = torch.zeros(m.shape, dtype=torch.float32, device=m.device)
        for t in order:
            dy, dx = taps[t]
            v = padded[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            acc = acc + aff[:, t:t + 1] * v.to(read_dtype).float()
        m = acc.to(store_dtype)
    return m.float()


def propagate_fold_cm_reference(aff, mask, dilations=DILATIONS,
                                num_iter: int = 10,
                                store_dtype=torch.float32):
    """Plain fold: ``_dy_groups`` order, planes stored as
    ``store_dtype``."""
    taps = pamr_taps(dilations)
    return _propagate_plain(aff, mask, dilations, num_iter,
                            _order(_dy_groups(taps)), store_dtype,
                            torch.float32)


def propagate_dxfirst_cm_reference(aff, mask, dilations=DILATIONS,
                                   num_iter: int = 10,
                                   store_dtype=torch.float32):
    """Plain dxfirst: ``_dx_groups`` order, planes stored as
    ``store_dtype``."""
    taps = pamr_taps(dilations)
    return _propagate_plain(aff, mask, dilations, num_iter,
                            _order(_dx_groups(taps)), store_dtype,
                            torch.float32)


def propagate_mxu_cm_reference(aff, mask, dilations=DILATIONS,
                               num_iter: int = 10,
                               precision: str = "highest"):
    """Plain mxu: ``_dy_groups`` order, float32 planes, reads rounded to
    bfloat16 with ``precision="default"``."""
    taps = pamr_taps(dilations)
    read = torch.bfloat16 if _precision(precision) == "default" \
        else torch.float32
    return _propagate_plain(aff, mask, dilations, num_iter,
                            _order(_dy_groups(taps)), torch.float32, read)


def _precision(precision: str) -> str:
    p = str(precision).lower()
    if p not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return p


def _store(store_dtype) -> int:
    if store_dtype not in _STORE:
        raise TypeError(f"store_dtype must be torch.float32 or "
                        f"torch.bfloat16, got {store_dtype}")
    return _STORE[store_dtype]


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("pamr_variants")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    common = [ptr, ptr, ptr, ptr, i, i, i, i, i, i, i, i]
    lib.wseg_pamr_fold.argtypes = common + [i, ptr]
    lib.wseg_pamr_dxfirst.argtypes = common + [i, ptr]
    lib.wseg_pamr_mxu.argtypes = common + [i, i, ptr]
    for name in ("wseg_pamr_fold", "wseg_pamr_dxfirst", "wseg_pamr_mxu",
                 "wseg_pamr_max_dilations", "wseg_pamr_variant_max_block",
                 "wseg_pamr_variant_max_pixels", "wseg_pamr_mxu_max_tiles",
                 "wseg_pamr_variant_smem"):
        getattr(lib, name).restype = ctypes.c_int
    for name in ("wseg_pamr_max_dilations", "wseg_pamr_variant_max_block",
                 "wseg_pamr_variant_max_pixels", "wseg_pamr_mxu_max_tiles",
                 "wseg_pamr_variant_smem"):
        getattr(lib, name).argtypes = []
    return lib


def _block(block_b: int) -> int:
    nb = int(block_b)
    if nb < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    return nb


def _check_shared(lib, nbytes: int, what: str) -> None:
    limit = lib.wseg_pamr_variant_smem()
    if nbytes > limit:
        raise ValueError(f"{what} take {nbytes} bytes of shared memory, "
                         f"above the kernel's limit of {limit}")


def _launch(fn, name: str, aff, mask, dil, num_iter, groups, *extra):
    """Launch ``fn`` (a ctypes kernel launcher) on checked tensors."""
    b, c, h, w = mask.shape
    out = torch.empty_like(mask)
    if mask.numel() == 0:
        return out
    plan, n_groups = _plan(pamr_taps(dil), groups)
    rc = fn(aff.data_ptr(), mask.data_ptr(), out.data_ptr(),
            ctypes.addressof(plan), 8 * len(dil), n_groups, b, c, h, w,
            int(num_iter), *extra, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def _simt_variant(name, grouping, aff, mask, dilations, num_iter, block_b,
                 store_dtype, plain, counter):
    """fold and dxfirst: checks, dispatch, launch and count."""
    dil = _propagate_args(aff, mask, dilations, num_iter)
    store = _store(store_dtype)
    nb = _block(block_b)
    if mask.device.type == "cpu":
        return plain(aff, mask, dil, num_iter, store_dtype)
    _require_cuda(mask)
    b, c, h, w = mask.shape
    with torch.cuda.device(mask.device):
        lib = _library()
        _check_kernel_args(lib.wseg_pamr_max_dilations(), dil, aff, mask)
        if nb > lib.wseg_pamr_variant_max_block():
            raise ValueError(f"block_b {nb} exceeds the kernel's "
                             f"{lib.wseg_pamr_variant_max_block()} planes")
        if h * w > lib.wseg_pamr_variant_max_pixels():
            raise ValueError(
                f"a {h}x{w} plane exceeds the {name} kernel's limit of "
                f"{lib.wseg_pamr_variant_max_pixels()} pixels (9 per "
                "thread, accumulators in registers)")
        planes = nb + (name == "dxfirst")
        _check_shared(lib, planes * h * w * (2 if store else 4),
                      f"{planes} {h}x{w} planes of {store_dtype}")
        fn = getattr(lib, f"wseg_pamr_{name}")
        out = _launch(fn, f"PAMR {name}", aff, mask, dil, num_iter,
                      grouping(pamr_taps(dil)), nb, store)
    counter.launches += 1
    return out


def propagate_fold_cm(aff, mask, dilations=DILATIONS, num_iter: int = 10,
                      block_b: int = 1, store_dtype=torch.float32):
    """aff (B, 8 * D, H, W), mask (B, C, H, W), float32 -> (B, C, H, W)
    float32: the fold variant, one launch."""
    return _simt_variant("fold", _dy_groups, aff, mask, dilations, num_iter,
                        block_b, store_dtype, propagate_fold_cm_reference,
                        propagate_fold_cm)


def propagate_dxfirst_cm(aff, mask, dilations=DILATIONS, num_iter: int = 10,
                         block_b: int = 1, store_dtype=torch.float32):
    """aff (B, 8 * D, H, W), mask (B, C, H, W), float32 -> (B, C, H, W)
    float32: the dx-first variant, one launch."""
    return _simt_variant("dxfirst", _dx_groups, aff, mask, dilations,
                        num_iter, block_b, store_dtype,
                        propagate_dxfirst_cm_reference, propagate_dxfirst_cm)


def propagate_mxu_cm(aff, mask, dilations=DILATIONS, num_iter: int = 10,
                     block_b: int = 1, precision: str = "highest"):
    """aff (B, 8 * D, H, W), mask (B, C, H, W), float32 -> (B, C, H, W)
    float32: shifts as one-hot selector products on the tensor cores,
    one launch."""
    dil = _propagate_args(aff, mask, dilations, num_iter)
    precision = _precision(precision)
    nb = _block(block_b)
    if mask.device.type == "cpu":
        return propagate_mxu_cm_reference(aff, mask, dil, num_iter,
                                          precision)
    _require_cuda(mask)
    b, c, h, w = mask.shape
    with torch.cuda.device(mask.device):
        lib = _library()
        _check_kernel_args(lib.wseg_pamr_max_dilations(), dil, aff, mask)
        tiles = -(-nb * h // 16) * -(-w // 8)
        if tiles > lib.wseg_pamr_mxu_max_tiles():
            raise ValueError(
                f"{nb} {h}x{w} planes make {tiles} output tiles of 16x8, "
                f"above the mxu kernel's {lib.wseg_pamr_mxu_max_tiles()} "
                "(accumulators in registers)")
        _check_shared(lib, nb * h * w * 4, f"{nb} {h}x{w} float32 planes")
        out = _launch(lib.wseg_pamr_mxu, "PAMR mxu", aff, mask, dil,
                      num_iter, _dy_groups(pamr_taps(dil)), nb, max(dil),
                      3 if precision == "highest" else 1)
    propagate_mxu_cm.launches += 1
    return out


def _nhwc(fn, aff, mask, *args, **kw):
    cm = fn(aff.permute(0, 3, 1, 2).contiguous(),
            mask.permute(0, 3, 1, 2).contiguous(), *args, **kw)
    return cm.permute(0, 2, 3, 1)


def propagate_fold(aff, mask, dilations=DILATIONS, num_iter: int = 10,
                   block_b: int = 1, store_dtype=torch.float32):
    """NHWC fold: aff (B, H, W, 8 * D), mask (B, H, W, C) -> (B, H, W, C)."""
    return _nhwc(propagate_fold_cm, aff, mask, dilations, num_iter,
                 block_b, store_dtype)


def propagate_dxfirst(aff, mask, dilations=DILATIONS, num_iter: int = 10,
                      block_b: int = 1, store_dtype=torch.float32):
    """NHWC dx-first: aff (B, H, W, 8 * D), mask (B, H, W, C) ->
    (B, H, W, C)."""
    return _nhwc(propagate_dxfirst_cm, aff, mask, dilations, num_iter,
                 block_b, store_dtype)


def propagate_mxu(aff, mask, dilations=DILATIONS, num_iter: int = 10,
                  block_b: int = 1, precision: str = "highest"):
    """NHWC mxu: aff (B, H, W, 8 * D), mask (B, H, W, C) -> (B, H, W, C)."""
    return _nhwc(propagate_mxu_cm, aff, mask, dilations, num_iter,
                 block_b, precision)


propagate_fold_cm.launches = 0
propagate_dxfirst_cm.launches = 0
propagate_mxu_cm.launches = 0
