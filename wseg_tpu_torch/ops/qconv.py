"""w8a8 convolution of the int8 serving mode: CUDA kernel wrappers and
plain versions.

The arithmetic of ``wseg_tpu/models/backbones/common.py::QuantConv``,
split where the kernels split it (``csrc/qconv.cu``; its header says
what bounds each kernel and what the design does about it):

* ``quantize_weight`` (plain torch, once per weight set): per output
  channel ``sw = max(max |w|, 1e-12) / 127`` over (kh, kw, cin) of the
  float32 weight (``w * sc`` in static mode), ``wq = clip(round(w /
  sw), +-127)`` packed (Cout, kh, kw, Cp) int8;
* ``quantize_act``: bf16 (B, C, H, W) -> int8 (B, H, W, Cp), per image
  ``sx = max(max |x[b]|, 1e-12) / 127`` (dynamic) or the caller's per
  input channel ``sc`` (static);
* ``qconv_s8``: the int8 x int8 -> int32 conv, then ``f32(acc) * (sx[b]
  * sw[o])`` (static: ``* sw[o]``), ``+ bias`` in float32, one rounding
  to bf16, as a (B, Cout, Ho, Wo) tensor in channels_last layout.

Cp is C rounded up to ``CP_ALIGN`` (32), the pad zero.  Divisions are
tensor by tensor (true IEEE divisions: a division by a Python scalar
may become a reciprocal multiply on CUDA) and ``round`` is half to
even, as ``jnp.round`` and the kernels' ``rintf``.

Each wrapper dispatches on the tensor's device: a CPU tensor goes to
the plain version beside it (``*_reference``), a CUDA tensor launches
the kernel (building it on first use) or raises.  ``.launches`` counts
kernel launches (one a call in both modes); ``.kernel_name`` is a name
the profiler's records of the wrapper's kernel hold.  The host plans
(``qconv_plan``, ``quantize_slots``) pick each launch's geometry in
pure Python, so the CPU tests hold them to the kernels' limits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from wseg_tpu_torch import _build

CP_ALIGN = 32
TILE_M = 128        # output pixels of a conv tile
STAGE_K = 128       # K bytes of a ring stage
THREADS = 384       # two consumer warpgroups and a producer warpgroup
MAX_STAGES = 6
STAGE_COLS = 128    # output channels the epilogue stages at a time
SMEM_LIMIT = 232448  # dynamic shared memory a block may use
# the kernels' fixed geometry (csrc/qconv.cu); ``_library`` checks it
# against the built library's
LIMITS = (CP_ALIGN, TILE_M, STAGE_K, THREADS, MAX_STAGES, SMEM_LIMIT)
TILE_N = (64, 128, 256)
# (Mh, Mw): the M tile's patch of output rows x columns of one image
PATCHES = ((1, 128), (2, 64), (4, 32), (8, 16), (16, 8))
TMA_BOX = 256       # a TMA box dimension's most elements
TMA_ELEM_STRIDE = 8  # a TMA traversal stride's most
# bytes of bf16 images the dynamic quantize keeps in flight, so that its
# second read of an image comes from the 50 MB L2: the best of 1-16
# images in flight at each input of the flagship bucket (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md section 6)
L2_BUDGET = 26_000_000
# the largest int8 code of the symmetric grid, and the scales' floor
QMAX = 127.0
EPS = 1e-12


def padded_channels(c: int) -> int:
    return -(-int(c) // CP_ALIGN) * CP_ALIGN


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b as an IEEE division (b broadcast as a tensor, never a
    Python scalar)."""
    if not torch.is_tensor(b):
        b = torch.full((), float(b), dtype=a.dtype, device=a.device)
        b = b.expand(a.shape)
    return torch.div(a, b)


def amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, float32: the quantization step of a
    largest magnitude (static mode's per-input-channel scales from the
    calibrated ``amax`` (cin,))."""
    return _div(torch.clamp_min(amax.float(), EPS), QMAX)


@torch.no_grad()
def quantize_weight(w: torch.Tensor, sc: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 weight (Cout, cin, kh, kw) [static: times ``sc`` (cin,)
    first] -> (wq int8 (Cout, kh, kw, Cp), sw float32 (Cout,)), on w's
    device."""
    w = w.float()
    if sc is not None:
        w = w * sc.float()[None, :, None, None]
    sw = amax_scale(w.abs().amax(dim=(1, 2, 3)))
    q = torch.clamp(torch.round(_div(w, sw[:, None, None, None])),
                    -QMAX, QMAX).to(torch.int8)
    cout, cin, kh, kw = q.shape
    wq = torch.zeros((cout, kh, kw, padded_channels(cin)), dtype=torch.int8,
                     device=w.device)
    wq[..., :cin] = q.permute(0, 2, 3, 1)
    return wq.contiguous(), sw.contiguous()


def quantize_act_reference(x: torch.Tensor,
                           sc: Optional[torch.Tensor] = None):
    """Plain ``quantize_act``: (xq int8 (B, H, W, Cp), sx float32 (B,)
    or None in static mode)."""
    xf = x.float()
    if sc is None:
        sx = amax_scale(xf.abs().amax(dim=(1, 2, 3)))
        q = _div(xf, sx[:, None, None, None].expand(xf.shape))
    else:
        sx = None
        q = _div(xf, sc.float()[None, :, None, None].expand(xf.shape))
    q = torch.clamp(torch.round(q), -QMAX, QMAX).to(torch.int8)
    b, c, h, w = x.shape
    xq = torch.zeros((b, h, w, padded_channels(c)), dtype=torch.int8,
                     device=x.device)
    xq[..., :c] = q.permute(0, 2, 3, 1)
    return xq, sx


def quantize_slots(b: int, c: int, h: int, w: int, dynamic: bool) -> int:
    """Images the quantize kernel works on at once: in dynamic mode as
    many as ``L2_BUDGET`` holds of bf16 input (at least one), in static
    mode all (no image waits for its |x| max)."""
    if not dynamic:
        return int(b)
    return max(1, min(int(b), L2_BUDGET // (2 * c * h * w)))


def _check_act(x: torch.Tensor, sc: Optional[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"expected bfloat16 activations, got {x.dtype}")
    if sc is not None:
        if tuple(sc.shape) != (x.shape[1],) or sc.dtype != torch.float32:
            raise ValueError(f"sc must be float32 ({x.shape[1]},), got "
                             f"{sc.dtype} {tuple(sc.shape)}")
        if sc.device != x.device:
            raise ValueError(f"x on {x.device}, sc on {sc.device}")


def quantize_act(x: torch.Tensor, sc: Optional[torch.Tensor] = None):
    """bf16 x (B, C, H, W) -> (xq int8 (B, H, W, Cp), sx float32 (B,));
    with ``sc`` (C,) float32 the static per-channel scales, and sx is
    None."""
    _check_act(x, sc)
    if x.device.type == "cpu":
        return quantize_act_reference(x, sc)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        x = x.contiguous(memory_format=torch.channels_last)
    lib = _library()
    b, c, h, w = x.shape
    cp = padded_channels(c)
    xq = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    sx = sync = None
    if sc is None:
        # |x| max bits, then arrival counts, a pair of words an image
        sync = torch.zeros(2 * b, dtype=torch.int32, device=x.device)
        sx = torch.empty(b, dtype=torch.float32, device=x.device)
    else:
        sc = sc.contiguous()
    sb, sc_, sh, sw_ = x.stride()
    with torch.cuda.device(x.device):
        rc = lib.wseg_quantize_act(
            x.data_ptr(), sb, sc_, sh, sw_, b, c, h, w, cp,
            None if sc is None else sc.data_ptr(),
            None if sync is None else sync.data_ptr(),
            None if sx is None else sx.data_ptr(), xq.data_ptr(),
            quantize_slots(b, c, h, w, sc is None),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"activation quantize kernel launch failed: "
                           f"CUDA error {rc}")
    quantize_act.launches += 1
    return xq, sx


quantize_act.launches = 0
quantize_act.kernel_name = "quantize_kernel"


def out_size(n: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


class QconvPlan(NamedTuple):
    """One conv's launch geometry: tile channels ``bn``, bytes ``bk`` of
    one tap's channels a TMA chunk (and its swizzle), the M tile's patch
    ``mh`` x ``mw`` of output pixels, ring ``stages`` and the dynamic
    shared memory ``smem`` they take."""

    bn: int
    bk: int
    mh: int
    mw: int
    stages: int
    smem: int


def qconv_smem(bn: int, stages: int) -> int:
    """Dynamic shared memory of a conv block (csrc/qconv.cu qconv_smem):
    1 KB of alignment slack, the ring's A and B stages, the epilogue's
    bf16 rows (at most ``STAGE_COLS`` channels at a time) and the full
    and empty barriers."""
    return (1024 + stages * (TILE_M + bn) * STAGE_K
            + TILE_M * min(bn, STAGE_COLS) * 2 + 2 * MAX_STAGES * 8)


@functools.lru_cache(maxsize=None)
def qconv_plan(h: int, w: int, cp: int, cout: int, kh: int, kw: int,
               stride: int, pad: int, dil: int) -> QconvPlan:
    """The conv kernel's plan for an (h, w, cp) int8 input: ``bk`` the
    largest of 128, 64, 32 dividing Cp; ``bn`` the tile width of 64,
    128, 256 that pads Cout least (the wider on a tie); the patch that
    pads Ho x Wo least (the wider on a tie) within TMA's box of 256
    elements (``mw * stride``, ``mh * stride``); as many stages as fit
    in shared memory, at most ``MAX_STAGES``."""
    if cp % CP_ALIGN or cp <= 0:
        raise ValueError(f"Cp {cp} is not a positive multiple of "
                         f"{CP_ALIGN}")
    if not 1 <= stride <= TMA_ELEM_STRIDE:
        raise ValueError(f"stride {stride} outside TMA's 1..."
                         f"{TMA_ELEM_STRIDE}")
    ho, wo = out_size(h, kh, stride, pad, dil), out_size(w, kw, stride, pad,
                                                         dil)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for a {h}x{w} input")
    bk = next(k for k in (128, 64, 32) if cp % k == 0)
    bn = min(TILE_N, key=lambda n: (-(-cout // n) * n, -n))
    fits = [p for p in PATCHES if max(p) * stride <= TMA_BOX]
    mh, mw = min(fits, key=lambda p: (-(-ho // p[0]) * p[0]
                                      * (-(-wo // p[1]) * p[1]), -p[1]))
    stages = min(MAX_STAGES, (SMEM_LIMIT - qconv_smem(bn, 0))
                 // ((TILE_M + bn) * STAGE_K))
    return QconvPlan(bn, bk, mh, mw, stages, qconv_smem(bn, stages))


def qconv_tiles(plan: QconvPlan, b: int, ho: int, wo: int, cout: int):
    """The (image, ho0, wo0, n0) origins of the conv kernel's tiles in
    the order its persistent blocks walk them (N fastest)."""
    for bi in range(b):
        for ho0 in range(0, ho, plan.mh):
            for wo0 in range(0, wo, plan.mw):
                for n0 in range(0, cout, plan.bn):
                    yield bi, ho0, wo0, n0


def qconv_store_boxes(plan: QconvPlan, ho0: int, wo0: int):
    """The two consumer warpgroups' TMA store boxes of a tile: (wo, ho,
    columns, rows) each, 64 of the tile's row-major pixels apiece."""
    w = min(plan.mw, 64)
    return [(wo0 + r0 % plan.mw, ho0 + r0 // plan.mw, w, 64 // w)
            for r0 in (0, 64)]


def qconv_acc_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                        pad: int, dil: int) -> torch.Tensor:
    """The int32 sums (B, Cout, Ho, Wo) of the int8 conv: float64
    ``F.conv2d`` of the int8 codes, exact (every partial sum is below
    2^53), with cuDNN off on the card (its FFT and Winograd algorithms
    are not exact)."""
    x = xq.permute(0, 3, 1, 2).double()
    w = wq.permute(0, 3, 1, 2).double()
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x, w, stride=stride, padding=pad, dilation=dil)
    return acc.to(torch.int32)


def dequantize_reference(acc: torch.Tensor, sx: Optional[torch.Tensor],
                         sw: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """int32 acc (B, Cout, Ho, Wo) -> bf16: ``f32(acc) * (sx[b] *
    sw[o])`` (static: ``* sw[o]``), ``+ bias``, one rounding."""
    scale = sw[None, :, None, None]
    if sx is not None:
        scale = sx[:, None, None, None] * scale
    y = acc.float() * scale
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def qconv_s8_reference(xq, wq, sx, sw, bias, stride: int, pad: int,
                       dil: int, acc_only: bool = False) -> torch.Tensor:
    """Plain ``qconv_s8``."""
    acc = qconv_acc_reference(xq, wq, stride, pad, dil)
    if acc_only:
        return acc.contiguous(memory_format=torch.channels_last)
    return dequantize_reference(acc, sx, sw, bias)


def _check_conv(xq, wq, sx, sw, bias) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8 (B, H, W, Cp), got {xq.dtype} "
                         f"{tuple(xq.shape)}")
    if wq.dim() != 4 or wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8 (Cout, kh, kw, Cp), got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if xq.shape[3] != wq.shape[3] or xq.shape[3] % CP_ALIGN:
        raise ValueError(f"xq's {xq.shape[3]} and wq's {wq.shape[3]} "
                         f"channels must agree and be a multiple of "
                         f"{CP_ALIGN}")
    b, cout = xq.shape[0], wq.shape[0]
    for name, t, n in (("sx", sx, b), ("sw", sw, cout), ("bias", bias, cout)):
        if t is None:
            continue
        if tuple(t.shape) != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != xq.device:
            raise ValueError(f"xq on {xq.device}, {name} on {t.device}")
    if wq.device != xq.device:
        raise ValueError(f"xq on {xq.device}, wq on {wq.device}")


def qconv_s8(xq: torch.Tensor, wq: torch.Tensor, sx: Optional[torch.Tensor],
             sw: torch.Tensor, bias: Optional[torch.Tensor], stride: int = 1,
             pad: int = 0, dil: int = 1,
             acc_only: bool = False) -> torch.Tensor:
    """xq int8 (B, H, W, Cp), wq int8 (Cout, kh, kw, Cp), sx (B,) float32
    or None (static), sw (Cout,) float32, bias (Cout,) float32 or None ->
    bf16 (B, Cout, Ho, Wo) in channels_last layout; ``acc_only`` returns
    the int32 sums instead (the kernel's check against the plain
    version)."""
    _check_conv(xq, wq, sx, sw, bias)
    stride, pad, dil = int(stride), int(pad), int(dil)
    if xq.device.type == "cpu":
        return qconv_s8_reference(xq, wq, sx, sw, bias, stride, pad, dil,
                                  acc_only)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    lib = _library()
    xq, wq = xq.contiguous(), wq.contiguous()
    b, h, w, cp = xq.shape
    cout, kh, kw = wq.shape[:3]
    plan = qconv_plan(h, w, cp, cout, kh, kw, stride, pad, dil)
    ho, wo = out_size(h, kh, stride, pad, dil), out_size(w, kw, stride, pad,
                                                         dil)
    dtype = torch.int32 if acc_only else torch.bfloat16
    out = torch.empty((b, ho, wo, cout), dtype=dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        rc = lib.wseg_qconv_s8(
            xq.data_ptr(), wq.data_ptr(),
            None if sx is None else sx.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if acc_only else out.data_ptr(),
            out.data_ptr() if acc_only else None,
            b, h, w, cp, cout, kh, kw, stride, pad, dil, ho, wo,
            plan.bn, plan.bk, plan.mh, plan.mw, plan.stages,
            torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error "
                           f"{rc}")
    qconv_s8.launches += 1
    return out.permute(0, 3, 1, 2)


qconv_s8.launches = 0
qconv_s8.kernel_name = "qconv_kernel"


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("qconv")
    ll, p, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.wseg_quantize_act.argtypes = [p, ll, ll, ll, ll, i, i, i, i, i, p,
                                      p, p, p, i, p]
    lib.wseg_quantize_act.restype = i
    lib.wseg_qconv_s8.argtypes = [p, p, p, p, p, p, p] + [i] * 17 + [p]
    lib.wseg_qconv_s8.restype = i
    lib.wseg_qconv_limits.argtypes = [p]
    lib.wseg_qconv_limits.restype = i
    got = (ctypes.c_int * 8)()
    n = lib.wseg_qconv_limits(ctypes.addressof(got))
    if tuple(got[:n]) != LIMITS:
        raise RuntimeError(
            f"csrc/qconv.cu's limits {tuple(got[:n])} differ from "
            f"ops/qconv.py's {LIMITS}: change both together")
    return lib
