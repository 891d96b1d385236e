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
kernel launches (``quantize_act`` launches two in dynamic mode: the
|x| max and the quantize pass); ``.kernel_name`` is a name the
profiler's records of the wrapper's kernels hold.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wseg_tpu_torch import _build

CP_ALIGN = 32
# the kernels' fixed geometry (csrc/qconv.cu); ``_library`` checks it
# against the built library's: {Cp alignment, tile M, tile N, threads}
LIMITS = (CP_ALIGN, 128, 128, 256)
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
    sx = bits = None
    if sc is None:
        bits = torch.zeros(b, dtype=torch.int32, device=x.device)
        sx = torch.empty(b, dtype=torch.float32, device=x.device)
    else:
        sc = sc.contiguous()
    vec = int(x.data_ptr() % 16 == 0 and (c * h * w) % 8 == 0)
    # a dense NCHW or channels_last image is one run of C*H*W elements
    _, sc_, sh, sw_ = x.stride()
    sb = c * h * w
    with torch.cuda.device(x.device):
        rc = lib.wseg_quantize_act(
            x.data_ptr(), sb, sc_, sh, sw_, b, c, h, w, cp,
            None if sc is None else sc.data_ptr(),
            None if bits is None else bits.data_ptr(),
            None if sx is None else sx.data_ptr(), xq.data_ptr(), vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"activation quantize kernel launch failed: "
                           f"CUDA error {rc}")
    quantize_act.launches += 1 if sc is not None else 2
    return xq, sx


quantize_act.launches = 0
quantize_act.kernel_name = "quantize_kernel"  # and absmax_kernel


def out_size(n: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


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
    ho, wo = out_size(h, kh, stride, pad, dil), out_size(w, kw, stride, pad,
                                                         dil)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for a {h}x{w} input")
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
    lib.wseg_qconv_s8.argtypes = [p, p, p, p, p, p, p] + [i] * 12 + [p]
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
