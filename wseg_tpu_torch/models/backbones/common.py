"""Backbone and head building blocks: the three BatchNorm behaviours of
the reference recipe, dropout that draws from an explicit generator, and
the conv helper.

As in ``wseg_tpu/models/backbones/common.py``:

* ``FrozenBatchNorm`` -- backbone BNs (stats and affine both frozen): a
  constant per-channel affine folded into one multiply-add;
* ``AffineNorm`` -- ASPP BNs (stats frozen at their init, mean 0 and
  var 1, affine trained): ``x * weight / sqrt(1 + eps) + bias``;
* ``BatchNorm`` -- decoder, GCI and skip BNs: batch statistics in
  ``.train()`` with running averages updated as Flax's ``BatchNorm``
  updates them, the running averages in ``.eval()``.

All three carry torch BatchNorm names (``weight``, ``bias``,
``running_mean``, ``running_var``) so reference checkpoints load by
name.  Layout NCHW.

``QuantConv`` is the int8 serving mode's backbone conv (``NET.DTYPE
int8``): an ``nn.Conv2d`` with the same parameters (a bf16 or float32
checkpoint loads unchanged) whose forward runs w8a8 through
``ops/qconv.py``; ``calibrating``, ``quant_stats`` and
``load_quant_stats`` drive its static activation scales.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.ops.qconv import (
    amax_scale,
    qconv_s8,
    quantize_act,
    quantize_weight,
)
from wseg_tpu_torch.parallel import dist

# backbone quantization modes of the int8 serving mode (NET.DTYPE int8):
# per-image dynamic activation scales, or calibrated per-input-channel
# static ones (NET.QUANT_ACT static)
INT8 = "int8"
INT8_STATIC = "int8_static"
QUANT_MODES = (INT8, INT8_STATIC)
# the serving mode's refusal to train, as the JAX trainer words it
INT8_TRAIN_ERROR = ("NET.DTYPE 'int8' is inference-only (w8a8 convs are "
                    "not differentiable); train with 'bfloat16' or "
                    "'float32'")


def _without_casts(fn):
    """``fn`` of ``Module._apply`` without its dtype casts: device moves
    and memory formats apply, a floating tensor keeps its dtype."""
    def apply(t):
        out = fn(t)
        if t.is_floating_point() and out.dtype != t.dtype:
            return t.to(device=out.device)
        return out

    return apply


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias, all constant.

    With ``keep_dtype`` set (the int8 mode's backbone: ``get_backbone``
    with ``quant``) a cast of the module leaves its tensors' dtype, so
    the constants fold from float32 as JAX's float32 params do."""

    keep_dtype = False

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _apply(self, fn, recurse=True):
        return super()._apply(_without_casts(fn) if self.keep_dtype else fn,
                              recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # fold in float32, apply in the activation dtype
        mul = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        add = self.bias.float() - self.running_mean.float() * mul
        return (x * mul.to(x.dtype)[None, :, None, None]
                + add.to(x.dtype)[None, :, None, None])


class AffineNorm(nn.Module):
    """Trainable affine with identity statistics: ``x * weight /
    sqrt(1 + eps) + bias`` (a reference BN kept in eval mode from
    construction).  ``use_scale=False`` has no affine and computes
    ``x / sqrt(1 + eps)``.  The identity statistics are buffers so the
    state_dict is a BN's."""

    def __init__(self, features: int, eps: float = 1e-5,
                 use_scale: bool = True):
        super().__init__()
        self.inv = 1.0 / math.sqrt(1.0 + eps)
        self.use_scale = use_scale
        if use_scale:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_scale:
            return x * self.inv
        return (x * (self.weight * self.inv).to(x.dtype)[None, :, None, None]
                + self.bias.to(x.dtype)[None, :, None, None])


class BatchNorm(nn.Module):
    """Live BatchNorm with Flax's running-average rule.

    ``.train()``: normalises with the batch mean and biased variance
    over (N, H, W), and updates ``running = momentum * running + (1 -
    momentum) * batch`` with the *biased* batch variance (``momentum``
    0.9, Flax's convention; ``nn.BatchNorm2d`` would take the unbiased
    one).  ``.eval()``: normalises with the running averages.  The
    running statistics keep their buffers' dtype (float32 in training)
    whatever the activations' dtype.  Inside ``frozen_running_stats``
    a ``.train()`` forward normalises with the batch statistics and
    leaves the running ones as they are (the SEAM step's second
    forward, whose statistics Flax discards).
    ``affine=False`` has no weight and bias.

    In a process group of more than one rank (``parallel/dist.py``) a
    ``.train()`` forward normalises with the statistics of the global
    batch, as GSPMD computes them under JAX's sharded ``jit``: the
    per-channel sum, sum of squares and count are all-reduced over the
    ranks (``dist.all_reduce_sum``, whose backward sums the gradients
    over the ranks too) and the variance is Flax's E[x^2] - E[x]^2,
    both sums accumulated in float64 (in float32 the difference cancels
    to ~1e-6 of the statistics); the running averages take the same
    global statistics.
    """

    update_running = True

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.9, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if dist.world_size() > 1:
            return self._global_forward(x)
        if self.update_running:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The train-mode forward on the statistics over every rank."""
        c = x.shape[1]
        xf = x.float()
        f64 = torch.float64
        count = torch.full((1,), float(x.numel() // c), dtype=f64,
                           device=x.device)
        total = dist.all_reduce_sum(torch.cat([
            xf.sum(dim=(0, 2, 3), dtype=f64),
            (xf * xf).sum(dim=(0, 2, 3), dtype=f64), count]))
        mean = total[:c] / total[-1]
        var = (total[c:2 * c] / total[-1] - mean * mean).clamp_min(0.0)
        mean, var = mean.float(), var.float()
        if self.update_running:
            self._update_running(mean.detach(), var.detach())
        shape = (1, c, 1, 1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.weight is not None:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(m).add_(mean.to(self.running_mean.dtype),
                                       alpha=1.0 - m)
        self.running_var.mul_(m).add_(var.to(self.running_var.dtype),
                                      alpha=1.0 - m)


@contextmanager
def frozen_running_stats(model: nn.Module):
    """Within this, ``model``'s live ``BatchNorm``s keep their running
    statistics (a ``.train()`` forward still normalises with the batch's)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_running = False
    try:
        yield
    finally:
        for m in bns:
            m.update_running = True


class Dropout(nn.Dropout):
    """Elementwise dropout (kept units scaled by 1 / (1 - p)) that draws
    from an explicit ``torch.Generator``: set ``.generator`` (on the
    activations' device) before training; without one it draws from
    torch's default generator, as ``nn.Dropout``."""

    generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device,
                          generator=self.generator) >= self.p
        return x * (keep.to(x.dtype) / (1.0 - self.p))


class Dropout2d(nn.Dropout2d):
    """Channel dropout (whole channels of NCHW, kept ones scaled by
    1 / (1 - p)) that draws from an explicit ``torch.Generator``: set
    ``.generator`` (on the activations' device) before training; without
    one it draws from torch's default generator, as ``nn.Dropout2d``."""

    generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand((x.shape[0], x.shape[1], 1, 1), device=x.device,
                          generator=self.generator) >= self.p
        return x * (keep.to(x.dtype) / (1.0 - self.p))


class QuantConv(nn.Conv2d):
    """w8a8 conv of the int8 serving mode (``wseg_tpu``'s ``QuantConv``).

    The parameters are a ``Conv2d``'s and stay float32 whatever the
    model is cast to (``_apply`` keeps their dtype): the weights are
    quantized from float32, as in JAX, per output channel, once per
    weight set (cached by the tensors' version counters, so a
    ``load_state_dict``, an in-place update or a new ``amax`` refreshes
    it).  Inputs are bfloat16 (B, C, H, W).

    * ``cin < 16`` (the RGB stems): no quantization; the bf16-rounded
      weight and the input convolve with float32 accumulation (a
      float32 conv of bf16 values: every product is exact, TF32 or
      not), ``+ bias`` in float32, one rounding to bf16;
    * ``act_mode="dynamic"``: per-image activation scales
      (``ops/qconv.quantize_act`` without ``sc``);
    * ``act_mode="static"``: per-input-channel scales from the
      calibrated ``amax`` buffer (not persistent: not in the
      state_dict), folded into the weight before it is quantized;
    * ``calibrating`` (static mode only): the forward max-accumulates
      each input channel's |x| into ``amax`` and computes its output by
      the dynamic path.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, act_mode: str = "dynamic"):
        if act_mode not in ("dynamic", "static"):
            raise ValueError(f"act_mode must be 'dynamic' or 'static', got "
                             f"{act_mode!r}")
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, dilation=dilation, bias=bias)
        self.act_mode = act_mode
        self.quantized = in_ch >= 16
        self.calibrating = False
        if self.quantized and act_mode == "static":
            self.register_buffer("amax", torch.zeros(in_ch),
                                 persistent=False)
        self._cache: dict = {}

    def _apply(self, fn, recurse=True):
        self._cache = {}
        return super()._apply(_without_casts(fn), recurse)

    def _cached(self, kind: str, deps, make):
        w = self.weight
        key = (w.device, w.data_ptr(), w._version) + tuple(
            (t.data_ptr(), t._version) for t in deps)
        hit = self._cache.get(kind)
        if hit is None or hit[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                hit = (key, make())
            self._cache[kind] = hit
        return hit[1]

    def quantized_weight(self, static: bool):
        """(wq int8 (Cout, kh, kw, Cp), sw (Cout,), sc (cin,) or None)
        of the current weights: static mode's folds in the calibrated
        per-channel scales."""
        if not static:
            return self._cached(
                "dynamic", (),
                lambda: quantize_weight(self.weight.detach()) + (None,))

        def make():
            sc = amax_scale(self.amax)
            return quantize_weight(self.weight.detach(), sc) + (sc,)

        return self._cached("static", (self.amax,), make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.detach()
        if not self.quantized:
            w = self._cached("float", (), lambda: self.weight.detach().to(
                torch.bfloat16).float())
            y = F.conv2d(x.to(torch.bfloat16).float(), w, bias, self.stride,
                         self.padding, self.dilation)
            return y.to(torch.bfloat16)
        if self.calibrating:
            self._observe(x)
        static = self.act_mode == "static" and not self.calibrating
        wq, sw, sc = self.quantized_weight(static)
        xq, sx = quantize_act(x, sc)
        return qconv_s8(xq, wq, sx, sw, bias, self.stride[0],
                        self.padding[0], self.dilation[0])

    def _observe(self, x: torch.Tensor) -> None:
        with torch.inference_mode(False), torch.no_grad():
            cur = x.detach().float().abs().amax(dim=(0, 2, 3))
            self.amax.copy_(torch.maximum(self.amax, cur))


def static_quant_convs(model: nn.Module) -> Dict[str, QuantConv]:
    """{module name: QuantConv} of ``model``'s convs that carry static
    activation statistics (``amax``)."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, QuantConv) and hasattr(m, "amax")}


@contextmanager
def calibrating(model: nn.Module):
    """Within this, every static ``QuantConv`` of ``model``
    max-accumulates its input's per-channel |x| into ``amax`` (and
    computes its output by the dynamic path)."""
    convs = static_quant_convs(model)
    if not convs:
        raise ValueError("the model has no QuantConv statistics: build it "
                         "with NET.DTYPE int8 and NET.QUANT_ACT static")
    for m in convs.values():
        m.calibrating = True
    try:
        yield
    finally:
        for m in convs.values():
            m.calibrating = False


def quant_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{conv name: float32 (cin,) amax} on the CPU: the ``NET.QUANT_STATS``
    file's contents (``torch.save`` of this dict)."""
    return {name: m.amax.detach().float().cpu().clone()
            for name, m in static_quant_convs(model).items()}


@torch.no_grad()
def load_quant_stats(model: nn.Module,
                     stats: Dict[str, torch.Tensor]) -> None:
    """Set every static ``QuantConv``'s ``amax`` from ``stats`` (as
    ``quant_stats`` returns it); the names and shapes must match
    exactly."""
    convs = static_quant_convs(model)
    missing = sorted(set(convs) - set(stats))
    extra = sorted(set(stats) - set(convs))
    if missing or extra:
        raise KeyError(f"quant stats do not match the model's static "
                       f"convs: missing {missing[:5]}, unexpected "
                       f"{extra[:5]} ({len(missing)} and {len(extra)})")
    for name, m in convs.items():
        v = torch.as_tensor(stats[name], dtype=torch.float32)
        if tuple(v.shape) != tuple(m.amax.shape):
            raise ValueError(f"quant stats of {name}: shape "
                             f"{tuple(v.shape)}, expected "
                             f"{tuple(m.amax.shape)}")
        m.amax.copy_(v)


def conv(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
         dilation: int = 1, bias: bool = False,
         quant: Optional[str] = None) -> nn.Conv2d:
    """kxk conv with torch-style symmetric 'same' padding; with ``quant``
    (``INT8`` or ``INT8_STATIC``) a ``QuantConv``."""
    pad = (kernel - 1) // 2 * dilation
    if quant is None:
        return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad,
                         dilation=dilation, bias=bias)
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quantization {quant!r}")
    return QuantConv(in_ch, out_ch, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=bias,
                     act_mode="static" if quant == INT8_STATIC
                     else "dynamic")


@torch.no_grad()
def seeded_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer from ``generator``.

    Convs and linears: He-normal weights; biases small.  Frozen and live
    BNs: a random affine and random statistics (var > 0), so the BN fold
    is exercised rather than left at the identity; ``AffineNorm``: a
    random affine (its statistics stay the identity).
    """
    def normal_(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std + mean)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            normal_(m.weight, math.sqrt(2.0 / fan_in))
            if m.bias is not None:
                normal_(m.bias, 0.01)
        elif isinstance(m, (FrozenBatchNorm, BatchNorm)):
            if m.weight is not None:
                normal_(m.weight, 0.1, 1.0)
                normal_(m.bias, 0.1)
            normal_(m.running_mean, 0.1)
            normal_(m.running_var, 0.1, 1.0)
            m.running_var.abs_().clamp_(min=0.5)
        elif isinstance(m, AffineNorm) and m.use_scale:
            normal_(m.weight, 0.1, 1.0)
            normal_(m.bias, 0.1)


def set_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Give every random module of ``model`` (dropout, channel dropout,
    the stochastic gate: each has a ``generator`` attribute) the
    generator ``generator``."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


@torch.no_grad()
def stabilize_scratch_init(backbone: nn.Module, scale: float = 0.0) -> None:
    """Scale the last conv of every residual branch by ``scale``.

    With random weights the identity-ish frozen BNs let activations grow
    multiplicatively through the residual stack; ``scale=0`` is the
    SkipInit of ``wseg_tpu``'s ``stabilize_scratch_init`` (every block
    starts as its shortcut), a small ``scale`` keeps the branches live
    while bounding the growth.  A block names its branch's last conv in
    ``LAST_CONV`` (WRN38's blocks, ResNet's bottlenecks); VGG16 has no
    residual block and is left as it is.  Only for weights that were not
    loaded.
    """
    for block in backbone.modules():
        name = getattr(type(block), "LAST_CONV", None)
        if name is not None:
            getattr(block, name).weight.mul_(scale)
