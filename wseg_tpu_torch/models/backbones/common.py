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
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias, all constant."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

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
        if self.update_running:
            self._update_running(x)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    @torch.no_grad()
    def _update_running(self, x: torch.Tensor) -> None:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
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


def conv(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
         dilation: int = 1, bias: bool = False) -> nn.Conv2d:
    """kxk conv with torch-style symmetric 'same' padding."""
    pad = (kernel - 1) // 2 * dilation
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=bias)


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
