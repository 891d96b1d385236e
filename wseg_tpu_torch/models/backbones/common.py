"""Backbone building blocks: the frozen BatchNorm, channel dropout and
the conv helper.

``FrozenBatchNorm`` is the backbone BN of the reference recipe (stats
and affine both frozen, ``wseg_tpu/models/backbones/common.py``): a
constant per-channel affine folded into one multiply-add.  Its tensors
carry torch BatchNorm names (``weight``, ``bias``, ``running_mean``,
``running_var``) so reference checkpoints load by name.  Layout NCHW.
"""

from __future__ import annotations

import math

import torch
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

    Convs and linears: He-normal weights; biases small.  Frozen BNs:
    a random affine and random statistics (var > 0), so the BN fold is
    exercised rather than left at the identity.
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
        elif isinstance(m, FrozenBatchNorm):
            normal_(m.weight, 0.1, 1.0)
            normal_(m.bias, 0.1)
            normal_(m.running_mean, 0.1)
            normal_(m.running_var, 0.1, 1.0)
            m.running_var.abs_().clamp_(min=0.5)


@torch.no_grad()
def stabilize_scratch_init(backbone: nn.Module, scale: float = 0.0) -> None:
    """Scale the last conv of every residual branch by ``scale``.

    With random weights the identity-ish frozen BNs let activations grow
    multiplicatively through the residual stack; ``scale=0`` is the
    SkipInit of ``wseg_tpu``'s ``stabilize_scratch_init`` (every block
    starts as its shortcut), a small ``scale`` keeps the branches live
    while bounding the growth.  Only for weights that were not loaded.
    """
    for block in backbone.modules():
        last = getattr(block, "conv_branch2b2", None) or getattr(
            block, "conv_branch2b1", None)
        if last is not None:
            last.weight.mul_(scale)
