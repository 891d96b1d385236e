"""WideResNet-38 trunk, module names as the reference's.

Mirror of ``wseg_tpu/models/backbones/resnet38.py``: pre-activation
residual blocks, output stride 8, dilation 2 in b5, bottleneck blocks
b6/b7 at dilation 4 with channel dropout (``Dropout2d`` after
``bn_branch2b1`` and after ``bn_branch2b2``, rates 0.3 in b6 and 0.5 in
b7; active in ``.train()`` mode only), final BN+ReLU to 4096 channels.
Every BN is a ``FrozenBatchNorm``.  Layout NCHW inside; ``forward``
returns the tap dict (``conv3``, ``conv3_pre``, ``conv4``, ``conv5``,
``conv6``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from wseg_tpu_torch.models.backbones.common import (
    Dropout2d,
    FrozenBatchNorm,
    conv,
)
from wseg_tpu_torch.ops.activations import relu


class ResBlock(nn.Module):
    """Pre-activation 3x3/3x3 residual block."""

    LAST_CONV = "conv_branch2b1"

    def __init__(self, in_ch: int, mid: int, out: int, stride: int = 1,
                 first_dilation: int | None = None, dilation: int = 1):
        super().__init__()
        fd = first_dilation if first_dilation is not None else dilation
        self.same_shape = in_ch == out and stride == 1
        self.bn_branch2a = FrozenBatchNorm(in_ch)
        if not self.same_shape:
            self.conv_branch1 = conv(in_ch, out, 1, stride)
        self.conv_branch2a = conv(in_ch, mid, 3, stride, fd)
        self.bn_branch2b1 = FrozenBatchNorm(mid)
        self.conv_branch2b1 = conv(mid, out, 3, 1, dilation)

    def forward(self, x):
        b = relu(self.bn_branch2a(x))
        x_bn_relu = b
        shortcut = x if self.same_shape else self.conv_branch1(b)
        b = self.conv_branch2a(b)
        b = relu(self.bn_branch2b1(b))
        b = self.conv_branch2b1(b)
        return shortcut + b, x_bn_relu


class ResBlockBot(nn.Module):
    """Pre-activation 1x1/3x3/1x1 bottleneck with channel dropout."""

    LAST_CONV = "conv_branch2b2"

    def __init__(self, in_ch: int, out: int, stride: int = 1,
                 dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        self.dropout_2b1 = Dropout2d(dropout)
        self.dropout_2b2 = Dropout2d(dropout)
        self.bn_branch2a = FrozenBatchNorm(in_ch)
        self.conv_branch1 = conv(in_ch, out, 1, stride)
        self.conv_branch2a = conv(in_ch, out // 4, 1, stride)
        self.bn_branch2b1 = FrozenBatchNorm(out // 4)
        self.conv_branch2b1 = conv(out // 4, out // 2, 3, 1, dilation)
        self.bn_branch2b2 = FrozenBatchNorm(out // 2)
        self.conv_branch2b2 = conv(out // 2, out, 1)

    def forward(self, x):
        b = relu(self.bn_branch2a(x))
        x_bn_relu = b
        shortcut = self.conv_branch1(b)
        b = self.conv_branch2a(b)
        b = self.dropout_2b1(relu(self.bn_branch2b1(b)))
        b = self.conv_branch2b1(b)
        b = self.dropout_2b2(relu(self.bn_branch2b2(b)))
        b = self.conv_branch2b2(b)
        return shortcut + b, x_bn_relu


class ResNet38(nn.Module):
    """WRN-38 trunk; ``forward`` takes NCHW and returns a tap dict."""

    # tap name -> channels
    TAPS = {"conv3": 256, "conv3_pre": 256, "conv4": 512, "conv5": 1024,
            "conv6": 4096}

    def __init__(self):
        super().__init__()
        self.conv1a = conv(3, 64, 3)
        self.b2 = ResBlock(64, 128, 128, 2)
        self.b2_1 = ResBlock(128, 128, 128)
        self.b2_2 = ResBlock(128, 128, 128)
        self.b3 = ResBlock(128, 256, 256, 2)
        self.b3_1 = ResBlock(256, 256, 256)
        self.b3_2 = ResBlock(256, 256, 256)
        self.b4 = ResBlock(256, 512, 512, 2)
        for i in range(1, 6):
            setattr(self, f"b4_{i}", ResBlock(512, 512, 512))
        self.b5 = ResBlock(512, 512, 1024, 1, first_dilation=1, dilation=2)
        self.b5_1 = ResBlock(1024, 512, 1024, dilation=2)
        self.b5_2 = ResBlock(1024, 512, 1024, dilation=2)
        self.b6 = ResBlockBot(1024, 2048, 1, 4, dropout=0.3)
        self.b7 = ResBlockBot(2048, 4096, 1, 4, dropout=0.5)
        self.bn7 = FrozenBatchNorm(4096)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.conv1a(x)
        x, _ = self.b2(x)
        x, _ = self.b2_1(x)
        x, _ = self.b2_2(x)
        x, _ = self.b3(x)
        x, _ = self.b3_1(x)
        x, _ = self.b3_2(x)
        conv3 = x
        x, conv3_pre = self.b4(x)
        for i in range(1, 6):
            x, _ = getattr(self, f"b4_{i}")(x)
        x, conv4 = self.b5(x)
        x, _ = self.b5_1(x)
        x, _ = self.b5_2(x)
        x, conv5 = self.b6(x)
        x, _ = self.b7(x)
        conv6 = relu(self.bn7(x))
        return {"conv3": conv3, "conv3_pre": conv3_pre, "conv4": conv4,
                "conv5": conv5, "conv6": conv6}
