"""ResNet-50/101 trunk at output stride 16, module names as torchvision's.

Mirror of ``wseg_tpu/models/backbones/resnet.py``: bottleneck blocks
(stride on the 3x3 conv), layer4 at stride 1, taps ``conv3`` (layer1's
output, stride 4) and ``conv6`` (layer4's, stride 16).  Every BN is a
``FrozenBatchNorm``.  Names follow torchvision (``conv1``, ``bn1``,
``layer{i}.{j}.conv1``, ``layer{i}.{j}.downsample.0`` / ``.1``), so an
ImageNet ``resnet50-19c8e357.pth`` loads by name.  The deep 3-conv stem
(``deep_base``), which the reference asserts off, is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.models.backbones.common import FrozenBatchNorm, conv
from wseg_tpu_torch.ops.activations import relu


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4 channels) with a projection
    shortcut when the shape changes."""

    LAST_CONV = "conv3"
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv(in_ch, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv(planes, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = None
        if stride != 1 or in_ch != out:
            self.downsample = nn.Sequential(conv(in_ch, out, 1, stride),
                                            FrozenBatchNorm(out))

    def forward(self, x):
        y = relu(self.bn1(self.conv1(x)))
        y = relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return relu(y + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet with ``layers`` blocks per stage; ``forward``
    takes NCHW and returns the tap dict."""

    # tap name -> channels
    TAPS = {"conv3": 256, "conv6": 2048}

    def __init__(self, layers: Sequence[int]):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        in_ch = 64
        for i, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 1))):
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(in_ch, planes,
                                         stride if j == 0 else 1))
                in_ch = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        conv3 = self.layer1(x)
        x = self.layer3(self.layer2(conv3))
        return {"conv3": conv3, "conv6": self.layer4(x)}


def ResNet50() -> ResNet:
    return ResNet((3, 4, 6, 3))


def ResNet101() -> ResNet:
    return ResNet((3, 4, 23, 3))
