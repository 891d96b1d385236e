"""VGG16 (DeepLab-LargeFOV style) trunk, flat module names.

Mirror of ``wseg_tpu/models/backbones/vgg16.py``: 13 convs with bias,
3x3 max pools (pool4 at stride 1), conv5 dilated by 2, ``fc6`` and
``fc7`` as 1024-channel convs, output stride 8.  ``fc6`` is followed by
``Dropout(0.5)`` (active in ``.train()``; it draws from its
``generator``).  Taps: ``conv3`` (conv3_3's output, stride 4) and
``conv6`` (fc7's).  Names ``conv1_1`` ... ``conv5_3``, ``fc6``,
``fc7``, as the reference's converted ``vgg16_20M.pth``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.models.backbones.common import Dropout, conv
from wseg_tpu_torch.ops.activations import relu

# (name, out channels, dilation) per stage; a 3x3 max pool of the given
# stride follows every stage but the last
_STAGES = (((("conv1_1", 64), ("conv1_2", 64)), 1, 2),
           ((("conv2_1", 128), ("conv2_2", 128)), 1, 2),
           ((("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)), 1, 2),
           ((("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)), 1, 1),
           ((("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)), 2, None))


class VGG16(nn.Module):
    """VGG16 trunk; ``forward`` takes NCHW and returns the tap dict.
    ``quant`` makes every conv a ``QuantConv``."""

    # tap name -> channels
    TAPS = {"conv3": 256, "conv6": 1024}

    def __init__(self, fc6_dilation: int = 1, quant: Optional[str] = None):
        super().__init__()
        in_ch = 3
        for convs, dil, _ in _STAGES:
            for name, out in convs:
                setattr(self, name, conv(in_ch, out, 3, 1, dil, bias=True,
                                         quant=quant))
                in_ch = out
        self.fc6 = conv(512, 1024, 3, 1, fc6_dilation, bias=True,
                        quant=quant)
        self.dropout = Dropout(0.5)
        self.fc7 = conv(1024, 1024, 1, bias=True, quant=quant)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        conv3 = None
        for convs, _, pool in _STAGES:
            for name, _ in convs:
                x = relu(getattr(self, name)(x))
            if name == "conv3_3":
                conv3 = x
            if pool is not None:
                x = F.max_pool2d(x, 3, pool, 1)
        x = self.dropout(relu(self.fc6(x)))
        return {"conv3": conv3, "conv6": relu(self.fc7(x))}
