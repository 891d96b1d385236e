"""Semantic-FPN head (reference models/mods/FPN.py:37-157).

Mirror of ``wseg_tpu/models/heads/fpn.py``.  The reference ships this
head but wires it into no model, and neither does ``wseg_tpu``'s
registry; it is here so that the port holds every module of the JAX
package.  Takes the multi-level taps {conv3, conv4, conv5, conv6}
(NHWC) and returns a fused map at the finest tap's resolution: lateral
1x1 convs, a top-down pathway of half-pixel bilinear upsampling, a
3x3 conv + ReLU per level, everything upsampled to the finest level and
summed.  Module names ``lateral_<tap>`` / ``smooth_<tap>`` as in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from wseg_tpu_torch.models.backbones.common import conv
from wseg_tpu_torch.ops.activations import relu
from wseg_tpu_torch.ops.resize import resize_bilinear

LEVELS = ("conv3", "conv4", "conv5", "conv6")


class FPN(nn.Module):
    """``in_channels`` maps each tap the head reads to its channels."""

    def __init__(self, in_channels: Dict[str, int], out_channels: int = 256):
        super().__init__()
        self.levels = [k for k in LEVELS if k in in_channels]
        if len(self.levels) < 2:
            raise ValueError("FPN needs multi-level taps")
        for k in self.levels:
            self.add_module(f"lateral_{k}",
                            conv(in_channels[k], out_channels, 1))
            self.add_module(f"smooth_{k}",
                            conv(out_channels, out_channels, 3))

    @staticmethod
    def _conv(layer, x):
        return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, taps: Dict[str, torch.Tensor]) -> torch.Tensor:
        lats = [self._conv(getattr(self, f"lateral_{k}"), taps[k])
                for k in self.levels]
        outs = [lats[-1]]
        for lat in reversed(lats[:-1]):
            up = resize_bilinear(outs[0], lat.shape[1:3], align_corners=False)
            outs.insert(0, lat + up)
        fused = None
        target = outs[0].shape[1:3]
        for k, o in zip(self.levels, outs):
            o = relu(self._conv(getattr(self, f"smooth_{k}"), o))
            if o.shape[1:3] != target:
                o = resize_bilinear(o, target, align_corners=False)
            fused = o if fused is None else fused + o
        return fused
