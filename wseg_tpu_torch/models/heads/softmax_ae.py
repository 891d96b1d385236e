"""SoftMaxAE decoder: ASPP -> skip fusion -> GCI -> stochastic gate ->
3-conv decoder (the CVPR-2020 paper model's head, ``NET.MODEL: ae``).

Mirror of ``wseg_tpu/models/heads/softmax_ae.py``.  Module names are
the reference state_dict's (``aspp.aspp1.atrous_conv``,
``aspp.global_avg_pool.1``, ``fc8_skip.0``, ``shallow_mask.fc_deep.0``,
``last_conv.0`` / ``.4`` / ``.8``, ...; the ``_AE_HEAD_MAP`` of
``wseg_tpu/utils/torch_convert.py``).  ASPP norms are ``AffineNorm``;
the skip, ``fc8_x``, GCI and ``last_conv`` norms are live
``BatchNorm``s (GCI's ``fc_skip`` one without affine).  Dropout(0.5)
follows ASPP and ``last_conv``'s first conv, Dropout(0.1) its second;
they and the gate draw from their ``generator``.  Layout NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from wseg_tpu_torch.models.backbones.common import (
    AffineNorm,
    BatchNorm,
    Dropout,
    conv,
)
from wseg_tpu_torch.ops.activations import ReLU, relu
from wseg_tpu_torch.ops.resize import resize_bilinear
from wseg_tpu_torch.ops.sg import StochasticGate


class _ASPPBranch(nn.Module):
    def __init__(self, in_ch: int, dilation: int):
        super().__init__()
        k = 1 if dilation == 1 else 3
        self.atrous_conv = conv(in_ch, 256, k, 1, dilation)
        self.bn = AffineNorm(256)

    def forward(self, x):
        return relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    """Four atrous branches (dilations 1, 12, 24, 36) and an image-pool
    branch, concatenated -> 1x1 conv to 256 -> dropout 0.5."""

    def __init__(self, in_ch: int):
        super().__init__()
        for i, d in enumerate((1, 12, 24, 36)):
            setattr(self, f"aspp{i + 1}", _ASPPBranch(in_ch, d))
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), conv(in_ch, 256, 1), AffineNorm(256),
            ReLU())
        self.conv1 = conv(5 * 256, 256, 1)
        self.bn1 = AffineNorm(256)
        self.dropout = Dropout(0.5)

    def forward(self, x):
        outs = [getattr(self, f"aspp{i}")(x) for i in range(1, 5)]
        outs.append(self.global_avg_pool(x).expand_as(outs[0]))
        y = relu(self.bn1(self.conv1(torch.cat(outs, dim=1))))
        return self.dropout(y)


class GCI(nn.Module):
    """Global Cue Injection: the deep features' global max-pooled
    (gamma, beta) modulate the normalised shallow features (AdIN)."""

    def __init__(self, shallow_ch: int = 256, deep_ch: int = 256):
        super().__init__()
        self.fc_deep = nn.Sequential(conv(deep_ch, 512, 1), BatchNorm(512),
                                     ReLU())
        self.fc_skip = nn.Sequential(conv(shallow_ch, 256, 1),
                                     BatchNorm(256, affine=False))
        self.fc_cls = nn.Sequential(conv(256, 256, 1), BatchNorm(256),
                                    ReLU())

    def forward(self, x_shallow, y_deep):
        attrs = self.fc_deep(y_deep).amax(dim=(2, 3))         # (B, 512)
        gamma, beta = attrs[:, :256, None, None], attrs[:, 256:, None, None]
        x = self.fc_skip(x_shallow)
        x = relu(x * (gamma + 1.0) + beta)
        return self.fc_cls(x)


class SoftMaxAEDecoder(nn.Module):
    """(conv3, conv6) taps -> (num_classes - 1)-channel mask logits at
    conv3's resolution (NCHW)."""

    def __init__(self, num_classes: int, deep_ch: int, shallow_ch: int = 256,
                 sg_psi: float = 0.3):
        super().__init__()
        self.aspp = ASPP(deep_ch)
        self.fc8_skip = nn.Sequential(conv(shallow_ch, 48, 1), BatchNorm(48),
                                      ReLU())
        self.fc8_x = nn.Sequential(conv(256 + 48, 256, 3), BatchNorm(256),
                                   ReLU())
        self.shallow_mask = GCI(shallow_ch, 256)
        self.sg = StochasticGate(sg_psi)
        self.last_conv = nn.Sequential(
            conv(256, 256, 3), BatchNorm(256), ReLU(), Dropout(0.5),
            conv(256, 256, 3), BatchNorm(256), ReLU(), Dropout(0.1),
            nn.Conv2d(256, num_classes - 1, 1))

    def forward(self, conv3: torch.Tensor, conv6: torch.Tensor):
        x = self.aspp(conv6)
        skip = self.fc8_skip(conv3)
        x_up = resize_bilinear(x.permute(0, 2, 3, 1), skip.shape[2:],
                               align_corners=True).permute(0, 3, 1, 2)
        x = self.fc8_x(torch.cat([x_up, skip], dim=1))
        x2 = self.shallow_mask(conv3, x)
        return self.last_conv(self.sg(x, x2))
