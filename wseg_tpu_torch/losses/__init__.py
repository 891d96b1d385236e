"""Loss functions of the train step (mirror of ``wseg_tpu/losses``).

Pure functions over NHWC tensors returning per-sample values; the train
step reduces them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wseg_tpu_torch.ops.pseudo_mask import balanced_mask_loss_ce, pseudo_gtmask


def multilabel_soft_margin_loss(logits: torch.Tensor,
                                targets: torch.Tensor) -> torch.Tensor:
    """-mean_c [y log sigma(x) + (1 - y) log sigma(-x)] per sample
    (``cfg.NET.LOSS`` 'SoftMargin', the default)."""
    x, y = logits.float(), targets.float()
    return -torch.mean(y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x),
                       dim=-1)


def multilabel_hinge_loss(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Sum over (positive i, negative j) pairs of max(0, 1 - (x_i - x_j))
    / C per sample (``cfg.NET.LOSS`` 'Hinge')."""
    x, y = logits.float(), targets.float()
    margin = torch.clamp(1.0 - (x[:, :, None] - x[:, None, :]), min=0.0)
    pairs = y[:, :, None] * (1.0 - y)[:, None, :]
    return torch.sum(margin * pairs, dim=(1, 2)) / x.shape[-1]


def get_criterion(loss_name: str):
    losses = {"SoftMargin": multilabel_soft_margin_loss,
              "Hinge": multilabel_hinge_loss}
    return losses[loss_name]


def attention_loss(attn_map: torch.Tensor) -> torch.Tensor:
    """L2 penalty on the spatial-attention softmax map: sum of a^2 over
    positions, per sample."""
    return torch.sum(torch.square(attn_map.float()), dim=-1)


def self_supervision_loss(mask_logits: torch.Tensor,
                          masks_dec: torch.Tensor, gt_labels: torch.Tensor):
    """Pseudo-GT from the refined masks (no gradient) + class-balanced
    CE.  Returns (per-sample loss (B,), pseudo_gt)."""
    pseudo_gt = pseudo_gtmask(masks_dec.detach())
    return balanced_mask_loss_ce(mask_logits, pseudo_gt, gt_labels), pseudo_gt
