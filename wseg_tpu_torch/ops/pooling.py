"""Classification-score pooling (nGWP + focal penalty) over NHWC tensors.

Formulas as ``wseg_tpu/ops/pooling.py``:
  nGWP:  cls_c = sum_xy(logits_c * m_c) / (1 + sum_xy m_c)
  focal: (1 - m̄_c)^p * log(lambda + m̄_c)
"""

from __future__ import annotations

import torch


def focal_penalty(x: torch.Tensor, p: float = 3.0, c: float = 0.01):
    """(1-x)^p * log(c + x), elementwise, in float32."""
    x = x.float()
    return torch.pow(1.0 - x, p) * torch.log(c + x)


def ngwp_pool(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) logits and masks -> (B, C) pooled scores."""
    logits = logits.float()
    masks = masks.float()
    num = torch.sum(logits * masks, dim=(1, 2))
    den = 1.0 + torch.sum(masks, dim=(1, 2))
    return num / den


def ngwp_focal_scores(logits: torch.Tensor, masks: torch.Tensor,
                      focal_p: float = 3.0, focal_lambda: float = 0.01):
    """nGWP + focal penalty without the background channel: (B, C-1)."""
    cls_1 = ngwp_pool(logits, masks)
    m_mean = torch.mean(masks.float(), dim=(1, 2))
    cls_2 = focal_penalty(m_mean, focal_p, focal_lambda)
    return cls_1[:, 1:] + cls_2[:, 1:]
