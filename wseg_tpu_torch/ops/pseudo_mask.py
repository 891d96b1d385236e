"""Pseudo ground truth and the class-balanced mask CE loss (NHWC).

Mirror of ``wseg_tpu/ops/pseudo_mask.py`` (reference
models/SoftMaxAE.py:29-88).
"""

from __future__ import annotations

import torch

from wseg_tpu_torch.ops.resize import resize_bilinear


def pseudo_gtmask(mask: torch.Tensor, cutoff_top: float = 0.6,
                  cutoff_bkg: float = 0.7,
                  cutoff_low: float = 0.2) -> torch.Tensor:
    """(B, H, W, C) continuous masks (channel 0 = background) -> float
    {0, 1} one-hot pseudo-GT: per class threshold at ``cutoff * max_xy``
    floored at ``cutoff_low`` (``cutoff_bkg`` for the background);
    pixels claimed by more than one class are zeroed."""
    mask = mask.float()
    mask_max = torch.amax(mask, dim=(1, 2), keepdim=True)
    cut = torch.full((mask.shape[-1],), cutoff_top, dtype=torch.float32,
                     device=mask.device)
    cut[0] = cutoff_bkg
    thresh = torch.clamp(mask_max * cut, min=cutoff_low)
    pseudo = (mask > thresh).float()
    ambiguous = pseudo.sum(dim=-1, keepdim=True) > 1.0
    return torch.where(ambiguous, torch.zeros_like(pseudo), pseudo)


def balanced_mask_loss_ce(mask_logits: torch.Tensor, pseudo_gt: torch.Tensor,
                          gt_labels: torch.Tensor) -> torch.Tensor:
    """Class-balanced CE of ``mask_logits`` (B, h, w, C), upscaled
    (align_corners=True) to the pseudo-GT size, against ``pseudo_gt``
    (B, H, W, C); pixels without a class are ignored, each pixel weighs
    (N_total - N_class) / (1 + N_total) of its class, and a row counts
    only if its pseudo mask holds exactly the GT classes + background.
    Returns the (B,) per-sample loss."""
    b, h, w, _ = pseudo_gt.shape
    logits = resize_bilinear(mask_logits.float(), (h, w), align_corners=True)
    pseudo_gt = pseudo_gt.float()
    valid = pseudo_gt.sum(dim=-1) >= 1.0
    ce = -torch.sum(pseudo_gt * torch.log_softmax(logits, dim=-1), dim=-1)

    per_class = pseudo_gt.sum(dim=(1, 2))                       # (B, C)
    total = per_class.sum(dim=-1, keepdim=True)
    class_weight = (total - per_class) / (1.0 + total)
    pixel_weight = torch.einsum("bhwc,bc->bhw", pseudo_gt, class_weight)

    gt_num = gt_labels.float().sum(dim=-1) + 1.0
    ps_num = (per_class > 0).float().sum(dim=-1)
    batch_weight = (gt_num == ps_num).float()

    loss_px = torch.where(valid, pixel_weight * ce, torch.zeros_like(ce))
    return batch_weight * loss_px.reshape(b, -1).mean(dim=-1)
