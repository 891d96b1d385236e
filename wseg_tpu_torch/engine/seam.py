"""SEAM-style equivariance-regularised train step (mirror of
``wseg_tpu/engine/seam.py``).

A second forward at 0.5x scale (reference train_SEAM.py:85-135).  The
optimised loss is

    mean(criterion(cls1)) + er_on * mean(criterion(cls2))
    + [attn_loss_weight * mean(attention_loss(attn1))  with the SA map]
    + [mask_loss_on * MASK_LOSS_BCE * l_mask1 + er_on * loss_er
                                                    with refined masks]

with ``loss_er = er_weight * mean(|stopgrad(resize(lg1 -> lg2's size))
- lg2|)`` between the first forward's mask logits, resized
(align_corners=True), and the second's.  ``loss_er`` is logged every
step but optimised only by heads with refined masks; the second
forward's mask loss is folded into the logged ``loss_mask`` once the
ER phase starts, and never optimised (as in the reference).  The live
BatchNorms' running statistics come from the first forward alone: the
second normalises with its batch's statistics and leaves them as they
are (JAX keeps the first forward's ``batch_stats``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.profiler import record_function

from wseg_tpu_torch.engine.train_loop import (
    backward_and_step,
    check_batch,
    expected_batch_keys,
    normalise_batch_image,
)
from wseg_tpu_torch.losses import (
    attention_loss,
    get_criterion,
    self_supervision_loss,
)
from wseg_tpu_torch.models.backbones.common import frozen_running_stats
from wseg_tpu_torch.ops.resize import resize_bilinear


def seam_train_step(model, optimizer, batch: Dict[str, torch.Tensor],
                    mask_loss_on: float, er_on: float, *,
                    device_jitter: bool = True,
                    loss_name: str = "SoftMargin",
                    attn_loss_weight: float = 0.0,
                    mask_loss_bce: float = 1.0, scale_factor: float = 0.5,
                    er_weight: float = 0.01,
                    grad_clip: float = 0.0) -> Dict[str, torch.Tensor]:
    """One SGD step of the SEAM loss on ``batch`` (image uint8, labels,
    [jitter]) on the model's device; metrics as detached 0-d tensors
    (``loss_cls``, ``loss_fg``, ``loss_er``, ``loss``, and ``loss_at``
    and ``loss_mask`` where the head has them)."""
    check_batch(batch, expected_batch_keys(device_jitter))
    criterion = get_criterion(loss_name)
    labels = batch["labels"].float()
    mask_on, er_on = float(mask_loss_on), float(er_on)
    with record_function("train.forward"):
        image, image_raw = normalise_batch_image(batch["image"],
                                                 batch.get("jitter"))
        out1 = model(image, image_raw, labels)
    with record_function("train.forward_half"):
        size2 = (int(image.shape[1] * scale_factor),
                 int(image.shape[2] * scale_factor))
        image2 = resize_bilinear(image, size2, align_corners=True)
        image2_raw = resize_bilinear(image_raw, size2, align_corners=True)
        with frozen_running_stats(model):
            out2 = model(image2, image2_raw, labels)
    with record_function("train.loss"):
        loss_cls = criterion(out1.cls, labels).mean() \
            + er_on * criterion(out2.cls, labels).mean()
        loss = loss_cls
        metrics = {"loss_cls": loss_cls, "loss_fg": out1.cls_fg.mean()}
        if attn_loss_weight > 0 and out1.attn_map is not None:
            l_at = attention_loss(out1.attn_map).mean()
            loss = loss + attn_loss_weight * l_at
            metrics["loss_at"] = l_at
        lg2 = out2.mask_logits
        lg1 = resize_bilinear(out1.mask_logits.detach(),
                              (lg2.shape[1], lg2.shape[2]),
                              align_corners=True)
        loss_er = er_weight * (lg1 - lg2).abs().mean()
        metrics["loss_er"] = loss_er
        if out1.masks_dec is not None:
            l_mask, _ = self_supervision_loss(out1.mask_logits,
                                              out1.masks_dec, labels)
            l_mask = l_mask.mean()
            loss = loss + mask_on * mask_loss_bce * l_mask + er_on * loss_er
            with torch.no_grad():
                l_mask2, _ = self_supervision_loss(lg2, out2.masks_dec,
                                                   labels)
            metrics["loss_mask"] = l_mask + er_on * l_mask2.mean()
        metrics["loss"] = loss
    backward_and_step(optimizer, loss, grad_clip)
    return {k: v.detach() for k, v in metrics.items()}
