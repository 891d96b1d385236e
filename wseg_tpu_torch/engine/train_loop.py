"""Training and evaluation steps (mirror of
``wseg_tpu/engine/train_loop.py``).

Loss composition (reference train.py:126-152):

    loss = mean(criterion(cls, labels))
         + [attn_loss_weight * mean(attention_loss)   if the head has it]
         + [mask_loss_on * MASK_LOSS_BCE * mean(self-supervision loss)]

``mask_loss_on`` is the ``TRAIN.PRETRAIN`` gate (0 before, 1 after).
The steps take the device batch as a dict and check its keys against
those the configuration implies, so a dropped key (e.g. the colour
jitter of ``DATASET.DEVICE_JITTER``) raises instead of training without
it.  Metrics come back as detached 0-d tensors so the caller decides
when to synchronise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from wseg_tpu_torch.losses import (
    attention_loss,
    get_criterion,
    self_supervision_loss,
)
from wseg_tpu_torch.ops.jitter import apply_colour_jitter

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalise_batch_image(image: torch.Tensor,
                          jitter: Optional[torch.Tensor] = None):
    """uint8 (B, H, W, 3) -> (ImageNet-normalised, raw [0, 1]) float32,
    colour jitter (B, 9) applied first when given."""
    if image.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 image batch, got {image.dtype}")
    x = image.float()
    if jitter is not None:
        x = apply_colour_jitter(x, jitter)
    raw = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (raw - mean) / std, raw


def expected_batch_keys(device_jitter: bool, train: bool = True):
    """Keys of a device batch: image and labels, plus jitter for a
    training batch under ``DATASET.DEVICE_JITTER``."""
    keys = {"image", "labels"}
    if train and device_jitter:
        keys.add("jitter")
    return keys


def check_batch(batch: Dict[str, torch.Tensor], keys) -> None:
    missing = sorted(set(keys) - set(batch))
    extra = sorted(set(batch) - set(keys))
    if missing or extra:
        raise KeyError(f"batch keys {sorted(batch)}: missing {missing}, "
                       f"unexpected {extra} (expected {sorted(keys)})")


def _losses(out, labels, criterion, attn_loss_weight, mask_loss_bce,
            mask_loss_on):
    loss_cls = criterion(out.cls, labels).mean()
    loss = loss_cls
    metrics = {"loss_cls": loss_cls, "loss_fg": out.cls_fg.mean()}
    if attn_loss_weight > 0 and out.attn_map is not None:
        l_at = attention_loss(out.attn_map).mean()
        loss = loss + attn_loss_weight * l_at
        metrics["loss_at"] = l_at
    if out.masks_dec is not None:
        l_mask, _ = self_supervision_loss(out.mask_logits, out.masks_dec,
                                          labels)
        l_mask = l_mask.mean()
        loss = loss + mask_loss_on * mask_loss_bce * l_mask
        metrics["loss_mask"] = l_mask
    metrics["loss"] = loss
    return loss, metrics


def train_step(model, optimizer, batch: Dict[str, torch.Tensor],
               mask_loss_on: float, *, device_jitter: bool = True,
               loss_name: str = "SoftMargin", attn_loss_weight: float = 0.0,
               mask_loss_bce: float = 1.0,
               grad_clip: float = 0.0) -> Dict[str, torch.Tensor]:
    """One SGD step on ``batch`` (image uint8, labels, [jitter]) on the
    model's device.  Dropout follows the model's train/eval mode."""
    check_batch(batch, expected_batch_keys(device_jitter))
    criterion = get_criterion(loss_name)
    labels = batch["labels"].float()
    with record_function("train.forward"):
        image, image_raw = normalise_batch_image(batch["image"],
                                                 batch.get("jitter"))
        out = model(image, image_raw, labels)
    with record_function("train.loss"):
        loss, metrics = _losses(out, labels, criterion, attn_loss_weight,
                                mask_loss_bce, float(mask_loss_on))
    backward_and_step(optimizer, loss, grad_clip)
    return {k: v.detach() for k, v in metrics.items()}


def backward_and_step(optimizer, loss: torch.Tensor,
                      grad_clip: float = 0.0) -> None:
    """Backward of ``loss`` and one ``optimizer`` step, in the
    ``train.backward`` and ``train.optim`` ranges."""
    with record_function("train.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with record_function("train.optim"):
        # a trainable tensor the loss does not reach (PCM's f8_3, f8_4
        # and f9 feed only the detached pseudo-GT) takes a zero gradient,
        # so weight decay and momentum still move it, as optax does
        for g in optimizer.param_groups:
            for p in g["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if grad_clip > 0.0:
            torch.nn.utils.clip_grad_norm_(
                [p for g in optimizer.param_groups for p in g["params"]],
                grad_clip)
        optimizer.step()


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor], *,
              loss_name: str = "SoftMargin", attn_loss_weight: float = 0.0,
              mask_loss_bce: float = 1.0):
    """Validation step: the same losses with the mask loss always on, no
    gradient.  Returns (metrics, cls scores (B, C-1)); dropout follows
    the model's mode (the trainer calls it in ``.eval()``)."""
    check_batch(batch, expected_batch_keys(False, train=False))
    labels = batch["labels"].float()
    image, image_raw = normalise_batch_image(batch["image"])
    out = model(image, image_raw, labels)
    _, metrics = _losses(out, labels, get_criterion(loss_name),
                         attn_loss_weight, mask_loss_bce, 1.0)
    return metrics, out.cls
