"""4-group SGD with the reference's per-group LR multipliers.

Mirror of ``wseg_tpu/parallel/optim.py``: parameters split into
{pretrained weight, pretrained bias, head weight, head bias} groups at
LR multipliers (1, 2, 10, 20) -- (1, 1, 10, 10) for ResNet-50/101 --
weight decay on the weight groups only,
momentum 0.9 without Nesterov or dampening.  optax's
``add_decayed_weights -> trace -> scale(-lr)`` is exactly
``torch.optim.SGD``'s update (decay added to the gradient, buffer
m <- mu * m + g starting at g, p <- p - lr * m).

Frozen parameters (every ``FrozenBatchNorm`` and the backbone's stem:
``conv1a``, ``b2``, ``b2_1``, ``b2_2`` for WRN38, ``conv1``/``bn1`` for
ResNet, ``conv1_1``/``conv1_2`` for VGG16) get ``requires_grad=False``
and stay out of the optimizer.  Backbone and head are told apart by the
``_backbone`` module's parameters (``StageNet`` registers the
backbone's children on itself); the ``ae`` decoder's ``AffineNorm`` and
live ``BatchNorm`` weights and biases are head parameters, as
``label_params`` labels them in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from wseg_tpu_torch.models.backbones.common import FrozenBatchNorm

# group labels, as wseg_tpu/models/backbones/common.py names them
FROZEN = "frozen"
PRE_W = "pre_w"
PRE_B = "pre_b"
NEW_W = "new_w"
NEW_B = "new_b"
GROUPS = (PRE_W, PRE_B, NEW_W, NEW_B)

_STEM_PREFIXES = {
    "resnet38": ("conv1a", "b2", "b2_1", "b2_2"),
    "resnet50": ("conv1", "bn1"),
    "resnet101": ("conv1", "bn1"),
    "vgg16": ("conv1_1", "conv1_2"),
}


def lr_multipliers(backbone: str):
    """LR multipliers of GROUPS for ``backbone``."""
    if backbone in ("resnet50", "resnet101"):
        return (1.0, 1.0, 10.0, 10.0)
    return (1.0, 2.0, 10.0, 20.0)


def label_params(model: nn.Module, backbone: str) -> Dict[str, str]:
    """Parameter name -> group label (FROZEN / PRE_W / PRE_B / NEW_W /
    NEW_B), in ``model.named_parameters()`` order."""
    backbone_ids = {id(p) for p in model._backbone.parameters()}
    frozen_ids = {id(p) for m in model.modules()
                  if isinstance(m, FrozenBatchNorm) for p in m.parameters()}
    stems = _STEM_PREFIXES.get(backbone, ())
    labels = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in frozen_ids or name.split(".")[0] in stems:
            labels[name] = FROZEN
        elif id(p) in backbone_ids:
            labels[name] = PRE_B if leaf == "bias" else PRE_W
        else:
            labels[name] = NEW_B if leaf == "bias" else NEW_W
    return labels


def make_optimizer(net_cfg, model: nn.Module):
    """(torch.optim.SGD over the four groups, label dict).  Sets
    ``requires_grad=False`` on the frozen parameters."""
    opt_name = str(net_cfg.OPT)
    if opt_name == "Adam":
        raise NotImplementedError("NET.OPT 'Adam' is not ported yet "
                                  "(ROADMAP.md queue A, 'Training')")
    if opt_name != "SGD":
        raise NotImplementedError(f"Optimizer '{opt_name}'")
    backbone = str(net_cfg.BACKBONE)
    labels = label_params(model, backbone)
    base_lr = float(net_cfg.LR)
    wd = float(net_cfg.WEIGHT_DECAY)
    mults = dict(zip(GROUPS, lr_multipliers(backbone)))
    params = dict(model.named_parameters())
    groups = []
    for name, label in labels.items():
        params[name].requires_grad_(label != FROZEN)
    for g in GROUPS:
        groups.append({
            "params": [params[n] for n, lab in labels.items() if lab == g],
            "lr": base_lr * mults[g], "name": g,
            "weight_decay": wd if g in (PRE_W, NEW_W) else 0.0})
    opt = torch.optim.SGD(groups, lr=base_lr,
                          momentum=float(net_cfg.MOMENTUM), dampening=0.0,
                          nesterov=False)
    return opt, labels

