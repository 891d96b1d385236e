"""StageNet: backbone + spec-driven CAM head, test mode.

Mirror of ``wseg_tpu/models/stage_net.py`` for the flagship spec
``CAM_CASA_WGAP_tf``: fc7 1x1 -> window self-attention -> channel and
spatial attention -> fc8 + relu -> softmax with a learned background ->
nGWP + focal scores.  Only the test-mode forward (no labels) is ported;
the train path (PAMR, pseudo-GT, losses) is a later ROADMAP item.

Public layout is NHWC: ``forward(image (B, H, W, 3))`` returns a
``ModelOutput`` with ``cls`` (B, C-1) and ``masks`` (B, H, W, C).

The backbone's layers are registered on the model itself, as in the
reference (whose model classes subclass the backbone), so state_dict
keys read ``conv1a.weight``, ``b2.bn_branch2a.running_mean``, ...,
``fc7.weight``, ``selfattn.qkv.weight``, ``caatention.fc1.weight``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.models.backbones import get_backbone
from wseg_tpu_torch.models.heads.attention import (
    ChannelAttention,
    SpatialAttention,
    WindowAttention,
    pad_to_multiple,
)
from wseg_tpu_torch.ops.pooling import ngwp_focal_scores
from wseg_tpu_torch.ops.resize import rescale_as

_NOT_PORTED = ("not ported yet (ROADMAP.md queue A, 'Rest of the model "
               "zoo')")


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Static architecture switches (the subset the flagship uses; field
    names and defaults as ``wseg_tpu``'s HeadSpec)."""
    name: str = ""
    kind: str = "cam"
    channel_attn: bool = False
    spatial_attn: bool = False
    self_attn: str = ""
    self_attn_ws: Any = 2
    fc7: bool = False
    sa_dim: int = 0
    scoring: str = "cam"
    bg: str = "score"
    mask_branch_relu: bool = False


@dataclasses.dataclass
class ModelOutput:
    """Tensors of one test-mode forward pass (the train path's outputs,
    ``cls_fg``/``masks_dec``/``mask_logits``/``attn_map`` in
    ``wseg_tpu``, come with the training slice)."""
    cls: torch.Tensor
    masks: torch.Tensor


MODEL_SPECS = {
    "CAM_CASA_WGAP_tf": HeadSpec(
        name="CAM_CASA_WGAP_tf", fc7=True, self_attn="window",
        self_attn_ws=2, channel_attn=True, spatial_attn=True,
        scoring="softmax", bg="learned", mask_branch_relu=True),
}


class StageNet(nn.Module):
    """Backbone + flagship head.  ``dtype`` is the compute dtype; call
    ``.to(dtype)`` (``get_model`` does) so the weights match it."""

    def __init__(self, spec: HeadSpec, backbone: str = "resnet38",
                 num_classes: int = 21, focal_p: float = 3.0,
                 focal_lambda: float = 0.01, sa_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        supported = (spec.kind == "cam" and spec.scoring == "softmax"
                     and spec.bg == "learned" and spec.mask_branch_relu
                     and spec.fc7 and spec.self_attn == "window"
                     and spec.channel_attn and spec.spatial_attn)
        if not supported:
            raise NotImplementedError(f"Head spec '{spec.name}' is "
                                      + _NOT_PORTED)
        self.spec = spec
        self.focal_p = focal_p
        self.focal_lambda = focal_lambda
        self.dtype = dtype
        bb = get_backbone(backbone)
        for name, child in bb.named_children():
            self.add_module(name, child)
        # not registered as a submodule: its layers are ours already
        self.__dict__["_backbone"] = bb
        dim = spec.sa_dim or sa_dim
        self.fc7 = nn.Conv2d(bb.fan_out(), dim, 1, bias=False)
        self.selfattn = WindowAttention(dim, 8, int(spec.self_attn_ws))
        self.caatention = ChannelAttention(dim)
        self.attention = SpatialAttention()
        self.fc8 = nn.Conv2d(dim, num_classes, 1, bias=False)

    def forward(self, image: torch.Tensor) -> ModelOutput:
        """Test-mode forward of ImageNet-normalised NHWC ``image``."""
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        d = self._backbone(x.contiguous(memory_format=torch.channels_last))
        x = self.fc7(d["conv6"]).permute(0, 2, 3, 1)          # NHWC

        ws = int(self.spec.self_attn_ws)
        xp, (h, w) = pad_to_multiple(x, ws, ws)
        x = self.selfattn(xp)[:, :h, :w, :]

        x = x * self.caatention(x)
        sw, _ = self.attention(x)
        x = x * sw

        x = self.fc8(x.permute(0, 3, 1, 2))
        logits = F.relu(x).permute(0, 2, 3, 1).float()
        masks = torch.softmax(logits, dim=-1)
        cls = ngwp_focal_scores(logits, masks, self.focal_p,
                                self.focal_lambda)
        return ModelOutput(cls=cls, masks=rescale_as(masks, image))


def get_model(net_cfg, num_classes: int = 21) -> StageNet:
    """Build a StageNet from a cfg.NET-style AttrDict; NET.DTYPE picks
    the compute dtype ("float32" or "bfloat16")."""
    name = str(net_cfg.MODEL)
    if name not in MODEL_SPECS:
        raise NotImplementedError(f"Model '{name}' is " + _NOT_PORTED)
    dstr = str(getattr(net_cfg, "DTYPE", "float32"))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if dstr not in dtypes:
        raise NotImplementedError(
            f"NET.DTYPE '{dstr}' is not ported yet (ROADMAP.md queue A, "
            "'Low-precision inference')")
    model = StageNet(MODEL_SPECS[name], backbone=str(net_cfg.BACKBONE),
                     num_classes=num_classes,
                     focal_p=float(net_cfg.FOCAL_P),
                     focal_lambda=float(net_cfg.FOCAL_LAMBDA),
                     dtype=dtypes[dstr])
    model = model.to(dtype=dtypes[dstr], memory_format=torch.channels_last)
    return model.eval()
