"""StageNet: backbone + spec-driven head.

Mirror of ``wseg_tpu/models/stage_net.py`` for two specs:

* the flagship ``CAM_CASA_WGAP_tf`` (on WRN38): fc7 1x1 -> window
  self-attention -> channel and spatial attention -> fc8 + relu ->
  softmax with a learned background -> nGWP + focal scores;
* the paper's SoftMaxAE ``ae`` (on ResNet-50/101 and VGG16): the
  ``SoftMaxAEDecoder`` at the backbone's conv3 resolution, a constant-one
  background logit prepended, softmax -> nGWP + focal scores.

Public layout is NHWC.  ``forward(image (B, H, W, 3))`` (test mode)
returns a ``ModelOutput`` with ``cls`` (B, C-1) and ``masks``
(B, H, W, C).  With ``labels`` (B, C-1) and the [0, 1] ``image_raw``
(train path) it also returns ``cls_fg``, the cleaned masks at image
size, ``masks_dec`` (PAMR of the detached masks -- cleaned first for the
flagship -- then rescaled and cleaned) and ``mask_logits`` (feature
resolution, float32).  Dropout, the stochastic gate and the decoder's
live BatchNorms follow ``.train()``/``.eval()``.

The backbone's and the decoder's layers are registered on the model
itself, as in the reference (whose model classes subclass the
backbone), so state_dict keys read ``conv1a.weight``,
``b2.bn_branch2a.running_mean``, ..., ``fc7.weight``,
``selfattn.qkv.weight`` (flagship) or ``layer1.0.conv1.weight``,
``aspp.aspp1.atrous_conv.weight``, ``last_conv.8.bias`` (ae).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

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
from wseg_tpu_torch.models.heads.softmax_ae import SoftMaxAEDecoder
from wseg_tpu_torch.ops.pamr import pamr
from wseg_tpu_torch.ops.pooling import ngwp_focal_scores
from wseg_tpu_torch.ops.resize import rescale_as, resize_bilinear

_NOT_PORTED = ("not ported yet (ROADMAP.md queue A, A5(b)/(c), 'Rest of "
               "the model zoo')")
# the backbones each head kind is ported and tested on
_BACKBONES = {"cam": ("resnet38",), "ae": ("resnet50", "resnet101", "vgg16")}


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Static architecture switches (the subset the ported specs use;
    field names and defaults as ``wseg_tpu``'s HeadSpec)."""
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
    refine: str = ""
    clean_before_refine: bool = False
    loss_at: bool = False


@dataclasses.dataclass
class ModelOutput:
    """Tensors of one forward pass (None fields = not produced)."""
    cls: torch.Tensor
    masks: torch.Tensor
    cls_fg: Optional[torch.Tensor] = None
    masks_dec: Optional[torch.Tensor] = None
    mask_logits: Optional[torch.Tensor] = None
    attn_map: Optional[torch.Tensor] = None


def _clean_only(masks: torch.Tensor, labels_fg: torch.Tensor):
    """Zero the channels of absent classes (background kept)."""
    return torch.cat([masks[..., :1],
                      masks[..., 1:] * labels_fg[:, None, None, :]], dim=-1)


def _rescale_and_clean(masks, size_hw, labels_fg):
    return _clean_only(resize_bilinear(masks, size_hw, align_corners=True),
                       labels_fg)


MODEL_SPECS = {
    # the CVPR-2020 paper model (reference models/SoftMaxAE.py)
    "ae": HeadSpec(name="ae", kind="ae", scoring="softmax", bg="const_one",
                   refine="pamr"),
    "CAM_CASA_WGAP_tf": HeadSpec(
        name="CAM_CASA_WGAP_tf", fc7=True, self_attn="window",
        self_attn_ws=2, channel_attn=True, spatial_attn=True,
        scoring="softmax", bg="learned", mask_branch_relu=True,
        refine="pamr", clean_before_refine=True),
}


class StageNet(nn.Module):
    """Backbone + the flagship or the ``ae`` head.  ``dtype`` is the
    dtype of the input cast; for serving call ``.to(dtype)``
    (``get_model`` does) so the weights match it.  ``amp_dtype``
    (training) keeps the parameters float32 and runs backbone and head
    under ``torch.autocast`` in that dtype, as Flax's ``dtype`` sets the
    compute type only."""

    def __init__(self, spec: HeadSpec, backbone: str = "resnet38",
                 num_classes: int = 21, focal_p: float = 3.0,
                 focal_lambda: float = 0.01, sa_dim: int = 1024,
                 sg_psi: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 amp_dtype: Optional[torch.dtype] = None,
                 pamr_iter: int = 10,
                 pamr_kernel: Sequence[int] = (1, 2, 4, 8, 12, 24),
                 pamr_impl: str = "auto"):
        super().__init__()
        flagship = (spec.kind == "cam" and spec.scoring == "softmax"
                    and spec.bg == "learned" and spec.mask_branch_relu
                    and spec.fc7 and spec.self_attn == "window"
                    and spec.channel_attn and spec.spatial_attn)
        if not (flagship or spec.kind == "ae"):
            raise NotImplementedError(f"Head spec '{spec.name}' is "
                                      + _NOT_PORTED)
        if backbone not in _BACKBONES[spec.kind]:
            raise NotImplementedError(
                f"Head spec '{spec.name}' on backbone '{backbone}' is "
                + _NOT_PORTED)
        self.spec = spec
        self.focal_p = focal_p
        self.focal_lambda = focal_lambda
        self.dtype = dtype
        self.amp_dtype = amp_dtype
        self.pamr_iter = int(pamr_iter)
        self.pamr_kernel = tuple(int(d) for d in pamr_kernel)
        self.pamr_impl = pamr_impl
        bb = get_backbone(backbone)
        for name, child in bb.named_children():
            self.add_module(name, child)
        # not registered as a submodule: its layers are ours already
        self.__dict__["_backbone"] = bb
        if spec.kind == "ae":
            dec = SoftMaxAEDecoder(num_classes, bb.fan_out(), sg_psi=sg_psi)
            for name, child in dec.named_children():
                self.add_module(name, child)
            self.__dict__["_decoder"] = dec
            return
        dim = spec.sa_dim or sa_dim
        self.fc7 = nn.Conv2d(bb.fan_out(), dim, 1, bias=False)
        self.selfattn = WindowAttention(dim, 8, int(spec.self_attn_ws))
        self.caatention = ChannelAttention(dim)
        self.attention = SpatialAttention()
        self.fc8 = nn.Conv2d(dim, num_classes, 1, bias=False)

    def _features(self, image: torch.Tensor):
        """Backbone + head up to the logits (B, h, w, C) float32 (fc8's,
        or the decoder's with the constant background) and the
        spatial-attention map (B, h * w; None for ``ae``)."""
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        d = self._backbone(x.contiguous(memory_format=torch.channels_last))
        if self.spec.kind == "ae":
            fg = self._decoder(d["conv3"], d["conv6"]).permute(0, 2, 3, 1)
            fg = fg.float()
            return torch.cat([torch.ones_like(fg[..., :1]), fg], dim=-1), None
        x = self.fc7(d["conv6"]).permute(0, 2, 3, 1)          # NHWC

        ws = int(self.spec.self_attn_ws)
        xp, (h, w) = pad_to_multiple(x, ws, ws)
        x = self.selfattn(xp)[:, :h, :w, :]

        x = x * self.caatention(x)
        sw, attn_map = self.attention(x)
        x = x * sw

        x = self.fc8(x.permute(0, 3, 1, 2))
        return F.relu(x).permute(0, 2, 3, 1).float(), attn_map

    def forward(self, image: torch.Tensor,
                image_raw: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None) -> ModelOutput:
        """Forward of ImageNet-normalised NHWC ``image``; test mode when
        ``labels`` is None, else the train path (``image_raw`` is the
        [0, 1] RGB guide of PAMR)."""
        amp = self.amp_dtype is not None
        with torch.autocast(image.device.type, enabled=amp,
                            dtype=self.amp_dtype if amp else torch.bfloat16):
            logits, attn_map = self._features(image)
        masks = torch.softmax(logits, dim=-1)
        cls = ngwp_focal_scores(logits, masks, self.focal_p,
                                self.focal_lambda)
        if labels is None:
            return ModelOutput(cls=cls, masks=rescale_as(masks, image))

        spec = self.spec
        labels_fg = labels.float()
        cls_fg = (masks[..., 1:].mean(dim=(1, 2)) * labels_fg).sum(-1) / \
            labels_fg.sum(-1)
        size_hw = (image.shape[1], image.shape[2])
        masks_dec = None
        if spec.refine == "pamr":
            src = _clean_only(masks, labels_fg) \
                if spec.clean_before_refine else masks
            with torch.profiler.record_function("train.pamr"):
                masks_dec = pamr(image_raw, src.detach(), self.pamr_kernel,
                                 self.pamr_iter, self.pamr_impl)
            masks_dec = _rescale_and_clean(masks_dec, size_hw, labels_fg)
        return ModelOutput(
            cls=cls, cls_fg=cls_fg,
            masks=_rescale_and_clean(masks, size_hw, labels_fg),
            masks_dec=masks_dec, mask_logits=logits,
            attn_map=attn_map if spec.loss_at else None)


def get_model(net_cfg, num_classes: int = 21,
              train: bool = False) -> StageNet:
    """Build a StageNet from a cfg.NET-style AttrDict; NET.DTYPE picks
    the compute dtype ("float32" or "bfloat16").

    Serving (``train=False``): weights cast to that dtype, ``.eval()``.
    Training: float32 weights, autocast to that dtype, ``.train()``."""
    name = str(net_cfg.MODEL)
    if name not in MODEL_SPECS:
        raise NotImplementedError(f"Model '{name}' is " + _NOT_PORTED)
    dstr = str(getattr(net_cfg, "DTYPE", "float32"))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if dstr not in dtypes:
        raise NotImplementedError(
            f"NET.DTYPE '{dstr}' is not ported yet (ROADMAP.md queue A, "
            "'Low-precision inference')")
    dtype = dtypes[dstr]
    model = StageNet(MODEL_SPECS[name], backbone=str(net_cfg.BACKBONE),
                     num_classes=num_classes,
                     focal_p=float(net_cfg.FOCAL_P),
                     focal_lambda=float(net_cfg.FOCAL_LAMBDA),
                     sg_psi=float(net_cfg.SG_PSI),
                     dtype=torch.float32 if train else dtype,
                     amp_dtype=dtype if train and dtype != torch.float32
                     else None,
                     pamr_iter=int(net_cfg.PAMR_ITER),
                     pamr_kernel=tuple(net_cfg.PAMR_KERNEL),
                     pamr_impl=str(getattr(net_cfg, "PAMR_IMPL", "auto")))
    if train:
        return model.to(memory_format=torch.channels_last).train()
    model = model.to(dtype=dtype, memory_format=torch.channels_last)
    return model.eval()
