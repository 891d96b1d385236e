"""StageNet: backbone + spec-driven head.

Mirror of ``wseg_tpu/models/stage_net.py``: one module driven by a
``HeadSpec`` and a registry mapping ``cfg.NET.MODEL`` strings to specs.
Ported: the paper's SoftMaxAE ``ae`` and every CAM head but
``CAM_CASA_WGAP_tf_v3``-``tf_v10`` (ROADMAP.md A5(c)), on any of the
four backbones where the head's taps exist:

* classic CAM scoring (``bsl``, ``CAM_SA``/``CAM_CASA`` [``_WGAP``],
  ``CAM_MF_v2``): a shared ``fc8`` scores the pooled features (GAP, or
  WGAP weighted by the spatial-attention map) and the pixel map, whose
  ReLU'd, max-normalised image-size masks get a constant ``bg_score``
  background;
* multi-level CAM (``CAM_MF``): per-level ``fc8_6`` ... ``fc8_3``;
* nGWP softmax scoring (``v2``-``v6``, ``CAM_WGAP_v3``, PCM, ``tf``,
  ``tf_v2``, ``ae``): softmax masks with a learned or constant-one
  background, nGWP + focal scores, refined by PAMR or PCM in the train
  path.

Public layout is NHWC.  ``forward(image (B, H, W, 3))`` (test mode)
returns a ``ModelOutput`` with ``cls`` and ``masks`` (B, H, W, C).
With ``labels`` (B, C-1) -- (B, C) for ``labels_with_bg`` -- and the
[0, 1] ``image_raw`` (train path) it also returns ``cls_fg``, the
cleaned masks at image size, ``masks_dec`` (the refined masks, rescaled
and cleaned; None without refinement), ``mask_logits`` (feature
resolution, float32) and ``attn_map`` for the heads with the attention
loss.  Dropout, the stochastic gate and the decoder's live BatchNorms
follow ``.train()``/``.eval()``.  ``backbone_taps(image)`` returns the
backbone's taps (NHWC) and ``forward(..., taps=...)`` takes entries in
their place, for gradients with respect to a tap (the Grad-CAM
engines); the model ReLUs that ``wseg_tpu`` routes through its guided
``relu`` go through ``ops/activations.relu`` here.

The backbone's and the head's layers are registered on the model
itself, as in the reference (whose model classes subclass the
backbone), so state_dict keys are the reference's: ``conv1a.weight``,
``fc7.weight``, ``selfattn.qkv.weight``, ``selfattn.norm.bias``,
``fc8_6.weight``, ``f9.weight``, ``aspp.aspp1.atrous_conv.weight``, ...
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from wseg_tpu_torch.models.backbones import get_backbone
from wseg_tpu_torch.models.backbones.common import (
    INT8,
    INT8_STATIC,
    INT8_TRAIN_ERROR,
    Dropout2d,
)
from wseg_tpu_torch.models.heads.attention import (
    ChannelAttention,
    GlobalSRA,
    SpatialAttention,
    WindowAttention,
    matmul_f32,
    pad_to_multiple,
)
from wseg_tpu_torch.models.heads.softmax_ae import SoftMaxAEDecoder
from wseg_tpu_torch.ops.activations import relu
from wseg_tpu_torch.ops.pamr import pamr
from wseg_tpu_torch.ops.pooling import (
    focal_penalty,
    ngwp_focal_scores,
    ngwp_pool,
)
from wseg_tpu_torch.ops.resize import (
    adaptive_max_pool,
    rescale_as,
    resize_bilinear,
)


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Static architecture switches (the fields the ported specs use;
    names and defaults as ``wseg_tpu``'s HeadSpec)."""
    name: str = ""
    kind: str = "cam"              # "ae" | "cam"
    channel_attn: bool = False
    spatial_attn: bool = False
    self_attn: str = ""            # "" | "window" | "global"
    self_attn_ws: Any = 2
    sr_ratio: int = 1              # for "global"
    fc7: bool = False              # 1x1 conv6 -> sa_dim before attention
    sa_dim: int = 0                # 0 = the model's (1024)
    scoring: str = "cam"           # "cam" | "softmax"
    bg: str = "score"              # "score" | "const_one" | "learned"
    pooling: str = "gap"           # cam scoring: "gap" | "wgap"
    mask_branch_relu: bool = False
    cls_all_channels: bool = False  # v4 keeps the BG score in cls
    labels_with_bg: bool = False    # v4 expects C-dim labels
    multilevel: str = ""           # "" | "sum" | "concat"
    conv3_tap: str = "conv3"
    refine: str = ""               # "" | "pamr" | "pcm"
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


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_nhwc(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv applied to an NHWC tensor."""
    return _nhwc(layer(x.permute(0, 3, 1, 2)))


_CASA = dict(channel_attn=True, spatial_attn=True)
_NGWP = dict(scoring="softmax", bg="learned")
_TF = dict(fc7=True, **_CASA, **_NGWP, mask_branch_relu=True,
           refine="pamr", clean_before_refine=True)

MODEL_SPECS = {
    # the CVPR-2020 paper model (reference models/SoftMaxAE.py)
    "ae": HeadSpec(name="ae", kind="ae", scoring="softmax", bg="const_one",
                   refine="pamr"),
    # classic CAM baseline (models/BaselineCAM.py)
    "bsl": HeadSpec(name="bsl"),
    # CBAM-attention CAM variants (models/CAM_SA.py etc.)
    "CAM_SA": HeadSpec(name="CAM_SA", spatial_attn=True, loss_at=True),
    "CAM_CASA": HeadSpec(name="CAM_CASA", **_CASA, loss_at=True),
    "CAM_SA_WGAP": HeadSpec(name="CAM_SA_WGAP", spatial_attn=True,
                            pooling="wgap", loss_at=True),
    "CAM_CASA_WGAP": HeadSpec(name="CAM_CASA_WGAP", **_CASA,
                              pooling="wgap", loss_at=True),
    # multi-level fusion on the resnet38d_v2 pre-activation conv3 tap
    "CAM_MF": HeadSpec(name="CAM_MF", multilevel="sum",
                       conv3_tap="conv3_pre"),
    "CAM_MF_v2": HeadSpec(name="CAM_MF_v2", multilevel="concat",
                          conv3_tap="conv3_pre"),
    # nGWP-scored attention variants (models/CAM_CASA_WGAP_v2..v6.py)
    "CAM_CASA_WGAP_v2": HeadSpec(name="CAM_CASA_WGAP_v2", **_CASA,
                                 scoring="softmax", bg="const_one",
                                 loss_at=True),
    "CAM_CASA_WGAP_v3": HeadSpec(name="CAM_CASA_WGAP_v3", **_CASA, **_NGWP,
                                 loss_at=True),
    "CAM_WGAP_v3": HeadSpec(name="CAM_WGAP_v3", **_NGWP),
    "CAM_CASA_WGAP_v4": HeadSpec(name="CAM_CASA_WGAP_v4", **_CASA, **_NGWP,
                                 cls_all_channels=True, labels_with_bg=True,
                                 loss_at=True),
    "CAM_CASA_WGAP_v5": HeadSpec(name="CAM_CASA_WGAP_v5", **_CASA, **_NGWP,
                                 refine="pamr"),
    "CAM_CASA_WGAP_v6": HeadSpec(name="CAM_CASA_WGAP_v6", **_CASA, **_NGWP,
                                 mask_branch_relu=True, refine="pamr",
                                 clean_before_refine=True),
    "CAM_CASA_WGAP_PCM": HeadSpec(name="CAM_CASA_WGAP_PCM", **_CASA,
                                  **_NGWP, refine="pcm"),
    # transformer-attention variants (models/CAM_CASA_WGAP_tf*.py)
    "CAM_CASA_WGAP_tf": HeadSpec(name="CAM_CASA_WGAP_tf", **_TF,
                                 self_attn="window", self_attn_ws=2),
    "CAM_CASA_WGAP_tf_v2": HeadSpec(name="CAM_CASA_WGAP_tf_v2", **_TF,
                                    self_attn="global", sr_ratio=3),
}

# registry keys of wseg_tpu that wait for ROADMAP.md C1 (A5(c))
WAITING = tuple(f"CAM_CASA_WGAP_tf_v{v}"
                for v in ("3", "4", "5", "6", "7", "8", "9", "9_2", "10"))


def required_taps(spec: HeadSpec) -> set:
    """The backbone taps the head reads."""
    if spec.kind == "ae":
        return {"conv3", "conv6"}
    taps = {"conv6"}
    if spec.multilevel == "sum":
        taps |= {"conv5", "conv4", spec.conv3_tap}
    elif spec.multilevel == "concat":
        taps |= {"conv4", spec.conv3_tap}
    if spec.refine == "pcm":
        taps |= {"conv4", "conv5"}
    return taps


class StageNet(nn.Module):
    """Backbone + head of ``spec``.  ``dtype`` is the dtype of the input
    cast; for serving call ``.to(dtype)`` (``get_model`` does) so the
    weights match it.  ``amp_dtype`` (training) keeps the parameters
    float32 and runs backbone and head convs under ``torch.autocast`` in
    that dtype, as Flax's ``dtype`` sets the compute type only; the
    attention products, WGAP, PCM's affinity and every resize stay
    float32, as in JAX.  ``quant`` (``INT8`` or ``INT8_STATIC`` of
    ``models/backbones/common.py``) builds every backbone conv as a
    ``QuantConv`` (the int8 serving mode; ``dtype`` bfloat16)."""

    def __init__(self, spec: HeadSpec, backbone: str = "resnet38",
                 num_classes: int = 21, bg_score: float = 0.1,
                 focal_p: float = 3.0, focal_lambda: float = 0.01,
                 sa_dim: int = 1024, sg_psi: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 amp_dtype: Optional[torch.dtype] = None,
                 pamr_iter: int = 10,
                 pamr_kernel: Sequence[int] = (1, 2, 4, 8, 12, 24),
                 pamr_impl: str = "auto",
                 quant: Optional[str] = None):
        super().__init__()
        self.spec = spec
        self.num_classes = num_classes
        self.bg_score = float(bg_score)
        self.focal_p = focal_p
        self.focal_lambda = focal_lambda
        self.dtype = dtype
        self.amp_dtype = amp_dtype
        self.pamr_iter = int(pamr_iter)
        self.pamr_kernel = tuple(int(d) for d in pamr_kernel)
        self.pamr_impl = pamr_impl
        # the backbone convs' quantization (None, "int8", "int8_static");
        # the head stays in ``dtype``
        self.backbone_dtype = quant
        bb = get_backbone(backbone, quant)
        missing = sorted(required_taps(spec) - set(bb.TAPS))
        if missing:
            raise ValueError(
                f"NET.MODEL '{spec.name}' reads the backbone taps "
                f"{missing}, which '{backbone}' does not return (only "
                f"resnet38 does); wseg_tpu's forward fails there too")
        for name, child in bb.named_children():
            self.add_module(name, child)
        # not registered as a submodule: its layers are ours already
        self.__dict__["_backbone"] = bb
        taps = bb.TAPS
        c1 = num_classes - 1
        if spec.kind == "ae":
            dec = SoftMaxAEDecoder(num_classes, taps["conv6"], sg_psi=sg_psi)
            for name, child in dec.named_children():
                self.add_module(name, child)
            self.__dict__["_decoder"] = dec
            return
        if spec.scoring == "cam" or not spec.mask_branch_relu:
            self.dropout2d = Dropout2d(0.5)
        if spec.multilevel == "sum":
            # reference CAM_MF.py:38-41: fc8_6 on conv6 ... fc8_3 on conv3
            for i, tap in self._mf_levels():
                self.add_module(f"fc8_{i}",
                                nn.Conv2d(taps[tap], c1, 1, bias=False))
            return
        dim = taps["conv6"]
        if spec.multilevel == "concat":
            dim += taps[spec.conv3_tap] + taps["conv4"]
        if spec.fc7:
            if "fc7" in self._modules:
                raise ValueError(
                    f"NET.MODEL '{spec.name}' has a head layer 'fc7' and "
                    f"backbone '{backbone}' has a layer of that name; the "
                    "port keeps the reference's flat state_dict names, "
                    "where the two cannot both exist (ROADMAP.md C3)")
            self.fc7 = nn.Conv2d(dim, spec.sa_dim or sa_dim, 1, bias=False)
            dim = spec.sa_dim or sa_dim
        if spec.self_attn == "window":
            self.selfattn = WindowAttention(dim, 8, int(spec.self_attn_ws))
        elif spec.self_attn == "global":
            self.selfattn = GlobalSRA(dim, 8, spec.sr_ratio)
        if spec.channel_attn:
            self.caatention = ChannelAttention(dim)
        if spec.spatial_attn:
            self.attention = SpatialAttention()
        out_ch = num_classes if spec.scoring == "softmax" \
            and spec.bg != "const_one" else c1
        self.fc8 = nn.Conv2d(dim, out_ch, 1, bias=False)
        if spec.refine == "pcm":
            self.f8_3 = nn.Conv2d(taps["conv4"], 64, 1, bias=False)
            self.f8_4 = nn.Conv2d(taps["conv5"], 128, 1, bias=False)
            self.f9 = nn.Conv2d(3 + 64 + 128, 192, 1, bias=False)

    def _mf_levels(self):
        return ((6, "conv6"), (5, "conv5"), (4, "conv4"),
                (3, self.spec.conv3_tap))

    def _autocast(self, device_type: str):
        amp = self.amp_dtype is not None
        return torch.autocast(device_type, enabled=amp,
                              dtype=self.amp_dtype if amp
                              else torch.bfloat16)

    def _taps(self, image: torch.Tensor):
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        return self._backbone(x.contiguous(memory_format=torch.channels_last))

    def _attend(self, d):
        """Head features before scoring (NHWC): [multi-level concat] ->
        [fc7] -> [self-attention] -> [channel, spatial attention]; and
        the spatial-attention softmax map (B, h * w) or None."""
        spec = self.spec
        x = _nhwc(d["conv6"])
        if spec.multilevel == "concat":
            x3 = adaptive_max_pool(_nhwc(d[spec.conv3_tap]), x.shape[1:3])
            x = torch.cat([x3, _nhwc(d["conv4"]), x], dim=-1)
        if spec.fc7:
            x = _conv_nhwc(self.fc7, x)
        if spec.self_attn == "global":
            x = self.selfattn(x)
        elif spec.self_attn == "window":
            ws = int(spec.self_attn_ws)
            xp, (h, w) = pad_to_multiple(x, ws, ws)
            x = self.selfattn(xp)[:, :h, :w, :]
        attn_map = None
        if spec.channel_attn:
            x = x * self.caatention(x)
        if spec.spatial_attn:
            sw, attn_map = self.attention(x)
            x = x * sw
        return x, attn_map

    def _logits(self, d):
        """Softmax-scored heads: the logits (B, h, w, C) float32 (fc8's,
        or the decoder's, with the constant background where the spec
        has one) and the spatial-attention map (None without one)."""
        spec = self.spec
        if spec.kind == "ae":
            fg = _nhwc(self._decoder(d["conv3"], d["conv6"])).float()
            return torch.cat([torch.ones_like(fg[..., :1]), fg], -1), None
        x, attn_map = self._attend(d)
        x = x.permute(0, 3, 1, 2)
        if not spec.mask_branch_relu:
            x = self.dropout2d(x)
        x = self.fc8(x)
        if spec.mask_branch_relu:
            x = relu(x)
        x = _nhwc(x).float()
        if spec.bg == "const_one":
            x = torch.cat([torch.ones_like(x[..., :1]), x], dim=-1)
        return x, attn_map

    def _features(self, image: torch.Tensor):
        """``_logits`` of ``image`` (softmax-scored heads)."""
        return self._logits(self._taps(image))

    def _labels_fg(self, labels: torch.Tensor) -> torch.Tensor:
        want = self.num_classes if self.spec.labels_with_bg \
            else self.num_classes - 1
        if labels.shape[-1] != want:
            raise ValueError(
                f"NET.MODEL '{self.spec.name}' takes (B, {want}) labels"
                + (" with the background first" if self.spec.labels_with_bg
                   else "") + f", got {tuple(labels.shape)} (wseg_tpu's "
                "forward fails on these too; ROADMAP.md C2)")
        return (labels[:, 1:] if self.spec.labels_with_bg
                else labels).float()

    def backbone_taps(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The backbone's taps of NHWC ``image`` as NHWC tensors (the
        Grad-CAM engines' activations; ``wseg_tpu``'s ``backbone_taps``)."""
        with self._autocast(image.device.type):
            return {k: _nhwc(v) for k, v in self._taps(image).items()}

    def forward(self, image: torch.Tensor,
                image_raw: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, *,
                taps: Optional[Dict[str, torch.Tensor]] = None
                ) -> ModelOutput:
        """Forward of ImageNet-normalised NHWC ``image``; test mode when
        ``labels`` is None, else the train path (``image_raw`` is the
        [0, 1] RGB guide of PAMR).  ``taps`` (NHWC, as ``backbone_taps``
        returns them) replace those entries of the backbone's tap dict,
        so a gradient can be taken with respect to one; the backbone is
        not run when they hold every tap the head reads."""
        spec = self.spec
        if taps is not None and required_taps(spec) <= set(taps):
            d = {}
        else:
            with self._autocast(image.device.type):
                d = self._taps(image)
        if taps is not None:
            d.update({k: v.permute(0, 3, 1, 2) for k, v in taps.items()})
        if spec.multilevel == "sum":
            return self._forward_mf(d, image, labels)
        if spec.scoring == "cam":
            return self._score_cam(d, image, labels)
        return self._score_softmax(d, image, image_raw, labels)

    # ------------------------------------------------------- CAM scoring
    def _cam_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """ReLU'd image-size CAMs -> masks: max-normalised, with the
        constant background prepended."""
        z = torch.amax(masks, dim=(1, 2), keepdim=True)
        masks = masks / (1e-5 + z)
        bg = torch.full_like(masks[..., :1], self.bg_score)
        return torch.cat([bg, masks], dim=-1)

    def _cam_output(self, cls, masks, logits, attn_map, labels):
        if labels is None:
            return ModelOutput(cls=cls, masks=masks)
        labels_fg = self._labels_fg(labels)
        cls_fg = (masks[..., 1:].mean(dim=(1, 2)) * labels_fg).sum(-1) / \
            labels_fg.sum(-1)
        return ModelOutput(cls=cls, cls_fg=cls_fg,
                           masks=_clean_only(masks, labels_fg),
                           mask_logits=logits,
                           attn_map=attn_map if self.spec.loss_at else None)

    def _score_cam(self, d, image, labels):
        """Classic CAM: one fc8 for the pooled vector and the pixel map
        (reference models/BaselineCAM.py:61-108)."""
        with self._autocast(image.device.type):
            x, attn_map = self._attend(d)
            if self.spec.pooling == "wgap":
                # weighted GAP: sum over positions of x * the SA softmax
                # map (reference models/CAM_SA_WGAP.py:70-76)
                b, h, w, c = x.shape
                pooled = matmul_f32(attn_map.reshape(b, 1, h * w),
                                    x.reshape(b, h * w, c))
                pooled = self.dropout2d(pooled.to(x.dtype).reshape(
                    b, c, 1, 1))
            else:
                pooled = self.dropout2d(x.permute(0, 3, 1, 2)).mean(
                    dim=(2, 3), keepdim=True)
            cls = self.fc8(pooled).flatten(1).float()
            logits = _conv_nhwc(self.fc8, x)
        size_hw = (image.shape[1], image.shape[2])
        masks = relu(resize_bilinear(logits, size_hw).float())
        return self._cam_output(cls, self._cam_masks(masks),
                                logits.float(), attn_map, labels)

    def _forward_mf(self, d, image, labels):
        """CAM_MF: per-level fc8 heads, summed cls, averaged masks
        (reference models/CAM_MF.py:31-141, including the ``m +=
        relu(m)`` accumulation on levels 3-5)."""
        size_hw = (image.shape[1], image.shape[2])
        cls, lgs = 0.0, []
        with self._autocast(image.device.type):
            for i, tap in self._mf_levels():
                fc8 = getattr(self, f"fc8_{i}")
                pooled = self.dropout2d(d[tap]).mean(dim=(2, 3),
                                                      keepdim=True)
                cls = cls + fc8(pooled).flatten(1).float()
                lgs.append(_nhwc(fc8(d[tap])))
        levels = []
        for k, lg in enumerate(lgs):
            m = resize_bilinear(lg, size_hw).float()
            levels.append(relu(m) if k == 0 else m + relu(m))
        masks = sum(levels) / len(levels)
        return self._cam_output(cls, self._cam_masks(masks),
                                lgs[0].float(), None, labels)

    # --------------------------------------------------- softmax scoring
    def _score_softmax(self, d, image, image_raw, labels):
        """nGWP softmax path (reference models/CAM_CASA_WGAP_v5.py:
        145-200, models/SoftMaxAE.py)."""
        spec = self.spec
        with self._autocast(image.device.type):
            logits, attn_map = self._logits(d)
        masks = torch.softmax(logits, dim=-1)
        if spec.cls_all_channels:
            # v4: nGWP + focal over every channel, the background's too
            cls = ngwp_pool(logits, masks) + focal_penalty(
                masks.mean(dim=(1, 2)), self.focal_p, self.focal_lambda)
        else:
            cls = ngwp_focal_scores(logits, masks, self.focal_p,
                                    self.focal_lambda)
        if labels is None:
            return ModelOutput(cls=cls, masks=rescale_as(masks, image))

        labels_fg = self._labels_fg(labels)
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
        elif spec.refine == "pcm":
            masks_dec = self._pcm_refine(logits, d, image)
        if masks_dec is not None:
            masks_dec = _rescale_and_clean(masks_dec, size_hw, labels_fg)
        return ModelOutput(
            cls=cls, cls_fg=cls_fg,
            masks=_rescale_and_clean(masks, size_hw, labels_fg),
            masks_dec=masks_dec, mask_logits=logits,
            attn_map=attn_map if spec.loss_at else None)

    def _pcm_refine(self, logits, d, image):
        """SEAM-style pixel-correlation module (reference
        models/CAM_CASA_WGAP_PCM.py:185-237): the detached, normalised
        CAM propagated by a float32 cosine affinity (B, hw, hw) of
        features from the image and the detached conv4/conv5 taps."""
        h, w = logits.shape[1], logits.shape[2]
        cam_d = relu(logits.detach())
        cam_max = torch.amax(cam_d, dim=(1, 2), keepdim=True) + 1e-5
        cam_norm = relu(cam_d - 1e-5) / cam_max
        fg = cam_norm[..., 1:]
        fg_max = torch.amax(fg, dim=-1, keepdim=True)
        cam_norm = torch.cat([1.0 - fg_max, torch.where(
            fg < fg_max, torch.zeros_like(fg), fg)], dim=-1)

        with self._autocast(image.device.type):
            f83 = relu(self.f8_3(d["conv4"].detach()))
            f84 = relu(self.f8_4(d["conv5"].detach()))
        f83 = resize_bilinear(_nhwc(f83), (h, w))
        f84 = resize_bilinear(_nhwc(f84), (h, w))
        xs = resize_bilinear(image, (h, w)).to(f83.dtype)
        with self._autocast(image.device.type):
            f = _conv_nhwc(self.f9, torch.cat([xs, f83, f84], dim=-1))
        b = f.shape[0]
        with torch.autocast(image.device.type, enabled=False):
            fv = f.reshape(b, h * w, -1).float()
            fv = fv / (torch.linalg.vector_norm(fv, dim=-1, keepdim=True)
                       + 1e-5)
            aff = relu(torch.bmm(fv, fv.transpose(1, 2)))
            aff = aff / (aff.sum(dim=1, keepdim=True) + 1e-5)
            out = torch.bmm(aff.transpose(1, 2),
                            cam_norm.reshape(b, h * w, -1))
        return out.reshape(b, h, w, -1)


def get_model(net_cfg, num_classes: int = 21,
              train: bool = False) -> StageNet:
    """Build a StageNet from a cfg.NET-style AttrDict; NET.DTYPE picks
    the compute dtype ("float32", "bfloat16", or "int8": w8a8 backbone
    convs, ``QuantConv``, with bfloat16 head math; NET.QUANT_ACT
    "static" takes calibrated per-channel activation scales, which the
    caller loads with ``load_quant_stats``).

    Serving (``train=False``): weights cast to that dtype (an int8
    backbone keeps its float32 tensors), ``.eval()``.  Training:
    float32 weights, autocast to that dtype, ``.train()``; int8 is
    inference-only and raises."""
    name = str(net_cfg.MODEL)
    if name == "vgg16":  # reference default config quirk: MODEL 'vgg16'
        name = "bsl"
    if name in WAITING:
        raise NotImplementedError(
            f"Model '{name}' is not ported yet (ROADMAP.md queue A, A5(c): "
            "tf_v3-tf_v10 wait until C1, the reference-side forward "
            "mismatch of these nine heads, is explained)")
    if name not in MODEL_SPECS:
        raise NotImplementedError(f"Unknown model '{name}'")
    dstr = str(getattr(net_cfg, "DTYPE", "float32"))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.bfloat16}
    if dstr not in dtypes:
        raise NotImplementedError(f"Unknown NET.DTYPE '{dstr}'")
    dtype = dtypes[dstr]
    quant = None
    if dstr == "int8":
        if train:
            raise ValueError(INT8_TRAIN_ERROR)
        static = str(getattr(net_cfg, "QUANT_ACT", "dynamic")) == "static"
        quant = INT8_STATIC if static else INT8
    model = StageNet(MODEL_SPECS[name], backbone=str(net_cfg.BACKBONE),
                     num_classes=num_classes,
                     bg_score=float(net_cfg.BG_SCORE),
                     focal_p=float(net_cfg.FOCAL_P),
                     focal_lambda=float(net_cfg.FOCAL_LAMBDA),
                     sg_psi=float(net_cfg.SG_PSI),
                     dtype=torch.float32 if train else dtype,
                     amp_dtype=dtype if train and dtype != torch.float32
                     else None,
                     pamr_iter=int(net_cfg.PAMR_ITER),
                     pamr_kernel=tuple(net_cfg.PAMR_KERNEL),
                     pamr_impl=str(getattr(net_cfg, "PAMR_IMPL", "auto")),
                     quant=quant)
    if train:
        return model.to(memory_format=torch.channels_last).train()
    model = model.to(dtype=dtype, memory_format=torch.channels_last)
    return model.eval()
