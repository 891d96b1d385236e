from wseg_tpu_torch.models.backbones.common import (  # noqa: F401
    AffineNorm,
    BatchNorm,
    FrozenBatchNorm,
    QuantConv,
    conv,
)
from wseg_tpu_torch.models.backbones.resnet import (  # noqa: F401
    ResNet,
    ResNet50,
    ResNet101,
)
from wseg_tpu_torch.models.backbones.resnet38 import ResNet38  # noqa: F401
from wseg_tpu_torch.models.backbones.vgg16 import VGG16  # noqa: F401

_BACKBONES = {"resnet38": ResNet38, "resnet50": ResNet50,
              "resnet101": ResNet101, "vgg16": VGG16}


def get_backbone(name: str, quant=None):
    """Backbone factory keyed by the reference cfg.NET.BACKBONE strings;
    ``quant`` (``common.INT8`` / ``INT8_STATIC``) builds its convs as
    ``QuantConv``s and keeps every tensor of it float32 through a cast
    of the model (the int8 mode rounds activations, not weights, as
    JAX's float32 params)."""
    if name not in _BACKBONES:
        raise NotImplementedError(f"No backbone found for '{name}'")
    bb = _BACKBONES[name](quant=quant)
    if quant is not None:
        for m in bb.modules():
            if isinstance(m, FrozenBatchNorm):
                m.keep_dtype = True
    return bb
