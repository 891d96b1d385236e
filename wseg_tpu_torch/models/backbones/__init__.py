from wseg_tpu_torch.models.backbones.common import (  # noqa: F401
    AffineNorm,
    BatchNorm,
    FrozenBatchNorm,
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


def get_backbone(name: str):
    """Backbone factory keyed by the reference cfg.NET.BACKBONE strings."""
    if name not in _BACKBONES:
        raise NotImplementedError(f"No backbone found for '{name}'")
    return _BACKBONES[name]()
