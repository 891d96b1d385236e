from wseg_tpu_torch.models.backbones.common import (  # noqa: F401
    FrozenBatchNorm,
    conv,
)
from wseg_tpu_torch.models.backbones.resnet38 import ResNet38  # noqa: F401


def get_backbone(name: str):
    """Backbone factory keyed by the reference cfg.NET.BACKBONE strings."""
    if name == "resnet38":
        return ResNet38()
    raise NotImplementedError(
        f"Backbone '{name}' is not ported yet (ROADMAP.md queue A, "
        "'Rest of the model zoo')")
