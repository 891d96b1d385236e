from wseg_tpu_torch.models.stage_net import (  # noqa: F401
    MODEL_SPECS,
    HeadSpec,
    ModelOutput,
    StageNet,
    get_model,
)
from wseg_tpu_torch.models.backbones import get_backbone  # noqa: F401
