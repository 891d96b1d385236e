"""Grad-CAM engines of the port (mirror of ``wseg_tpu/gradcam``)."""

from wseg_tpu_torch.gradcam.cam_methods import (
    AblationCAM,
    BaseCAM,
    EigenCAM,
    EigenGradCAM,
    GradCAM,
    GradCAMPlusPlus,
    GuidedBackprop,
    LayerCAM,
    ScoreCAM,
    XGradCAM,
    aug_smooth,
)
from wseg_tpu_torch.gradcam.fullgrad import FullGrad

__all__ = ["AblationCAM", "BaseCAM", "CAM_METHODS", "EigenCAM",
           "EigenGradCAM", "FullGrad", "GradCAM", "GradCAMPlusPlus",
           "GuidedBackprop", "LayerCAM", "ScoreCAM", "XGradCAM",
           "aug_smooth", "get_cam_method"]

CAM_METHODS = {
    "gradcam": GradCAM,
    "gradcam++": GradCAMPlusPlus,
    "xgradcam": XGradCAM,
    "layercam": LayerCAM,
    "eigencam": EigenCAM,
    "eigengradcam": EigenGradCAM,
    "scorecam": ScoreCAM,
    "ablationcam": AblationCAM,
    "fullgrad": FullGrad,
    "guidedbackprop": GuidedBackprop,
}


def get_cam_method(name: str):
    if name not in CAM_METHODS:
        raise NotImplementedError(
            f"CAM method '{name}' (have: {sorted(CAM_METHODS)})")
    return CAM_METHODS[name]
