"""Class-activation-map toolbox (mirror of
``wseg_tpu/gradcam/cam_methods.py``).

Replaces the reference's vendored pytorch_grad_cam package
(pytorch_grad_cam/base_cam.py:9-216 and per-method files).  The target
layer is a backbone tap (``conv6``, the backbone output, by default,
as the reference's ``target_layers=[model.cls_branch[-1]]`` in
infer_cam.py:104): ``StageNet.backbone_taps`` gives the activations
(NHWC) and ``StageNet.forward(image, taps=...)`` runs the head on a tap
that requires grad, so ``torch.autograd.grad`` gives dY/dA without
hooks.  The model is used as it is given (a serving model from
``get_model`` is in ``.eval()``).

Every method maps (activations A (B, h, w, K), gradients dY/dA) to
weights, then CAM = scale(relu(sum_k w_k A_k)) resized to the input
(align_corners=False), in float32 over the model's output.  ScoreCAM
and AblationCAM are gradient-free re-scoring methods run as batched
forwards of ``CHANNEL_BATCH`` channels.  Engines take a (B, H, W, 3)
ImageNet-normalised image (numpy or tensor) and return numpy maps, as
``wseg_tpu``'s do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wseg_tpu_torch.ops.activations import guided_mode
from wseg_tpu_torch.ops.resize import resize_bilinear

# channels re-scored (ScoreCAM) or ablated (AblationCAM) a forward
CHANNEL_BATCH = 16


def _scale_cam(cam: torch.Tensor) -> torch.Tensor:
    """Min-max normalise each (B, H, W) map to [0, 1]
    (base_cam.py scale_cam_image)."""
    cam = cam - cam.amin(dim=(1, 2), keepdim=True)
    return cam / (1e-7 + cam.amax(dim=(1, 2), keepdim=True))


def _upsample(cam: torch.Tensor, size) -> torch.Tensor:
    """relu, then (B, h, w) -> (B, H, W) bilinear (align_corners=False)."""
    cam = torch.relu(cam)
    return resize_bilinear(cam[..., None], size, align_corners=False)[..., 0]


def _svd_projection(acts: torch.Tensor) -> torch.Tensor:
    """Projection of the centred (hw, K) activations on their first
    right-singular vector (reference utils/svd_on_activations.py:4-19).
    The vector's sign is LAPACK's choice, as in ``wseg_tpu``."""
    b, h, w, k = acts.shape
    flat = acts.reshape(b, h * w, k)
    flat = flat - flat.mean(dim=1, keepdim=True)
    _, _, vt = torch.linalg.svd(flat, full_matrices=False)
    proj = torch.einsum("bnk,bk->bn", flat, vt[:, 0, :])
    return proj.reshape(b, h, w)


def _is_int8(model) -> bool:
    """Whether ``model``'s backbone runs the int8 serving mode."""
    return str(getattr(model, "backbone_dtype", "")).startswith("int8")


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _as_image(model, image) -> torch.Tensor:
    """(B, H, W, 3) float32 on the model's device."""
    return torch.as_tensor(np.asarray(image, np.float32)
                           if not torch.is_tensor(image) else image,
                           dtype=torch.float32, device=_device(model))


class BaseCAM:
    """CAM engine over a StageNet.

    Args:
      model: StageNet (the engines leave its mode as it is).
      tap: the backbone tap (or taps) treated as the target layer;
        several are aggregated as the mean of the per-tap scaled CAMs
        (reference base_cam.py:129-137 aggregate_multi_layers).
    """

    uses_gradients = True

    def __init__(self, model, tap="conv6"):
        if self.uses_gradients and _is_int8(model):
            # round() in the quantized convs has zero gradient: every
            # gradient-based CAM would silently return zeros (the
            # forward-only engines, Score/Ablation/Eigen, run in int8)
            raise ValueError(
                "gradient-based CAM engines need a differentiable "
                "model; NET.DTYPE 'int8' is inference-only -- use "
                "'bfloat16' for this method")
        self.model = model
        self.taps = (tap,) if isinstance(tap, str) else tuple(tap)
        self.tap = self.taps[0]

    # ---- per-method weighting rule
    def get_cam_weights(self, acts, grads, cls, target):
        raise NotImplementedError

    def _taps(self, image):
        with torch.no_grad():
            return self.model.backbone_taps(image)

    def _acts_grads(self, image, target: int, tap: Optional[str] = None):
        """(A, dY/dA, cls) of tap ``tap`` for class ``target``, A and
        dY/dA in float32."""
        tap = tap or self.tap
        taps = self._taps(image)
        acts = taps[tap].detach().requires_grad_(True)
        with torch.enable_grad():
            cls = self.model(image, taps={**taps, tap: acts}).cls
            grads, = torch.autograd.grad(cls[:, target].sum(), acts)
        return acts.detach().float(), grads.float(), cls.detach().float()

    def _cam_one_tap(self, image, target: int, tap: str,
                     eigen_smooth: bool) -> torch.Tensor:
        acts, grads, cls = self._acts_grads(image, target, tap)
        w = self.get_cam_weights(acts, grads, cls, target)
        weighted = acts * w[:, None, None, :]
        cam = _svd_projection(weighted) if eigen_smooth \
            else weighted.sum(dim=-1)
        return _scale_cam(_upsample(cam, image.shape[1:3]))

    def __call__(self, image, target_category: int,
                 eigen_smooth: bool = False) -> np.ndarray:
        """(B, H, W) CAM in [0, 1] at input resolution; with several
        taps, the mean of the per-tap scaled CAMs, scaled."""
        image = _as_image(self.model, image)
        t = int(target_category)
        cams = [self._cam_one_tap(image, t, tap, eigen_smooth)
                for tap in self.taps]
        return _scale_cam(sum(cams) / len(cams)).cpu().numpy()


class GradCAM(BaseCAM):
    """weights = mean gradient over H, W (grad_cam.py:5-22)."""

    def get_cam_weights(self, acts, grads, cls, target):
        return grads.mean(dim=(1, 2))


class GradCAMPlusPlus(BaseCAM):
    """alpha-weighted positive gradients (grad_cam_plusplus.py:7-32)."""

    def get_cam_weights(self, acts, grads, cls, target):
        g2 = grads * grads
        g3 = g2 * grads
        sum_a = acts.sum(dim=(1, 2))[:, None, None, :]
        alpha = torch.where(grads != 0.0, g2 / (2.0 * g2 + sum_a * g3 + 1e-7),
                            torch.zeros_like(grads))
        return (alpha * torch.relu(grads)).sum(dim=(1, 2))


class XGradCAM(BaseCAM):
    """grads * acts / sum(acts) (xgrad_cam.py:5-31)."""

    def get_cam_weights(self, acts, grads, cls, target):
        return (grads * acts).sum(dim=(1, 2)) / (acts.sum(dim=(1, 2)) + 1e-7)


class LayerCAM(BaseCAM):
    """Per-pixel relu(grad) * act, no pooling (layer_cam.py:8-36)."""

    def __call__(self, image, target_category, eigen_smooth=False):
        image = _as_image(self.model, image)
        acts, grads, _ = self._acts_grads(image, int(target_category))
        spatial = torch.relu(grads) * acts
        cam = _svd_projection(spatial) if eigen_smooth \
            else spatial.sum(dim=-1)
        return _scale_cam(_upsample(cam, image.shape[1:3])).cpu().numpy()


class EigenCAM(BaseCAM):
    """SVD projection of the raw activations (eigen_cam.py:7-20)."""

    uses_gradients = False

    def __call__(self, image, target_category, eigen_smooth=False):
        image = _as_image(self.model, image)
        cam = _svd_projection(self._taps(image)[self.tap].float())
        return _scale_cam(_upsample(cam, image.shape[1:3])).cpu().numpy()


class EigenGradCAM(BaseCAM):
    """SVD projection of grad * act (eigen_grad_cam.py:10-21)."""

    def __call__(self, image, target_category, eigen_smooth=False):
        image = _as_image(self.model, image)
        acts, grads, _ = self._acts_grads(image, int(target_category))
        cam = _svd_projection(grads * acts)
        return _scale_cam(_upsample(cam, image.shape[1:3])).cpu().numpy()


class ScoreCAM(BaseCAM):
    """Gradient-free: re-score the input masked by each channel's
    normalised activation; softmax over the channel scores = weights
    (score_cam.py:6-61).  ``CHANNEL_BATCH`` channels a forward."""

    uses_gradients = False

    @torch.no_grad()
    def __call__(self, image, target_category, eigen_smooth=False):
        image = _as_image(self.model, image)
        if image.shape[0] != 1:
            raise ValueError("ScoreCAM runs per image")
        size = image.shape[1:3]
        acts = self._taps(image)[self.tap].float()          # (1, h, w, K)
        ups = resize_bilinear(acts, size, align_corners=False)
        mn = ups.amin(dim=(1, 2), keepdim=True)
        mx = ups.amax(dim=(1, 2), keepdim=True)
        ups_n = (ups - mn) / (1e-8 + mx - mn)
        t = int(target_category)
        scores = []
        for s in range(0, acts.shape[-1], CHANNEL_BATCH):
            chunk = ups_n[0, :, :, s:s + CHANNEL_BATCH]     # (H, W, k)
            masked = image[0][None] * chunk.permute(2, 0, 1)[..., None]
            scores.append(self.model(masked).cls[:, t].float())
        w = torch.softmax(torch.cat(scores), dim=0)[None]
        cam = (acts * w[:, None, None, :]).sum(dim=-1)
        return _scale_cam(_upsample(cam, size)).cpu().numpy()


class AblationCAM(BaseCAM):
    """Gradient-free: weight_k = (score - score with channel k zeroed) /
    score (ablation_cam.py:8-105), ``CHANNEL_BATCH`` channels ablated a
    forward; every channel is ablated (the reference's
    ``ratio_channels_to_ablate`` below 1 samples a subset; ``wseg_tpu``
    ignores it too)."""

    uses_gradients = False

    @torch.no_grad()
    def __call__(self, image, target_category, eigen_smooth=False):
        image = _as_image(self.model, image)
        if image.shape[0] != 1:
            raise ValueError("AblationCAM runs per image")
        t = int(target_category)
        taps = self._taps(image)
        tap_dtype = taps[self.tap].dtype
        acts = taps[self.tap].float()
        k_all = acts.shape[-1]
        base = self.model(image, taps=taps).cls[0, t].float()
        drops = []
        for s in range(0, k_all, CHANNEL_BATCH):
            k = min(CHANNEL_BATCH, k_all - s)
            keep = 1.0 - torch.nn.functional.one_hot(
                torch.arange(s, s + k, device=acts.device), k_all).float()
            rep = (acts.expand(k, -1, -1, -1)
                   * keep[:, None, None, :]).to(tap_dtype)
            taps_rep = {n: v.expand(k, *v.shape[1:])
                        for n, v in taps.items()}
            taps_rep[self.tap] = rep
            cls = self.model(image.expand(k, -1, -1, -1), taps=taps_rep).cls
            drops.append(cls[:, t].float())
        w = ((base - torch.cat(drops)) / (base + 1e-8))[None]
        cam = (acts * w[:, None, None, :]).sum(dim=-1)
        return _scale_cam(_upsample(cam, image.shape[1:3])).cpu().numpy()


class GuidedBackprop:
    """Guided backpropagation: the gradient of the target score with
    respect to the input image through guided ReLUs (reference
    pytorch_grad_cam/guided_backprop.py:7-100).  Returns the raw (B, H,
    W, 3) gradient image (not scaled; the caller deprocesses it)."""

    def __init__(self, model):
        if _is_int8(model):
            # same guard as the gradient-based engines
            raise ValueError(
                "GuidedBackprop needs a differentiable model; "
                "NET.DTYPE 'int8' is inference-only -- use 'bfloat16'")
        self.model = model

    def __call__(self, image, target_category: int,
                 eigen_smooth: bool = False) -> np.ndarray:
        x = _as_image(self.model, image).requires_grad_(True)
        with guided_mode(), torch.enable_grad():
            cls = self.model(x).cls
            g, = torch.autograd.grad(cls[:, int(target_category)].sum(), x)
        return g.float().cpu().numpy()


def aug_smooth(cam_callable, image, target_category: int,
               eigen_smooth: bool = False) -> np.ndarray:
    """Test-time-augmentation smoothing: the mean CAM over horizontal
    flips and intensity multipliers 0.9, 1.0, 1.1 (reference
    base_cam.py:161-188 via ttach)."""
    image = np.asarray(image)
    acc, n = None, 0
    for flip in (False, True):
        for mult in (0.9, 1.0, 1.1):
            x = image * mult
            if flip:
                x = x[:, :, ::-1]
            m = cam_callable(np.ascontiguousarray(x), target_category,
                             eigen_smooth=eigen_smooth)
            if flip:
                m = m[:, :, ::-1]
            acc = m if acc is None else acc + m
            n += 1
    return acc / n
