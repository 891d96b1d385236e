"""FullGrad: the input gradient plus every bias layer's gradient
(mirror of ``wseg_tpu/gradcam/fullgrad.py``).

Reference pytorch_grad_cam/fullgrad_cam.py:10-106 hooks every layer with
a bias and aggregates psi(bias * dY/d(layer output)) with the
input-gradient term, psi = abs + per-map min-max scaling.  Here a
forward hook adds a zero perturbation that requires grad to the output
of every bias site, so one ``torch.autograd.grad`` gives the input's
gradient and each site's output gradient.  The sites are ``wseg_tpu``'s:
every ``FrozenBatchNorm`` and every conv with a bias whose output is
4-D, each with its raw ``bias`` parameter (a frozen BN's beta, not its
folded shift).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from wseg_tpu_torch.gradcam.cam_methods import _as_image
from wseg_tpu_torch.models.backbones.common import FrozenBatchNorm
from wseg_tpu_torch.ops.resize import resize_bilinear


def bias_sites(model: nn.Module) -> List[nn.Module]:
    """The modules whose 4-D outputs are FullGrad's sites."""
    return [m for m in model.modules()
            if isinstance(m, FrozenBatchNorm)
            or (isinstance(m, nn.Conv2d) and m.bias is not None)]


def _scale_map(x: torch.Tensor, dims) -> torch.Tensor:
    """psi: abs, then min-max to [0, 1] per map over ``dims``."""
    x = x.abs()
    mn = x.amin(dim=dims, keepdim=True)
    mx = x.amax(dim=dims, keepdim=True)
    return (x - mn) / (1e-7 + mx - mn)


class FullGrad:
    def __init__(self, model):
        self.model = model

    def site_gradients(self, image: torch.Tensor, target: int):
        """(input gradient, [(site module, NCHW output gradient)]) of the
        target score, sites in the order the forward reaches them."""
        found: List[Tuple[nn.Module, torch.Tensor]] = []

        def hook(module, inputs, out):
            if out.dim() != 4:
                return None
            p = torch.zeros(out.shape, dtype=torch.float32,
                            device=out.device, requires_grad=True)
            found.append((module, p))
            return out + p.to(out.dtype)

        x = image.detach().clone().requires_grad_(True)
        handles = [m.register_forward_hook(hook)
                   for m in bias_sites(self.model)]
        try:
            with torch.enable_grad():
                cls = self.model(x).cls
                grads = torch.autograd.grad(
                    cls[:, target].sum(), [x] + [p for _, p in found])
        finally:
            for h in handles:
                h.remove()
        return grads[0], [(m, g) for (m, _), g in zip(found, grads[1:])]

    def __call__(self, image, target_category: int,
                 eigen_smooth: bool = False) -> np.ndarray:
        image = _as_image(self.model, image)
        g_img, sites = self.site_gradients(image, int(target_category))
        size = image.shape[1:3]
        cam = _scale_map(g_img.float() * image, (1, 2)).sum(dim=-1)
        for module, g in sites:
            bias = module.bias.detach().float()[None, :, None, None]
            m = _scale_map(g.float() * bias, (2, 3)).sum(dim=1)
            cam = cam + resize_bilinear(m[..., None], size,
                                        align_corners=False)[..., 0]
        mn = cam.amin(dim=(1, 2), keepdim=True)
        mx = cam.amax(dim=(1, 2), keepdim=True)
        return ((cam - mn) / (1e-7 + mx - mn)).cpu().numpy()
