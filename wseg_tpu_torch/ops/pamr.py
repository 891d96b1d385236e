"""PAMR — pixel-adaptive mask refinement, NHWC at the surface.

Mirror of ``wseg_tpu/ops/pamr.py``: the guide image is resized
(align_corners=True bilinear) to the mask's size; per pixel the 8
neighbours at each dilation are compared to the centre with edge
replication; sigma is the per-colour-channel Bessel-corrected std over
the 9 * D taps (centre once per dilation); the affinity is the softmax
over the 8 * D taps of mean_RGB(-|diff| / (1e-8 + 0.1 sigma)); then
``num_iter`` Jacobi steps m <- sum_t aff_t * shift_t(m).

``pamr_affinity``, ``pamr_propagate`` and their composition
``pamr_reference`` are the plain torch versions (any device), the
reference the kernels are held to.  ``pamr`` runs the CUDA kernels of
``ops/pamr_cuda.py`` on a CUDA tensor and the plain versions on a CPU
tensor; it never takes the plain versions on the card.  No gradient
flows: callers pass detached masks.
"""

from __future__ import annotations

from typing import Sequence

import torch

from wseg_tpu_torch.ops.pamr_cuda import (
    pamr_affinity_cm,
    pamr_affinity_cm_reference,
    pamr_propagate_cm,
    pamr_propagate_cm_reference,
)
from wseg_tpu_torch.ops.resize import resize_bilinear

DEFAULT_DILATIONS = (1, 2, 4, 8, 12, 24)


def _cm(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous float32 (B, C, H, W)."""
    return x.float().permute(0, 3, 1, 2).contiguous()


def pamr_affinity(im: torch.Tensor,
                  dilations: Sequence[int] = DEFAULT_DILATIONS):
    """(B, H, W, K) guide at mask resolution -> (B, H, W, 8 * D)
    softmax affinities (plain torch)."""
    return pamr_affinity_cm_reference(_cm(im), dilations).permute(0, 2, 3, 1)


def pamr_propagate(aff: torch.Tensor, mask: torch.Tensor,
                   dilations: Sequence[int] = DEFAULT_DILATIONS,
                   num_iter: int = 10):
    """``num_iter`` Jacobi steps of (B, H, W, C) ``mask`` under
    (B, H, W, 8 * D) ``aff`` (plain torch)."""
    out = pamr_propagate_cm_reference(_cm(aff), _cm(mask), dilations,
                                      num_iter)
    return out.permute(0, 2, 3, 1)


def _guide(im: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(im.float(), (mask.shape[1], mask.shape[2]),
                           align_corners=True)


def pamr_reference(im: torch.Tensor, mask: torch.Tensor,
                   dilations: Sequence[int] = DEFAULT_DILATIONS,
                   num_iter: int = 10):
    """``pamr`` on the plain versions, on any device."""
    return pamr_propagate(pamr_affinity(_guide(im, mask), dilations), mask,
                          dilations, num_iter)


def pamr(im: torch.Tensor, mask: torch.Tensor,
         dilations: Sequence[int] = DEFAULT_DILATIONS, num_iter: int = 10,
         impl: str = "auto"):
    """Affinity from ``im`` (B, H, W, 3), resized to the mask's size,
    then propagation of ``mask`` (B, h, w, C) -> (B, h, w, C) float32.

    ``impl`` takes ``NET.PAMR_IMPL``'s names: "auto" and "pallas" take
    the kernels' wrappers (kernels on a CUDA tensor, plain versions on a
    CPU tensor); "lax" asks for the plain versions, which a CPU tensor
    gets and a CUDA tensor refuses.
    """
    if impl not in ("auto", "pallas", "lax"):
        raise ValueError(f"unknown PAMR impl {impl!r}")
    if impl == "lax":
        if mask.is_cuda:
            raise ValueError("PAMR impl 'lax' (the plain versions) runs on "
                             "CPU tensors only; on the card PAMR takes its "
                             "kernels (impl 'auto')")
        return pamr_reference(im, mask, dilations, num_iter)
    aff = pamr_affinity_cm(_cm(_guide(im, mask)), dilations)
    out = pamr_propagate_cm(aff, _cm(mask), dilations, num_iter)
    return out.permute(0, 2, 3, 1)
