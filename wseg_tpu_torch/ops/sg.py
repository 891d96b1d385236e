"""Stochastic Gate: stochastic deep/shallow feature mixing.

Mirror of ``wseg_tpu/ops/sg.py`` (reference models/mods/sg.py).  Train
mode draws a per-element Bernoulli(1 - psi) gate from an explicit
``torch.Generator`` that selects the bias-corrected deep branch
``(x1 - psi x2) / (1 - psi)`` or the shallow branch ``x2`` (so the
expectation is ``x1``); eval mode is the blend ``(1 - psi) x1 + psi x2``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def stochastic_gate(x1: torch.Tensor, x2: torch.Tensor, psi: float = 0.3, *,
                    train: bool,
                    generator: Optional[torch.Generator] = None):
    """Merge deep features ``x1`` with shallow features ``x2``."""
    if not train:
        return (1.0 - psi) * x1 + psi * x2
    gate = (torch.rand(x1.shape, device=x1.device, generator=generator)
            < 1.0 - psi).to(x1.dtype)
    x1_corr = (x1 - psi * x2) / max(1e-8, 1.0 - psi)
    return gate * x1_corr + (1.0 - gate) * x2


class StochasticGate(nn.Module):
    """``stochastic_gate`` as a module: train mode follows
    ``.train()``/``.eval()``, and the gate draws from ``.generator`` (on
    the activations' device; torch's default generator without one)."""

    generator = None

    def __init__(self, psi: float = 0.3):
        super().__init__()
        self.psi = float(psi)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return stochastic_gate(x1, x2, self.psi, train=self.training,
                               generator=self.generator)
