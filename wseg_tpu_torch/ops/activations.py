"""ReLU with a guided-backprop mode.

Mirror of ``wseg_tpu/ops/activations.py``.  Guided backpropagation
(reference pytorch_grad_cam/guided_backprop.py:7-100) replaces the ReLU
backward so that only positive gradients flow through positive
activations.  Every model ReLU that ``wseg_tpu`` routes through its
``relu`` goes through :func:`relu` (or the :class:`ReLU` module) here;
inside :func:`guided_mode` those take the guided backward, outside it
they are ``F.relu`` itself (no extra autograd node).  The mode is a
context variable, so a guided pass in one thread leaves a model served
by another thread alone.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

_GUIDED = contextvars.ContextVar("wseg_guided_relu", default=False)


class GuidedReLU(torch.autograd.Function):
    """max(x, 0) whose backward passes g where x > 0 and g > 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp_min(0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g))


def relu(x: torch.Tensor) -> torch.Tensor:
    """``F.relu``, or the guided ReLU inside :func:`guided_mode`."""
    if _GUIDED.get():
        return GuidedReLU.apply(x)
    return F.relu(x)


class ReLU(nn.Module):
    """:func:`relu` as a module (``nn.Sequential`` members)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(x)


@contextmanager
def guided_mode():
    """Run model code under this to get guided-backprop gradients."""
    token = _GUIDED.set(True)
    try:
        yield
    finally:
        _GUIDED.reset(token)
