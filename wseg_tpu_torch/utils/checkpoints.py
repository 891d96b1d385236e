"""Checkpoints with the reference's suffix naming and keep-best ring.

Counterpart of ``wseg_tpu/utils/checkpoints.py``: snapshots are named
``e{epoch:03d}Xs{score:4.3f}`` and written as
``{model|opt}_{name}_{suffix}.pth`` with ``torch.save``.  The model
file is the reference-layout state_dict (float32 CPU tensors, the names
``utils/convert.py`` writes), so ``infer_val --resume`` of the port and
``wseg_tpu.utils.torch_convert.load_reference_checkpoint`` both read
it; the optimizer file is ``optimizer.state_dict()``.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import torch

EXT = ".pth"


def make_suffix(epoch: int, score: float) -> str:
    return "e{:03d}Xs{:4.3f}".format(epoch, score)


def parse_suffix(suffix: str) -> Tuple[int, float]:
    """(epoch, score) of a snapshot suffix; (0, -1e16) if it is none."""
    m = re.match(r"e(\d+)Xs([-0-9.]+)", suffix)
    if not m:
        return 0, -1e16
    return int(m.group(1)), float(m.group(2))


def model_file(path: str, suffix: str) -> str:
    return os.path.join(path, f"model_enc_{suffix}{EXT}")


def opt_file(path: str, suffix: str) -> str:
    return os.path.join(path, f"opt_enc_{suffix}{EXT}")


class Checkpoint:
    """Saves one model + optimizer per suffix; keeps the newest max_n."""

    def __init__(self, path: str, max_n: int = 5):
        self.path = path
        self.max_n = max_n
        self.checkpoints = []
        os.makedirs(path, exist_ok=True)

    def checkpoint(self, suffix: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer):
        """Write ``suffix``'s files; delete the oldest beyond max_n.
        Returns the removed suffixes."""
        if "_" in suffix:
            raise ValueError("Underscores are not allowed in a suffix")
        state = {k: v.detach().float().cpu() if v.is_floating_point()
                 else v.detach().cpu()
                 for k, v in model.state_dict().items()}
        torch.save(state, model_file(self.path, suffix))
        torch.save(optimizer.state_dict(), opt_file(self.path, suffix))
        self.checkpoints.append(suffix)
        removed = []
        while len(self.checkpoints) > self.max_n:
            old = self.checkpoints.pop(0)
            removed.append(old)
            for f in (model_file(self.path, old), opt_file(self.path, old)):
                if os.path.isfile(f):
                    os.remove(f)
        return removed

    def load(self, suffix: str, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer) -> bool:
        """Load ``suffix`` into ``model`` (strict) and, when its file
        exists, ``optimizer``.  False if the model file is missing."""
        mf = model_file(self.path, suffix)
        if not os.path.isfile(mf):
            print("File not found:", mf)
            return False
        model.load_state_dict(torch.load(mf, map_location="cpu",
                                         weights_only=True), strict=True)
        of = opt_file(self.path, suffix)
        if os.path.isfile(of):
            optimizer.load_state_dict(torch.load(of, map_location="cpu",
                                                 weights_only=True))
        if suffix not in self.checkpoints:
            self.checkpoints.insert(0, suffix)
        return True
