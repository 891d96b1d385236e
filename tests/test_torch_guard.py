"""The port stands alone: importing ``wseg_tpu_torch`` and every one of
its submodules (57 with the SoftMaxAE modules -- ``models/backbones/
{resnet,vgg16}``, ``models/heads/softmax_ae``, ``ops/sg`` -- and the
host tools ``eval_seg`` and ``convert_sbd``), and the root
``chip_smoke.py``, pulls in neither jax, flax nor the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import wseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(wseg_tpu_torch.__path__,
                                               "wseg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "wseg_tpu"))
print(len(names), bad)
new = {"wseg_tpu_torch.models.backbones.resnet",
       "wseg_tpu_torch.models.backbones.vgg16",
       "wseg_tpu_torch.models.heads.softmax_ae", "wseg_tpu_torch.ops.sg",
       "wseg_tpu_torch.eval_seg", "wseg_tpu_torch.convert_sbd"}
sys.exit(1 if bad or len(names) < 57 or not new <= set(names) else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
