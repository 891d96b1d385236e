"""The port stands alone: importing ``wseg_tpu_torch`` and every one of
its submodules (51 with the Gaussian blur and the PAMR lab), and the root
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
sys.exit(1 if bad or len(names) < 51 else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
