"""The port stands alone: importing ``wseg_tpu_torch`` and every one of
its submodules (66 with the SoftMaxAE modules -- ``models/backbones/
{resnet,vgg16}``, ``models/heads/softmax_ae``, ``ops/sg`` --, the host
tools ``eval_seg`` and ``convert_sbd``, and the SEAM trainer and the
Grad-CAM suite -- ``engine/seam``, ``train_SEAM``, ``ops/activations``,
``gradcam/{cam_methods,fullgrad}``, ``infer_cam``, ``cam``), and the
root ``chip_smoke.py``, pulls in neither jax, flax nor the JAX
package."""

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
       "wseg_tpu_torch.eval_seg", "wseg_tpu_torch.convert_sbd",
       "wseg_tpu_torch.engine.seam", "wseg_tpu_torch.train_SEAM",
       "wseg_tpu_torch.ops.activations", "wseg_tpu_torch.gradcam",
       "wseg_tpu_torch.gradcam.cam_methods",
       "wseg_tpu_torch.gradcam.fullgrad", "wseg_tpu_torch.infer_cam",
       "wseg_tpu_torch.cam"}
sys.exit(1 if bad or len(names) < 66 or not new <= set(names) else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
