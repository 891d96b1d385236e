"""``python -m wseg_tpu_torch.infer_val`` vs the root ``infer_val.py``:
same flags, same checkpoint (a port state_dict saved as .pth, which the
JAX CLI converts), same synthetic VOC images -> the same indexed PNGs
(>= 99% of pixels per map; the CRF's tap weights round differently, see
tests/test_torch_serving.py).  Image labels are predicted from the
model's scores (USE_GT_LABELS False), so the random weights give maps
with several classes."""

import importlib.util
import os
import textwrap

import numpy as np
import torch

from tests.synthetic_voc import make_synthetic_voc
from tests.torch_parity import (
    jax_model_and_random_variables,
    port_model_from_jax,
)


def _write_cfg(tmp_path, root):
    p = tmp_path / "cfg.yaml"
    p.write_text(textwrap.dedent(f"""\
        NET:
          BACKBONE: "resnet38"
          MODEL: "CAM_CASA_WGAP_tf"
          DTYPE: "float32"
        TEST:
          METHOD: "multiscale"
          DATA_ROOT: "{root}"
          FLIP: True
          BATCH_SIZE: 4
          PAD_SIZE: [128, 128]
          PAD_ALIGN: 32
          SCALES: [1, 0.5]
          USE_GT_LABELS: False
          BG_POW: 3
          CRF_DTYPE: "float32"
        """))
    return str(p)


def _root_infer_val():
    """The repository's root ``infer_val.py`` as a module."""
    path = os.path.join(os.path.dirname(__file__), "..", "infer_val.py")
    spec = importlib.util.spec_from_file_location("root_infer_val", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_port_cli_writes_the_same_pngs(tmp_path):
    from PIL import Image

    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch import infer_val as port_cli
    from wseg_tpu_torch.config import reset_cfg as reset_port_cfg

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=3)
    cfg_file = _write_cfg(tmp_path, root)
    _, variables = jax_model_and_random_variables(seed=11, size=32)
    ckpt = str(tmp_path / "port.pth")
    torch.save(port_model_from_jax(variables).state_dict(), ckpt)
    reset_jax_cfg()

    def argv(out):
        return ["--cfg", cfg_file, "--resume", ckpt,
                "--snapshot-dir", str(tmp_path / "snap"),
                "--logdir", str(tmp_path / "logs"), "--workers", "2",
                "--infer-list", os.path.join(root, "val_voc.txt"),
                "--mask-output-dir", str(tmp_path / out)]

    _root_infer_val().main(argv("jax"))
    reset_port_cfg()
    try:
        port_cli.main(argv("port") + ["--device", "cpu"])
    finally:
        reset_port_cfg()

    n_files = 0
    for suffix in ("0", "1"):
        for sub in ("no_crf", "crf"):
            jdir = tmp_path / f"jax_{suffix}" / sub
            pdir = tmp_path / f"port_{suffix}" / sub
            names = sorted(os.listdir(jdir))
            assert names and sorted(os.listdir(pdir)) == names
            for name in names:
                a, b = Image.open(pdir / name), Image.open(jdir / name)
                assert a.mode == "P" and a.getpalette() == b.getpalette()
                a, b = np.asarray(a), np.asarray(b)
                assert a.shape == b.shape == (60, 80)
                assert (a == b).mean() >= 0.99, (suffix, sub, name)
                n_files += 1
    assert n_files == 12
    # the GT-overlay strips are written too
    assert len(os.listdir(tmp_path / "port_0" / "vis")) == 3


def test_port_cli_without_a_card_raises(tmp_path):
    """``--device`` defaults to cuda: without a card the entry point
    raises instead of serving on the CPU."""
    import pytest

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from wseg_tpu_torch import infer_val as port_cli
    from wseg_tpu_torch.config import reset_cfg as reset_port_cfg

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=1)
    cfg_file = _write_cfg(tmp_path, root)
    reset_port_cfg()
    try:
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_cli.main(["--cfg", cfg_file,
                           "--snapshot-dir", str(tmp_path / "snap"),
                           "--logdir", str(tmp_path / "logs"),
                           "--infer-list", os.path.join(root, "val_voc.txt"),
                           "--mask-output-dir", str(tmp_path / "out")])
    finally:
        reset_port_cfg()
    assert not (tmp_path / "out_0").exists()
