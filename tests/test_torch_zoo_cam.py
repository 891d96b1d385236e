"""The port's classic-CAM heads against the JAX package (float32, CPU):
``bsl``, ``CAM_SA``, ``CAM_SA_WGAP`` and ``CAM_WGAP_v3`` / ``tf_v2`` on
ResNet-50, ``CAM_CASA`` and ``CAM_CASA_WGAP`` on WRN38, each on the
backbone ``tests/test_reference_parity.py`` pairs it with, at 64 px.
Test mode, train mode and the ``.pth`` round trip through
``load_reference_checkpoint``: see ``tests/torch_zoo.py`` (rel 1e-4).
Then ``bsl`` served by both packages' ``infer_val`` from one checkpoint.
"""

import pytest

from tests.torch_zoo import check_spec


@pytest.fixture(autouse=True)
def _reset_cfgs():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax.linen.Dropout as the identity (test-only)."""
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **kw: x)


@pytest.mark.parametrize("name,backbone", [
    ("bsl", "resnet50"),
    ("CAM_SA", "resnet50"),
    ("CAM_SA_WGAP", "resnet50"),
    ("CAM_WGAP_v3", "resnet50"),
    ("CAM_CASA_WGAP_tf_v2", "resnet50"),
    ("CAM_CASA", "resnet38"),
    ("CAM_CASA_WGAP", "resnet38"),
])
def test_zoo_model_matches_jax(name, backbone, tmp_path, monkeypatch,
                              no_jax_dropout):
    check_spec(name, backbone, 64, tmp_path, monkeypatch)


def test_cam_model_served_by_both_infer_vals(tmp_path, capsys):
    """``bsl`` (ResNet-50, classic CAM masks with the constant
    background) served by both packages' ``infer_val`` from one
    port-saved checkpoint, labels predicted from ``cls``
    (``USE_GT_LABELS`` False): the same indexed PNGs, >= 99% of the
    pixels of each map (as ``tests/test_torch_eval.py``: the CRF's tap
    weights round differently)."""
    import importlib.util
    import os
    import textwrap

    import numpy as np
    import torch
    from PIL import Image

    from tests.synthetic_voc import make_synthetic_voc
    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )
    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch import infer_val
    from wseg_tpu_torch.config import reset_cfg

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=3)
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(textwrap.dedent(f"""\
        NET:
          BACKBONE: "resnet50"
          MODEL: "bsl"
          DTYPE: "float32"
        TEST:
          METHOD: "multiscale"
          DATA_ROOT: "{root}"
          FLIP: True
          BATCH_SIZE: 4
          PAD_SIZE: [128, 128]
          PAD_ALIGN: 32
          SCALES: [1, 0.75]
          USE_GT_LABELS: False
          FP_CUT_SCORE: 0.3
          CRF_DTYPE: "float32"
        """))
    _, variables = jax_zoo_model_and_random_variables("bsl", "resnet50",
                                                      seed=2, size=33)
    ckpt = str(tmp_path / "port.pth")
    torch.save(port_zoo_model_from_jax(variables, "bsl", "resnet50")
               .state_dict(), ckpt)
    reset_jax_cfg()

    def argv(out):
        return ["--cfg", str(cfg_file), "--resume", ckpt,
                "--snapshot-dir", str(tmp_path / "snap"),
                "--logdir", str(tmp_path / "logs"), "--workers", "2",
                "--infer-list", os.path.join(root, "val_voc.txt"),
                "--mask-output-dir", str(tmp_path / out)]

    spec = importlib.util.spec_from_file_location(
        "root_infer_val", os.path.join(repo, "infer_val.py"))
    root_infer_val = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_infer_val)
    root_infer_val.main(argv("jax"))
    reset_cfg()
    infer_val.main(argv("port") + ["--device", "cpu"])
    agree = []
    for sub in ("no_crf", "crf"):
        jdir, pdir = tmp_path / "jax_0" / sub, tmp_path / "port_0" / sub
        names = sorted(os.listdir(jdir))
        assert len(names) == 3 and sorted(os.listdir(pdir)) == names
        for name in names:
            a = np.asarray(Image.open(pdir / name))
            b = np.asarray(Image.open(jdir / name))
            assert a.shape == b.shape == (60, 80)
            agree.append(float((a == b).mean()))
            # predicted labels leave several classes in each map
            assert len(np.unique(b)) >= 3, (sub, name)
    assert min(agree) >= 0.99, agree
    capsys.readouterr()
