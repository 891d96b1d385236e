"""The port's multi-level and nGWP-scored heads against the JAX package
(float32, CPU): ``CAM_MF`` and ``CAM_MF_v2`` (the WRN38 taps
``conv3_pre``/``conv4``/``conv5``) and ``CAM_CASA_WGAP_v2``-``v4`` on
WRN38, at 64 px, as ``tests/test_reference_parity.py`` pairs them.
Test mode, train mode and the ``.pth`` round trip through
``load_reference_checkpoint``: see ``tests/torch_zoo.py`` (rel 1e-4).
``v4`` takes (B, C) labels with the background first, as its spec
says.
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


@pytest.mark.parametrize("name", ["CAM_MF", "CAM_MF_v2", "CAM_CASA_WGAP_v2",
                                  "CAM_CASA_WGAP_v3", "CAM_CASA_WGAP_v4"])
def test_zoo_model_matches_jax(name, tmp_path, monkeypatch, no_jax_dropout):
    check_spec(name, "resnet38", 64, tmp_path, monkeypatch)


def test_v4_train_path_refuses_c_minus_1_labels():
    """v4's train path takes (B, C) labels; the trainer's (B, C-1) ones
    fail in the port with a clear error, as wseg_tpu's forward fails on
    them (ROADMAP.md C2)."""
    import torch

    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model

    cfg.NET.MODEL, cfg.NET.BACKBONE = "CAM_CASA_WGAP_v4", "resnet50"
    model = get_model(cfg.NET, train=True)
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match=r"takes \(B, 21\) labels with the "
                       r"background first, got \(1, 20\)"):
        model(x, x, torch.ones(1, 20))
