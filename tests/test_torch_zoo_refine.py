"""The port's refined heads and the zoo's new modules against the JAX
package (float32, CPU).

* ``CAM_CASA_WGAP_v5``/``v6`` (PAMR), ``CAM_CASA_WGAP_PCM`` (PCM) and
  ``ae`` on WRN38 at 64 px: test mode, train mode and the ``.pth``
  round trip, see ``tests/torch_zoo.py`` (rel 1e-4);
* units: ``GlobalSRA`` at sr 1 and 3, ``adaptive_max_pool``, ``FPN``
  and ``_pcm_refine`` on random inputs;
* the heads that read WRN38-only taps refuse other backbones, where the
  JAX forward fails too, and ``tf_v3``, ``tf_v9_2`` and ``tf_v10`` build
  with the module names of ``wseg_tpu``'s reference head map.
"""

import numpy as np
import pytest
import torch

from tests.torch_zoo import (
    check,
    check_spec,
    jax_module_variables,
    port_module_from_jax,
)


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


@pytest.mark.parametrize("name", ["CAM_CASA_WGAP_v5", "CAM_CASA_WGAP_v6",
                                  "CAM_CASA_WGAP_PCM", "ae"])
def test_zoo_model_matches_jax(name, tmp_path, monkeypatch, no_jax_dropout):
    check_spec(name, "resnet38", 64, tmp_path, monkeypatch)


@pytest.mark.parametrize("sr,hw", [(1, (5, 7)), (3, (7, 9))])
def test_global_sra_matches_jax(sr, hw):
    """GlobalSRA (dim 64, 8 heads) on (2, h, w, 64): rel 1e-5.  At sr 3
    the strided ``sr`` conv drops the last row and column as JAX's VALID
    conv does, and the LayerNorm's epsilon is 1e-6."""
    import jax.numpy as jnp

    from wseg_tpu.models.heads.attention import GlobalSRA as JaxSRA
    from wseg_tpu_torch.models.heads.attention import GlobalSRA

    x = np.random.RandomState(0).randn(2, *hw, 64).astype(np.float32)
    jm = JaxSRA(64, 8, sr)
    v = jax_module_variables(jm, 1, x)
    want = jm.apply(v, jnp.asarray(x))
    port = port_module_from_jax(GlobalSRA(64, 8, sr), v)
    assert (sr > 1) == ("norm.weight" in port.state_dict())
    if sr > 1:
        assert port.norm.eps == 1e-6
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    check(got.numpy(), want, "GlobalSRA", rel=1e-5)


@pytest.mark.parametrize("hw_in,hw_out", [((16, 16), (8, 8)),
                                          ((17, 13), (9, 9)),
                                          ((5, 7), (5, 7)),
                                          ((9, 4), (4, 3))])
def test_adaptive_max_pool_matches_jax(hw_in, hw_out):
    """Exact (a max picks one of its inputs)."""
    import jax.numpy as jnp

    from wseg_tpu.ops.resize import adaptive_max_pool as jax_pool
    from wseg_tpu_torch.ops.resize import adaptive_max_pool

    x = np.random.RandomState(1).randn(2, *hw_in, 3).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), hw_out))
    got = adaptive_max_pool(torch.from_numpy(x), hw_out).numpy()
    np.testing.assert_array_equal(got, want)


def test_fpn_matches_jax():
    """FPN (out 32) on WRN38-like taps at strides 4 and 8: rel 1e-5."""
    import jax.numpy as jnp

    from wseg_tpu.models.heads.fpn import FPN as JaxFPN
    from wseg_tpu_torch.models.heads.fpn import FPN
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    rng = np.random.RandomState(2)
    chans = {"conv3": 8, "conv4": 16, "conv5": 24, "conv6": 40}
    taps = {k: np.maximum(rng.randn(2, 16 if k == "conv3" else 8,
                                    16 if k == "conv3" else 8, c), 0)
            .astype(np.float32) for k, c in chans.items()}
    jm = JaxFPN(32)
    v = jax_module_variables(jm, 3, taps)
    want = jm.apply(v, {k: jnp.asarray(t) for k, t in taps.items()})
    port = FPN(chans, 32)
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = port({k: torch.from_numpy(t) for k, t in taps.items()})
    assert got.shape == (2, 16, 16, 32)
    check(got.numpy(), want, "FPN", rel=1e-5)


def test_pcm_refine_matches_jax():
    """``_pcm_refine`` alone, on random logits (B, 6, 6, 21), conv4 /
    conv5 taps and image, with seeded f8_3 / f8_4 / f9 weights: the
    (B, 6, 6, 21) propagated CAM, rel 1e-5."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import random_variables
    from wseg_tpu.models.stage_net import MODEL_SPECS, StageNet as JaxNet
    from wseg_tpu_torch.models.stage_net import (
        MODEL_SPECS as SPECS,
        StageNet,
    )
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    class PCMOnly(JaxNet):
        """The JAX StageNet's ``_pcm_refine`` as its only method."""

        @fnn.compact
        def __call__(self, lg, img, c4, c5):
            return self._pcm_refine(lg, {"conv4": c4, "conv5": c5}, img)

    rng = np.random.RandomState(4)
    b, h = 2, 6
    logits = rng.randn(b, h, h, 21).astype(np.float32)
    c4 = np.maximum(rng.randn(b, h, h, 512), 0).astype(np.float32)
    c5 = np.maximum(rng.randn(b, h, h, 1024), 0).astype(np.float32)
    image = rng.randn(b, 4 * h, 4 * h, 3).astype(np.float32)
    jm = PCMOnly(spec=MODEL_SPECS["CAM_CASA_WGAP_PCM"], backbone="resnet38")
    args = [jnp.asarray(a) for a in (logits, image, c4, c5)]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    v = random_variables(shapes, 5, ())
    want = jm.apply(v, *args)
    port = StageNet(SPECS["CAM_CASA_WGAP_PCM"], "resnet38")
    sd = state_dict_from_jax(v)
    assert set(sd) == {"f8_3.weight", "f8_4.weight", "f9.weight"}
    port.load_state_dict(sd, strict=False)
    td = {"conv4": torch.from_numpy(c4).permute(0, 3, 1, 2),
          "conv5": torch.from_numpy(c5).permute(0, 3, 1, 2)}
    with torch.no_grad():
        got = port._pcm_refine(torch.from_numpy(logits), td,
                               torch.from_numpy(image))
    assert got.shape == (b, h, h, 21)
    check(got.numpy(), want, "pcm", rel=1e-5)


@pytest.mark.parametrize("name,backbone", [("CAM_MF", "resnet50"),
                                           ("CAM_MF_v2", "vgg16"),
                                           ("CAM_CASA_WGAP_PCM", "resnet101")])
def test_wrn38_taps_heads_refuse_other_backbones(name, backbone):
    """The port raises at construction, naming the missing taps; the
    JAX forward fails on the same pair (a missing tap)."""
    import jax
    import jax.numpy as jnp

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.models import get_model as jax_get_model
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model

    net = jax_default_cfg().NET
    net.MODEL, net.BACKBONE = name, backbone
    jm = jax_get_model(net)
    img = jnp.zeros((1, 32, 32, 3))
    key = jax.random.PRNGKey(0)
    with pytest.raises(KeyError, match="conv"):
        jax.eval_shape(lambda: jm.init(key, img, img, jnp.zeros((1, 20)),
                                       train=False))
    cfg.NET.MODEL, cfg.NET.BACKBONE = name, backbone
    with pytest.raises(ValueError, match=r"reads the backbone taps .*conv"):
        get_model(cfg.NET)


@pytest.mark.parametrize("name", ["CAM_CASA_WGAP_tf_v3",
                                  "CAM_CASA_WGAP_tf_v9_2",
                                  "CAM_CASA_WGAP_tf_v10"])
def test_waiting_heads_raise_naming_a5c(name):
    """``get_model`` builds the head on WRN38 with the reference's
    module names: every head prefix of ``wseg_tpu``'s ``get_head_map``
    (which ``load_reference_checkpoint`` reads) has its tensors, and no
    head tensor lies outside them."""
    from wseg_tpu.utils.torch_convert import get_head_map
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model

    cfg.NET.MODEL, cfg.NET.BACKBONE = name, "resnet38"
    model = get_model(cfg.NET)
    prefixes = [p for p, _, _ in get_head_map(name)]
    head = {n for n in model.state_dict()
            if n not in model._backbone.state_dict()}
    for p in prefixes:
        assert any(n.startswith(p + ".") for n in head), p
    assert all(n.rsplit(".", 1)[0] in prefixes for n in head), head
    assert ("fc8_2" in prefixes) == name.endswith("tf_v3")
