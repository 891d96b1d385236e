"""The ResNet-50 transformer heads ``CAM_CASA_WGAP_tf_v4``-``tf_v8`` and
``tf_v10`` against the JAX package (float32, CPU), and the registry.

* Each head on ResNet-50 at 64 px (``tf_v5``, whose unpadded window 3
  needs 6 x 6 features, at 96), one shared case (``tests/torch_zoo.py``
  ``zoo_case``) for three tests: the ``.pth`` round trip through
  ``load_reference_checkpoint`` (strict, every leaf bit for bit), test
  mode and train mode (dropout off, plain PAMR), rel 1e-4.
* Where JAX's forward fails the port raises a ``ValueError`` naming the
  head: ``tf_v5``'s unpadded window 3 on 4 x 4 features, ``tf_v6``'s
  swapped pad on 4 x 5 features (4 and 5 differ mod 7).
* The registries hold the same 26 keys with equal specs, and a serving
  model of ``tf_v7`` in bfloat16 keeps its two talking-heads mixers
  float32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_zoo import (
    check_round_trip,
    check_test_mode,
    check_train_mode,
    zoo_case,
)

HEADS = [("CAM_CASA_WGAP_tf_v4", 64), ("CAM_CASA_WGAP_tf_v5", 96),
         ("CAM_CASA_WGAP_tf_v6", 64), ("CAM_CASA_WGAP_tf_v7", 64),
         ("CAM_CASA_WGAP_tf_v8", 64), ("CAM_CASA_WGAP_tf_v10", 64)]


@pytest.fixture(autouse=True)
def _reset_cfgs():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


@pytest.fixture(scope="module", params=HEADS, ids=[n for n, _ in HEADS])
def head(request):
    """One JAX init and port model per head, shared by its tests."""
    name, size = request.param
    return zoo_case(name, "resnet50", size)


def test_tf_r50_head_pth_round_trip(head, tmp_path):
    check_round_trip(head, tmp_path)
    names = set(head["model"].state_dict())
    if head["name"].endswith("tf_v10"):
        assert {"attn_conv.weight", "norm.weight", "norm.bias",
                "selfattn.qkv.weight"} <= names
        assert not any(n.startswith(("caatention", "attention."))
                       for n in names)
    assert head["name"].endswith("tf_v7") == (
        "selfattn.post_softmax_proj.weight" in names)


def test_tf_r50_head_test_mode_matches_jax(head):
    check_test_mode(head)


def test_tf_r50_head_train_mode_matches_jax(head):
    check_train_mode(head)


@pytest.mark.parametrize("name,hw,window", [
    ("CAM_CASA_WGAP_tf_v5", (64, 64), "(4, 4).*unpadded window 3"),
    ("CAM_CASA_WGAP_tf_v6", (64, 80), r"\(4, 5\) padded to \(6, 8\).*"
                                      "window 7")], ids=["tf_v5", "tf_v6"])
def test_tf_r50_head_refuses_where_jax_fails(name, hw, window):
    """JAX's window attention asserts on the (un)padded features; the
    port raises a ``ValueError`` naming the head, the window and the
    size, and serves a size that works."""
    import jax
    import jax.numpy as jnp

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.models import get_model as jax_get_model
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model

    net = jax_default_cfg().NET
    net.MODEL, net.BACKBONE = name, "resnet50"
    jm = jax_get_model(net)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, *hw, 3)), train=False))
    cfg.NET.MODEL, cfg.NET.BACKBONE, cfg.NET.DTYPE = name, "resnet50", \
        "float32"
    model = get_model(cfg.NET)
    with torch.no_grad():
        assert model(torch.zeros(1, 96, 96, 3)).masks.shape == (
            1, 96, 96, 21)
        with pytest.raises(ValueError, match=rf"'{name}'.*{window}"):
            model(torch.zeros(1, *hw, 3))


def test_registries_list_the_same_specs():
    """``get_model``'s registry is ``wseg_tpu``'s: the same 26 keys,
    each spec's fields equal."""
    from wseg_tpu.models.stage_net import MODEL_SPECS as JAX_SPECS
    from wseg_tpu_torch.models.stage_net import MODEL_SPECS

    assert sorted(MODEL_SPECS) == sorted(JAX_SPECS) and len(JAX_SPECS) == 26
    for key, spec in JAX_SPECS.items():
        assert dataclasses.asdict(MODEL_SPECS[key]) == \
            dataclasses.asdict(spec), key


def test_bfloat16_serving_model_keeps_the_mixers_float32():
    """``get_model`` with ``NET.DTYPE bfloat16`` casts ``tf_v7``'s
    weights but not its talking-heads mixers (as Flax leaves a bare
    ``self.param``); the model serves finite masks."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model

    cfg.NET.MODEL, cfg.NET.BACKBONE, cfg.NET.DTYPE = \
        "CAM_CASA_WGAP_tf_v7", "resnet50", "bfloat16"
    model = get_model(cfg.NET)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    mixers = {"selfattn.pre_softmax_proj.weight",
              "selfattn.post_softmax_proj.weight"}
    assert {dtypes[n] for n in mixers} == {torch.float32}
    assert {d for n, d in dtypes.items() if n not in mixers} == {
        torch.bfloat16}
    with torch.no_grad():
        out = model(torch.from_numpy(np.random.RandomState(0).randn(
            1, 64, 64, 3).astype(np.float32)))
    assert out.masks.dtype == torch.float32
    assert bool(torch.isfinite(out.masks).all())
