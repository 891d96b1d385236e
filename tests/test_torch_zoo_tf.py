"""The WRN38 transformer heads ``CAM_CASA_WGAP_tf_v3``, ``tf_v9`` and
``tf_v9_2`` and the attention modules they add, against the JAX
package (float32, CPU).

* Each head on WRN38 at 64 px, one shared case (``tests/torch_zoo.py``
  ``zoo_case``: one JAX init, the port model carrying its seeded
  weights) for three tests: the ``.pth`` round trip through
  ``load_reference_checkpoint`` (strict, every leaf bit for bit), test
  mode and train mode (dropout off, plain PAMR), rel 1e-4.
* Units on seeded random inputs against ``wseg_tpu``'s own modules
  (rel 1e-5): ``WindowAttention`` with talking heads, a cross query and
  ``out_dim`` together; the query-axis softmax with one set of weights
  at windows 2 and 4; ``GridAttention``; ``pad_to_multiple`` with
  tf_v6's swapped full pad (exact).
* ``tf_v3``'s unpadded window 2 on 9 x 9 features: JAX's forward
  asserts, the port raises a ``ValueError`` naming the head.
"""

import numpy as np
import pytest
import torch

from tests.torch_zoo import (
    check,
    check_round_trip,
    check_test_mode,
    check_train_mode,
    jax_module_variables,
    port_module_from_jax,
    zoo_case,
)

HEADS = ["CAM_CASA_WGAP_tf_v3", "CAM_CASA_WGAP_tf_v9",
         "CAM_CASA_WGAP_tf_v9_2"]


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


@pytest.fixture(scope="module", params=HEADS)
def head(request):
    """One JAX init and port model per head, shared by its tests."""
    return zoo_case(request.param, "resnet38", 64)


def test_tf_head_pth_round_trip(head, tmp_path):
    check_round_trip(head, tmp_path)
    names = set(head["model"].state_dict())
    if head["name"].endswith("tf_v3"):
        assert {"fc8.qkv.weight", "fc8.proj.weight", "fc8_2.weight"} <= names
        assert not any(n.startswith("selfattn.") for n in names)
    else:
        assert {"fc6.weight", "selfattn.qk.weight",
                "selfattn.v.weight"} <= names
    assert head["name"].endswith("tf_v9") == (
        "selfattn.pre_softmax_proj.weight" in names)


def test_tf_head_test_mode_matches_jax(head):
    check_test_mode(head)


def test_tf_head_train_mode_matches_jax(head, no_jax_dropout):
    check_train_mode(head)


def test_window_attention_talking_cross_out_dim_matches_jax():
    """``WindowAttention`` (dim 16, 8 heads, window 2) with talking
    heads, q and k from a query and ``out_dim`` 24, on (2, 4, 6, 16):
    rel 1e-5; the mixers are the transposed JAX params."""
    import jax.numpy as jnp

    from wseg_tpu.models.heads.attention import WindowAttention as JaxWA
    from wseg_tpu_torch.models.heads.attention import WindowAttention

    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 6, 16).astype(np.float32)
    q = rng.randn(2, 4, 6, 16).astype(np.float32)
    jm = JaxWA(16, 8, 2, talking=True, cross=True, out_dim=24)
    v = jax_module_variables(jm, 1, x, q)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(q))
    port = port_module_from_jax(
        WindowAttention(16, 8, 2, talking=True, cross=True, out_dim=24), v)
    np.testing.assert_array_equal(
        port.pre_softmax_proj.weight.detach().numpy(),
        np.asarray(v["params"]["pre_softmax_proj"]).T)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(q))
    assert got.shape == (2, 4, 6, 24)
    check(got.numpy(), want, "WindowAttention", rel=1e-5)


def test_query_axis_softmax_shares_weights_across_windows():
    """tf_v10's attention (softmax over the queries) with one set of
    weights at windows 2 and 4 on (2, 8, 8, 16): rel 1e-5 each, and the
    two windows give different outputs."""
    import jax.numpy as jnp

    from wseg_tpu.models.heads.attention import WindowAttention as JaxWA
    from wseg_tpu_torch.models.heads.attention import WindowAttention

    x = np.random.RandomState(2).randn(2, 8, 8, 16).astype(np.float32)
    jm = JaxWA(16, 8, softmax_query_axis=True)
    v = jax_module_variables(jm, 3, x)
    port = port_module_from_jax(
        WindowAttention(16, 8, softmax_query_axis=True), v)
    outs = []
    for ws in (2, 4):
        want = jm.apply(v, jnp.asarray(x), ws=ws)
        with torch.no_grad():
            got = port(torch.from_numpy(x), ws=ws)
        check(got.numpy(), want, f"ws {ws}", rel=1e-5)
        outs.append(got)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


def test_grid_attention_matches_jax():
    """``GridAttention`` (3 x 3 grid, 8 heads) on (2, 6, 9, 24):
    rel 1e-5."""
    import jax.numpy as jnp

    from wseg_tpu.models.heads.attention import GridAttention as JaxGA
    from wseg_tpu_torch.models.heads.attention import GridAttention

    x = np.random.RandomState(4).randn(2, 6, 9, 24).astype(np.float32)
    jm = JaxGA(24, 8, 3)
    v = jax_module_variables(jm, 5, x)
    want = jm.apply(v, jnp.asarray(x))
    port = port_module_from_jax(GridAttention(24, 8, 3), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    check(got.numpy(), want, "GridAttention", rel=1e-5)


@pytest.mark.parametrize("hw", [(4, 5), (7, 7), (9, 3)])
def test_pad_to_multiple_full_pad_bug_matches_jax(hw):
    """tf_v6's pad at window 7: the swapped amounts and the whole extra
    window, exact."""
    import jax.numpy as jnp

    from wseg_tpu.models.heads.attention import pad_to_multiple as jax_pad
    from wseg_tpu_torch.models.heads.attention import pad_to_multiple

    x = np.random.RandomState(6).randn(2, *hw, 3).astype(np.float32)
    want, want_hw = jax_pad(jnp.asarray(x), 7, 7, buggy_full_pad=True)
    got, got_hw = pad_to_multiple(torch.from_numpy(x), 7, 7,
                                  buggy_full_pad=True)
    assert got_hw == want_hw == hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[1:3] == (hw[0] + 7 - hw[1] % 7, hw[1] + 7 - hw[0] % 7)


def test_tf_v3_refuses_features_its_window_does_not_divide():
    """72 px on WRN38 gives 9 x 9 features: JAX's unpadded window 2
    asserts, the port raises a ``ValueError`` naming the head, the
    window and the size."""
    import jax
    import jax.numpy as jnp

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.models import get_model as jax_get_model
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model

    name = "CAM_CASA_WGAP_tf_v3"
    net = jax_default_cfg().NET
    net.MODEL, net.BACKBONE = name, "resnet38"
    jm = jax_get_model(net)
    with pytest.raises(AssertionError, match=r"\(9, 9, 2\)"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 72, 72, 3)),
                                       train=False))
    cfg.NET.MODEL, cfg.NET.BACKBONE, cfg.NET.DTYPE = name, "resnet38", \
        "float32"
    model = get_model(cfg.NET)
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
        with pytest.raises(ValueError,
                           match=rf"'{name}'.*\(9, 9\).*window 2"):
            model(torch.zeros(1, 72, 72, 3))
