"""Port model (WRN38 + CAM_CASA_WGAP_tf, test mode) vs the JAX model on
the same random weights and inputs, float32 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import (
    jax_model_and_random_variables,
    port_model_from_jax,
)


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _check(ours, ref, atol=1e-3, rtol=5e-3, name=""):
    """Tolerances of tests/test_reference_parity.py: f32 accumulation
    through a 38-layer backbone, atol scaled by the output magnitude."""
    atol_k = max(atol, 2e-6 * float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=atol_k, rtol=rtol,
                               err_msg=name)


def test_flagship_forward_matches_jax():
    jmodel, variables = jax_model_and_random_variables(seed=1)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)

    model = port_model_from_jax(variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.cls.shape == (2, 20) and got.masks.shape == (2, 64, 64, 21)
    _check(got.cls.numpy(), np.asarray(want.cls), name="cls")
    _check(got.masks.numpy(), np.asarray(want.masks), name="masks")
    # the random weights give non-trivial masks (not one flat class)
    assert float(np.asarray(want.masks).std()) > 1e-3


def test_bfloat16_model_runs_in_bfloat16():
    """NET.DTYPE bfloat16 converts the weights; outputs stay float32 and
    close to the float32 model's."""
    jmodel, variables = jax_model_and_random_variables(seed=3, size=32)
    x = torch.from_numpy(
        np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32))
    m32 = port_model_from_jax(variables)
    m16 = port_model_from_jax(variables, dtype="bfloat16")
    assert next(m16.parameters()).dtype == torch.bfloat16
    with torch.no_grad():
        a, b = m32(x), m16(x)
    assert b.masks.dtype == torch.float32
    assert float((a.masks - b.masks).abs().max()) < 0.1


@pytest.mark.parametrize("key,value", [("MODEL", "CAM_CASA_WGAP_tf_v7"),
                                       ("MODEL", "CAM_CASA_WGAP_tf_v10"),
                                       ("MODEL", "CAM_CASA_WGAP_tf_v3")])
def test_unported_configurations_raise(key, value):
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model

    cfg.NET.MODEL = "CAM_CASA_WGAP_tf"
    cfg.NET.BACKBONE = "resnet38"
    cfg.NET[key] = value
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_model(cfg.NET)
