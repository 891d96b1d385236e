"""The port's bilateral message and fast CRF vs the JAX package's Pallas
path (run in interpret mode on the CPU, as tests/test_crf_pallas.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _bf16_weights(rng, shape):
    """Random weights already on the bfloat16 grid, so the Pallas
    wrapper's bf16 cast and the port's bf16 input hold equal values."""
    w = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    return w.to(torch.bfloat16)


def test_plain_bilateral_matches_pallas():
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.crf_pallas import bilateral_message_pallas_cm
    from wseg_tpu_torch.ops.crf_bilateral import (
        bilateral_message_cm_reference,
    )

    rng = np.random.RandomState(0)
    taps = [(int(rng.randint(-6, 7)), int(rng.randint(-9, 10)))
            for _ in range(8)]
    q = rng.rand(2, 5, 16, 24).astype(np.float32)
    w = _bf16_weights(rng, (2, len(taps), 16, 24))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bilateral_message_pallas_cm(
            jnp.asarray(q), jnp.asarray(w.float().numpy()), taps))
    got = bilateral_message_cm_reference(torch.from_numpy(q), w,
                                         taps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_crf_matches_jax_pallas(dtype):
    """Coarse-to-fine CRF (full_stride 2, 1 refine iteration, bilateral
    stride 2) with a valid-mask window.  float32: max |dQ| <= 1e-4;
    bfloat16 messages: the bound of tests/test_crf_pallas.py."""
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.crf import crf_inference_jax
    from wseg_tpu_torch.ops.crf import crf_inference_torch

    rng = np.random.RandomState(2)
    img = (rng.rand(2, 32, 48, 3) * 255).astype(np.float32)
    probs = rng.rand(2, 32, 48, 6).astype(np.float32) ** 3
    probs /= probs.sum(-1, keepdims=True)
    valid = np.zeros((2, 32, 48, 1), np.float32)
    valid[0] = 1.0
    valid[1, 2:29, 5:40] = 1.0
    kw = dict(t=5, sxy_bilateral=8.0, bilateral_stride=2, full_stride=2,
              refine_iters=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(crf_inference_jax(
            jnp.asarray(img), jnp.asarray(probs),
            valid_mask=jnp.asarray(valid), impl="pallas",
            dtype=getattr(jnp, dtype), **kw))
    got = crf_inference_torch(
        torch.from_numpy(img), torch.from_numpy(probs),
        valid_mask=torch.from_numpy(valid), dtype=getattr(torch, dtype),
        **kw).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    if dtype == "float32":
        assert err <= 1e-4, err
    else:
        assert err < 5e-2 and agree > 0.98, (err, agree)
    # the messages moved Q away from the unary
    assert float(np.abs(got - probs * valid).max()) > 1e-2
