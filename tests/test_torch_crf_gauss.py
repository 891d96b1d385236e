"""The fast CRF's Gaussian blur (``wseg_tpu_torch/ops/crf_gauss.py``)
against the JAX package's Pallas kernel ``gauss_blur_pallas_cm``, run in
interpret mode on the CPU as tests/test_crf_pallas.py runs it; and the
wrapper's CPU dispatch and argument checks.  The whole fast CRF stays
held against JAX's ``impl="pallas"`` by tests/test_torch_crf.py."""

import numpy as np
import pytest
import torch


def _taps(r, sxy):
    x = np.arange(-r, r + 1, dtype=np.float32)
    return [float(v) for v in np.exp(-x * x / (2.0 * sxy * sxy))]


@pytest.mark.parametrize("b,c,h,w,r", [
    (2, 1, 16, 24, 3),
    (2, 5, 20, 28, 6),
    (1, 3, 5, 9, 6),        # the plane is smaller than its halo
])
def test_plain_blur_matches_pallas(b, c, h, w, r):
    """Same taps in the same order in float32: rtol 1e-5, atol 1e-6."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.crf_pallas import gauss_blur_pallas_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm_reference

    rng = np.random.RandomState(r + c)
    x = rng.rand(b, c, h, w).astype(np.float32)
    k1d = _taps(r, r / 2.0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gauss_blur_pallas_cm(jnp.asarray(x),
                                               np.asarray(k1d), r))
    got = gauss_blur_cm_reference(torch.from_numpy(x), k1d, r).numpy()
    assert got.shape == want.shape == (b, c, h, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_use_the_plain_version():
    from wseg_tpu_torch.ops.crf_gauss import (
        gauss_blur_cm,
        gauss_blur_cm_reference,
    )

    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 3, 11, 7).astype(np.float32))
    k1d = _taps(3, 1.5)
    before = gauss_blur_cm.launches
    got = gauss_blur_cm(x, k1d, 3)
    assert gauss_blur_cm.launches == before  # no kernel on CPU
    assert torch.equal(got, gauss_blur_cm_reference(x, k1d, 3))
    # the separable blur is the 2-D correlation with the outer product
    k2 = np.outer(k1d, k1d)
    xp = np.pad(x.numpy(), ((0, 0), (0, 0), (3, 3), (3, 3)))
    want = sum(k2[i, j] * xp[:, :, i:i + 11, j:j + 7]
               for i in range(7) for j in range(7))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_bad_inputs():
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    x = torch.rand(1, 2, 8, 10)
    k1d = _taps(2, 1.0)
    with pytest.raises(TypeError):
        gauss_blur_cm(x.double(), k1d, 2)
    with pytest.raises(ValueError, match="contiguous"):
        gauss_blur_cm(x.transpose(2, 3), k1d, 2)
    with pytest.raises(ValueError):
        gauss_blur_cm(x[0], k1d, 2)
    with pytest.raises(ValueError, match="taps"):
        gauss_blur_cm(x, k1d, 3)
