"""Port losses, pseudo-GT and device colour jitter vs the JAX package,
float32 on the CPU, on numpy-seeded inputs.

Tolerances: the losses agree at atol 1e-6 times max(1, |loss|)
(float32 reductions in a different order: one ulp of a loss near 20 is
1.9e-6); ``pseudo_gtmask`` is exact (thresholds of the same
float32 values); the jitter's brightness / contrast / saturation are
integer math on integer-valued floats and exact; the hue path is a
float HSV round trip quantised to integers, where a pixel can land on
the other side of a rounding boundary: at most 1 grey level, on at most
0.1% of the pixels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-6):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol * scale)


@pytest.mark.parametrize("name", ["SoftMargin", "Hinge"])
def test_classification_criteria_match_jax(name):
    from wseg_tpu.losses import get_criterion as jax_criterion
    from wseg_tpu_torch.losses import get_criterion

    rng = np.random.RandomState(0)
    logits = (rng.randn(4, 20) * 3).astype(np.float32)
    labels = (rng.rand(4, 20) > 0.7).astype(np.float32)
    _close(get_criterion(name)(_t(logits), _t(labels)).numpy(),
           jax_criterion(name)(jnp.asarray(logits), jnp.asarray(labels)))


def test_pseudo_gtmask_is_exact():
    from wseg_tpu.ops.pseudo_mask import pseudo_gtmask as jax_pgt
    from wseg_tpu_torch.ops.pseudo_mask import pseudo_gtmask

    rng = np.random.RandomState(1)
    mask = rng.rand(3, 20, 24, 21).astype(np.float32) ** 3
    mask[2] *= 0.15                    # below cutoff_low everywhere
    got = pseudo_gtmask(_t(mask)).numpy()
    want = np.asarray(jax_pgt(jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert got[:2].sum() > 0 and got[2].sum() == 0


def _balanced_case():
    """Pseudo-GT whose class set equals the labels (+ BG) in rows 0 and
    2 (those rows count) and not in row 1 (cancelled)."""
    rng = np.random.RandomState(2)
    b, h, w, c = 3, 32, 40, 21
    idx = rng.randint(0, 3, size=(b, h, w))
    classes = np.array([[0, 4, 9], [0, 4, 9], [0, 1, 2]])
    lab_idx = np.take_along_axis(classes[:, None, None, :],
                                 idx[..., None], axis=-1)[..., 0]
    pgt = np.eye(c, dtype=np.float32)[lab_idx]
    pgt[:, :4, :4] = 0.0               # unlabelled pixels are ignored
    labels = np.zeros((b, c - 1), np.float32)
    labels[0, [3, 8]] = 1
    labels[1, [3]] = 1                 # class 9 present but not labelled
    labels[2, [0, 1]] = 1
    logits = (rng.randn(b, 8, 10, c) * 2).astype(np.float32)
    return logits, pgt, labels


def test_balanced_mask_loss_matches_jax():
    from wseg_tpu.ops.pseudo_mask import balanced_mask_loss_ce as jax_ce
    from wseg_tpu_torch.ops.pseudo_mask import balanced_mask_loss_ce

    logits, pgt, labels = _balanced_case()
    got = balanced_mask_loss_ce(_t(logits), _t(pgt), _t(labels)).numpy()
    want = np.asarray(jax_ce(logits, pgt, labels))
    _close(got, want)
    assert want[0] > 0 and want[1] == 0 and want[2] > 0


def test_balanced_mask_loss_gradient_flows_through_the_upsampling():
    """The mask logits are upsampled by the matrix resize before the
    log-softmax; their gradient matches JAX's."""
    import jax

    from wseg_tpu.ops.pseudo_mask import balanced_mask_loss_ce as jax_ce
    from wseg_tpu_torch.ops.pseudo_mask import balanced_mask_loss_ce

    logits, pgt, labels = _balanced_case()
    x = _t(logits).requires_grad_(True)
    balanced_mask_loss_ce(x, _t(pgt), _t(labels)).sum().backward()
    want = jax.grad(lambda v: jax_ce(v, pgt, labels).sum())(
        jnp.asarray(logits))
    _close(x.grad.numpy(), want, atol=1e-7)
    assert float(x.grad.abs().max()) > 0


def test_self_supervision_and_attention_losses_match_jax():
    from wseg_tpu.losses import attention_loss as jax_at
    from wseg_tpu.losses import self_supervision_loss as jax_ss
    from wseg_tpu_torch.losses import attention_loss, self_supervision_loss

    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 6, 8, 21) * 2).astype(np.float32)
    dec = rng.rand(2, 24, 32, 21).astype(np.float32) ** 4
    labels = np.zeros((2, 20), np.float32)
    labels[:, 5] = 1
    # make row 0's pseudo mask hold exactly BG + class 6
    dec[0, :, :, 1:] *= 0.01
    dec[0, :12, :, 6] = 1.0
    dec[0, 12:, :, 0] = 1.0
    loss, pgt = self_supervision_loss(_t(logits), _t(dec), _t(labels))
    jloss, jpgt = jax_ss(logits, dec, labels)
    np.testing.assert_array_equal(pgt.numpy(), np.asarray(jpgt))
    _close(loss.numpy(), jloss)
    assert float(loss[0]) > 0
    attn = rng.rand(2, 48).astype(np.float32)
    _close(attention_loss(_t(attn)).numpy(), jax_at(attn))


def _jitter_inputs(seed, n=6):
    from wseg_tpu.ops.jitter import sample_colour_jitter as jax_sample
    from wseg_tpu_torch.ops.jitter import sample_colour_jitter

    rng = np.random.RandomState(seed)
    imgs = (rng.rand(n, 40, 48, 3) * 255).astype(np.uint8).astype(
        np.float32)
    r1, r2 = np.random.RandomState(seed + 1), np.random.RandomState(seed + 1)
    params = np.stack([sample_colour_jitter(r1, p=0.8) for _ in range(n)])
    jparams = np.stack([jax_sample(r2, p=0.8) for _ in range(n)])
    np.testing.assert_array_equal(params, jparams)   # same rng stream
    return imgs, params


def _jitter_both(imgs, params):
    from wseg_tpu.ops.jitter import apply_colour_jitter as jax_apply
    from wseg_tpu_torch.ops.jitter import apply_colour_jitter

    got = apply_colour_jitter(_t(imgs), _t(params)).numpy()
    want = np.asarray(jax_apply(jnp.asarray(imgs), jnp.asarray(params)))
    return got, want


def test_colour_jitter_without_hue_is_exact():
    imgs, params = _jitter_inputs(4)
    params[:, 3] = 0.0
    got, want = _jitter_both(imgs, params)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, np.round(got))
    assert not np.array_equal(got, imgs)


def test_colour_jitter_hue_is_bounded():
    imgs, params = _jitter_inputs(5)
    params[:, 8] = 1.0
    params[:, 3] = np.where(np.abs(params[:, 3]) < 0.02, 0.05, params[:, 3])
    got, want = _jitter_both(imgs, params)
    d = np.abs(got - want)
    assert d.max() <= 1.0 and (d > 0).mean() <= 1e-3, (d.max(),
                                                      (d > 0).mean())
