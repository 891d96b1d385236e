"""The fast CRF's Gaussian blur (``wseg_tpu_torch/ops/crf_gauss.py``)
against the JAX package's Pallas kernel ``gauss_blur_pallas_cm``, run in
interpret mode on the CPU as tests/test_crf_pallas.py runs it (masked:
after JAX's own ``x * valid_mask``); the kernel's host plan and its
schedule in plain torch; and the wrapper's CPU dispatch and argument
checks.  The whole fast CRF stays held against JAX's ``impl="pallas"``
by tests/test_torch_crf.py."""

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


# the four filter shapes of a fast postprocess call, as (planes, h, w, r)
FLAGSHIP = [(8 * 21, 192, 256, 3), (8 * 21, 384, 512, 6),
            (8, 384, 512, 6), (8, 192, 256, 3)]
# a card of SMS SMs holding OCCUPANCY[i] blocks of band width BANDS[i]
# (about what an H100's occupancy calculator gives at r 3 and 6); on the
# card the wrapper asks the calculator
SMS = 132
OCCUPANCY = (6, 8, 10)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("planes,h,w,r", FLAGSHIP)
def test_plan_covers_the_plane_and_fills_the_card(planes, h, w, r, masked):
    """Every output in one tile, halos reaching r; the 21-class grids
    fill at least WAVES waves, the small C = 1 ones stop at the halo
    share (no segment shorter than HALO_SHARE x 2r rows) unless a grid
    of such segments fills the waves, with a block for every SM."""
    from wseg_tpu_torch.ops.crf_gauss import (
        BANDS,
        HALO_SHARE,
        MAX_THREADS,
        SMEM_LIMIT,
        WAVES,
        gauss_plan,
    )

    for per_sm in (OCCUPANCY, (2, 3, 4)):  # and a card holding fewer
        plan = gauss_plan(planes, h, w, r, masked, per_sm, SMS)
        cover = np.zeros((h, w), np.int32)
        for y0, y1, x0, x1 in plan.tiles():
            cover[y0:y1, x0:x1] += 1
            assert y1 - y0 <= plan.sh
        assert (cover == 1).all()
        # the staged span reaches at least r columns past each side
        assert (plan.span - plan.bw) // 2 >= r
        assert plan.threads <= MAX_THREADS and plan.threads >= plan.span
        assert plan.smem_bytes() <= SMEM_LIMIT
        assert plan.blocks_per_sm == per_sm[BANDS.index(plan.bw)]
        assert plan.waves == plan.blocks / (SMS * plan.blocks_per_sm)
        sh_min = HALO_SHARE * 2 * r
        assert plan.sh >= sh_min
        if planes > 8:
            assert plan.waves >= WAVES, plan
        else:
            assert plan.blocks >= SMS, plan
            assert plan.waves >= WAVES or plan.sh == sh_min, plan


def test_plan_rejects_a_radius_over_the_kernels():
    from wseg_tpu_torch.ops.crf_gauss import MAX_R, gauss_plan

    with pytest.raises(ValueError, match="radius"):
        gauss_plan(1, 64, 64, MAX_R + 1, False, OCCUPANCY, SMS)


def test_plan_takes_an_occupancy_for_every_band():
    """A band width the card holds no block of is never planned; an
    occupancy tuple of the wrong length raises."""
    from wseg_tpu_torch.ops.crf_gauss import gauss_plan

    plan = gauss_plan(8 * 21, 192, 256, 3, True, (0, 8, 10), SMS)
    assert plan.bw != 128 and plan.blocks_per_sm in (8, 10)
    with pytest.raises(ValueError, match="band"):
        gauss_plan(8, 64, 64, 3, False, (6, 8), SMS)
    with pytest.raises(ValueError, match="band"):
        gauss_plan(8, 64, 64, 3, False, (0, 0, 0), SMS)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,c,h,w,r,bw,sh", [
    (2, 3, 20, 28, 3, None, None),
    (1, 3, 5, 9, 6, None, None),     # the plane is smaller than its halo
    (2, 2, 19, 30, 3, 32, 4),        # W % 4 = 2, a ragged last segment
    (2, 1, 13, 10, 0, 32, 5),        # r 0
    (1, 2, 40, 70, 16, None, None),  # r 16
    (1, 2, 24, 200, 6, 128, 9),      # a ragged last band
    (2, 21, 48, 64, 6, 64, 13)])
def test_tiled_schedule_is_the_plain_blur(b, c, h, w, r, bw, sh, masked):
    """Every tile from its own staged span and rows, stitched: bit-equal
    to the whole-plane slice-sum (the same float ops per element)."""
    import dataclasses

    from wseg_tpu_torch.ops.crf_gauss import (
        gauss_blur_cm_reference,
        gauss_blur_cm_tiled_reference,
        gauss_plan,
    )

    rng = np.random.RandomState(h + w + r)
    x = torch.from_numpy(rng.rand(b, c, h, w).astype(np.float32))
    mask = (torch.from_numpy((rng.rand(b, 1, h, w) > 0.3).astype(
        np.float32)) if masked else None)
    k1d = _taps(r, max(r / 2.0, 0.5))
    plan = gauss_plan(b * c, h, w, r, masked, OCCUPANCY, SMS)
    if bw is not None:
        plan = dataclasses.replace(plan, bw=bw, sh=sh)
    got = gauss_blur_cm_tiled_reference(x, k1d, r, mask, plan)
    assert torch.equal(got, gauss_blur_cm_reference(x, k1d, r, mask))


@pytest.mark.parametrize("b,c,h,w,r", [
    (2, 5, 20, 28, 6),
    (2, 1, 16, 24, 3),
    (1, 3, 5, 9, 6)])
def test_masked_plain_blur_matches_pallas(b, c, h, w, r):
    """The masked blur against JAX's ``x * valid_mask`` and the Pallas
    kernel (interpret mode): rtol 1e-5, atol 1e-6."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.crf_pallas import gauss_blur_pallas_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm_reference

    rng = np.random.RandomState(7 + r + c)
    x = rng.rand(b, c, h, w).astype(np.float32)
    valid = np.zeros((b, 1, h, w), np.float32)
    valid[:, :, :h * 3 // 4, :w * 2 // 3] = 1.0
    k1d = _taps(r, r / 2.0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gauss_blur_pallas_cm(
            jnp.asarray(x) * jnp.asarray(valid), np.asarray(k1d), r))
    got = gauss_blur_cm_reference(torch.from_numpy(x), k1d, r,
                                  torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_with_a_mask_use_the_plain_version():
    from wseg_tpu_torch.ops.crf_gauss import (
        gauss_blur_cm,
        gauss_blur_cm_reference,
    )

    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(2, 3, 11, 7).astype(np.float32))
    mask = torch.from_numpy((rng.rand(2, 1, 11, 7) > 0.5).astype(np.float32))
    k1d = _taps(3, 1.5)
    before = gauss_blur_cm.launches
    got = gauss_blur_cm(x, k1d, 3, mask=mask)
    assert gauss_blur_cm.launches == before  # no kernel on CPU
    # the multiply the fast CRF made before the call until the kernel
    # took it in
    assert torch.equal(got, gauss_blur_cm_reference((x * mask).contiguous(),
                                                    k1d, 3))


def test_wrapper_rejects_bad_masks():
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    x = torch.rand(2, 3, 8, 10)
    k1d = _taps(2, 1.0)
    with pytest.raises(ValueError, match="mask"):
        gauss_blur_cm(x, k1d, 2, mask=torch.ones(2, 3, 8, 10))
    with pytest.raises(ValueError, match="mask"):
        gauss_blur_cm(x, k1d, 2, mask=torch.ones(1, 1, 8, 10))
    with pytest.raises(TypeError, match="mask"):
        gauss_blur_cm(x, k1d, 2, mask=torch.ones(2, 1, 8, 10,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match="mask on"):
        gauss_blur_cm(x, k1d, 2, mask=torch.ones(2, 1, 8, 10,
                                                 device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        gauss_blur_cm(x, k1d, 2,
                      mask=torch.ones(2, 1, 10, 8).transpose(2, 3))
