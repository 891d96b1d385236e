"""Port ops vs the JAX package's on the same numpy inputs (CPU).

Tolerance: atol 1e-5 in float32 (same formulas, different summation
order); uint8 views equal to within 1 (rounding of values that land
within float error of .5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ATOL = 1e-5


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,size", [((2, 7, 9, 3), (13, 5)),
                                        ((1, 12, 16, 21), (48, 64)),
                                        ((1, 1, 6, 2), (1, 4))])
def test_resize_bilinear(shape, size, align_corners):
    from wseg_tpu.ops.resize import resize_bilinear as jax_resize
    from wseg_tpu_torch.ops.resize import resize_bilinear

    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), size, align_corners))
    got = resize_bilinear(torch.from_numpy(x), size, align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # HW and HWC inputs keep their rank
    got2 = resize_bilinear(torch.from_numpy(x[0, ..., 0]), size,
                           align_corners).numpy()
    np.testing.assert_allclose(got2, want[0, ..., 0], atol=ATOL)
    got3 = resize_bilinear(torch.from_numpy(x[0]), size,
                           align_corners).numpy()
    np.testing.assert_allclose(got3, want[0], atol=ATOL)


def test_rescale_as():
    from wseg_tpu.ops.resize import rescale_as as jax_rescale
    from wseg_tpu_torch.ops.resize import rescale_as

    r = np.random.RandomState(1)
    x = r.rand(2, 8, 8, 21).astype(np.float32)
    y = r.rand(2, 64, 40, 3).astype(np.float32)
    want = np.asarray(jax_rescale(jnp.asarray(x), jnp.asarray(y)))
    got = rescale_as(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ngwp_focal_scores():
    from wseg_tpu.ops.pooling import ngwp_focal_scores as jax_scores
    from wseg_tpu_torch.ops.pooling import ngwp_focal_scores

    r = np.random.RandomState(2)
    logits = (3 * r.randn(2, 6, 5, 21)).astype(np.float32)
    masks = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = np.asarray(jax_scores(jnp.asarray(logits), jnp.asarray(masks),
                                 3.0, 0.01))
    got = ngwp_focal_scores(torch.from_numpy(logits),
                            torch.from_numpy(masks), 3.0, 0.01).numpy()
    assert got.shape == (2, 20)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("win", [(3, 2, 20, 30, 0, 0, 41, 57, False),
                                 (0, 4, 64, 96, 2, 1, 30, 40, True),
                                 (5, 5, 7, 9, 0, 0, 50, 60, True),
                                 (0, 0, 0, 0, 0, 0, 0, 0, False)])
def test_cubic_matrix(win):
    from wseg_tpu.ops.view_gen import cubic_matrix as jax_cubic
    from wseg_tpu_torch.ops.view_gen import cubic_matrix

    ds, _, dl, _, ss, _, sl, _, flip = win
    want = np.asarray(jax_cubic(70, 64, ds, dl, ss, sl, flip))
    got = cubic_matrix(70, 64, ds, dl, ss, sl, flip).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("flip_pair", [True, False])
def test_build_views_u8(flip_pair):
    from wseg_tpu.ops.view_gen import build_views_u8 as jax_views
    from wseg_tpu_torch.ops.view_gen import build_views_u8

    r = np.random.RandomState(3)
    orig = (r.rand(3, 48, 64, 3) * 255).astype(np.uint8)
    owin = np.asarray([[0, 0, 40, 56], [0, 0, 48, 30], [0, 0, 0, 0]],
                      np.int32)
    # scales 0.5, 1.5 and a padding slot, centred in a (64, 96) canvas
    vwin = np.asarray([[22, 34, 20, 28], [0, 25, 64, 45], [0, 0, 0, 0]],
                      np.int32)
    want = np.asarray(jax_views(jnp.asarray(orig), jnp.asarray(owin),
                                jnp.asarray(vwin), out_hw=(64, 96),
                                flip_pair=flip_pair))
    got = build_views_u8(torch.from_numpy(orig), torch.from_numpy(owin),
                         torch.from_numpy(vwin), out_hw=(64, 96),
                         flip_pair=flip_pair).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got[-1] == 0).all()  # the padding slot stays empty


def test_tent_matrix():
    from wseg_tpu.engine.infer import _tent_matrix as jax_tent
    from wseg_tpu_torch.engine.infer import _tent_matrix

    for ds, dl, ss, sl, flip in [(3.0, 40.0, 10.0, 20.0, False),
                                 (0.0, 64.0, 4.0, 96.0, True)]:
        want = np.asarray(jax_tent(64, 128, ds, dl, ss, sl, flip))
        f = torch.tensor
        got = _tent_matrix(64, 128, f(ds), f(dl), f(ss), f(sl),
                           f(flip)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_merge_views():
    import jax

    from wseg_tpu.engine.infer import _merge_views as jax_merge
    from wseg_tpu_torch.engine.infer import _merge_views

    r = np.random.RandomState(4)
    masks = r.rand(2, 2, 32, 48, 5).astype(np.float32)   # (S, V, ...)
    src = np.asarray([[[4, 6, 24, 36]] * 2, [[0, 0, 32, 40]] * 2],
                     np.float32)
    dst = np.asarray([[8, 12, 48, 72], [0, 0, 64, 80]], np.float32)
    flips = np.asarray([False, True])
    want = np.stack([np.asarray(jax.jit(jax_merge, static_argnums=(4, 5))(
        jnp.asarray(masks[s]), jnp.asarray(src[s]), jnp.asarray(dst[s]),
        jnp.asarray(flips), 64, 96)) for s in range(2)])
    got = _merge_views(torch.from_numpy(masks), torch.from_numpy(src),
                       torch.from_numpy(dst), torch.from_numpy(flips),
                       64, 96).numpy()
    assert got.shape == (2, 64, 96, 5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("wh", [(500, 375), (333, 500), (41, 57)])
def test_multiscale_view_geometry(wh):
    from PIL import Image

    from wseg_tpu.data.multiscale import MultiscaleViews as JaxViews
    from wseg_tpu_torch.data.multiscale import MultiscaleViews

    w, h = wh
    args = ([1.0, 0.5, 1.5, 2.0], True, (1024, 1024), True, 64)
    jv, pv = JaxViews(*args), MultiscaleViews(*args)
    assert pv.view_shapes(w, h) == jv.view_shapes(w, h)
    assert pv.view_windows(w, h) == jv.view_windows(w, h)
    img = (np.random.RandomState(5).rand(h, w, 3) * 255).astype(np.uint8)
    jc = jv.build_device(Image.fromarray(img), (512, 512))
    pc = pv.build_device(img, (512, 512))
    np.testing.assert_array_equal(pc[0], jc[0])
    assert tuple(pc[1]) == tuple(jc[1]) and pc[2:] == jc[2:]
