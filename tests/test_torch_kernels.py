"""The bilateral-message wrapper: CPU dispatch to the plain version, and
(marked ``gpu``) the CUDA kernel against it on the card; on the card
also the Gaussian-blur kernel and the three PAMR lab variants against
their plain versions.

Imports no JAX, so it also runs where JAX is missing:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch


def _bf16(rng, shape):
    return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
        torch.bfloat16)


def test_cpu_tensors_use_the_plain_version():
    from wseg_tpu_torch.ops.crf_bilateral import (
        bilateral_message_cm,
        bilateral_message_cm_reference,
    )

    rng = np.random.RandomState(1)
    taps = [(-2, 3), (0, -1), (20, 0)]  # the last falls outside entirely
    q = torch.from_numpy(rng.rand(1, 3, 8, 10).astype(np.float32))
    w = _bf16(rng, (1, 3, 8, 10))
    before = bilateral_message_cm.launches
    got = bilateral_message_cm(q, w, taps)
    assert bilateral_message_cm.launches == before  # no kernel on CPU
    assert torch.equal(got, bilateral_message_cm_reference(q, w, taps))
    # the plain version is the zero-filled shifted sum, tap by tap
    want = np.zeros((1, 3, 8, 10), np.float32)
    qn, wn = q.numpy(), w.float().numpy()
    for k, (dy, dx) in enumerate(taps):
        for y in range(8):
            for x in range(10):
                if 0 <= y + dy < 8 and 0 <= x + dx < 10:
                    want[0, :, y, x] += wn[0, k, y, x] * qn[0, :, y + dy,
                                                            x + dx]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_bad_inputs():
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm

    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.rand(1, 3, 8, 10).astype(np.float32))
    w = _bf16(rng, (1, 2, 8, 10))
    with pytest.raises(TypeError):
        bilateral_message_cm(q, w.float(), [(0, 1), (1, 0)])
    with pytest.raises(TypeError):
        bilateral_message_cm(q.double(), w, [(0, 1), (1, 0)])
    with pytest.raises(ValueError):
        bilateral_message_cm(q, w, [(0, 1)])
    with pytest.raises(ValueError):
        bilateral_message_cm(q[0], w, [(0, 1), (1, 0)])


# taps off the fast CRF's grids: row pitch 2 (one tap outside the
# image), row pitch 1 (61 class rows: seven bands), repeated taps
OFF_GRID = ((-2, 3), (0, -1), (20, 0), (-14, -7))
PITCH_ONE = tuple((dy, dx) for dy in range(-3, 4) for dx in (-2, 0, 5)
                  if (dy, dx) != (0, 0))
REPEATED = ((1, 1), (1, 1), (0, 0), (-3, 2), (1, 1), (2, -6))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,sxy,taps", [
    ((3, 21, 37, 53), 8.0, None),
    ((2, 1, 96, 128), 40.0, None),
    ((8, 21, 192, 256), 40.0, None),
    ((8, 1, 192, 256), 40.0, None),      # the norm filter
    ((2, 5, 40, 60), None, OFF_GRID),
    ((2, 7, 61, 130), None, PITCH_ONE),  # row tiling, W % 4 = 2
    ((2, 21, 50, 202), 40.0, None),      # W % 4 = 2
    ((1, 3, 20, 24), None, REPEATED)])
def test_kernel_matches_plain_on_card(shape, sxy, taps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wseg_tpu_torch.ops.crf import _bilateral_taps
    from wseg_tpu_torch.ops.crf_bilateral import (
        bilateral_message_cm,
        bilateral_message_cm_reference,
    )

    b, c, h, w = shape
    if taps is None:
        taps = [(-dy, -dx) for dy, dx in _bilateral_taps(sxy, 2.0)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.rand((b, c, h, w), generator=gen, device="cuda")
    wt = torch.rand((b, len(taps), h, w), generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = bilateral_message_cm.launches
    got = bilateral_message_cm(q, wt, taps)
    torch.cuda.synchronize()
    assert bilateral_message_cm.launches == before + 1
    want = bilateral_message_cm_reference(q, wt, taps)
    # same bf16 weights and f32 products; only the sum order differs
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
def test_kernel_refuses_a_band_that_does_not_fit():
    """Row pitch 1 with a 600-row reach: one channel's band is 1,200
    staged rows, over the shared memory of a block.  The wrapper raises
    and launches nothing; there is no other path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm

    taps = [(-600, 0), (1, 0), (600, 0)]
    q = torch.rand((1, 1, 1200, 512), device="cuda")
    wt = torch.rand((1, 3, 1200, 512), device="cuda").to(torch.bfloat16)
    before = bilateral_message_cm.launches
    with pytest.raises(ValueError, match="does not fit"):
        bilateral_message_cm(q, wt, taps)
    assert bilateral_message_cm.launches == before


@pytest.mark.gpu
def test_postprocess_launches_twelve_kernels_on_card():
    """One fast-CRF postprocess call (coarse stage: norm + 9 iterations,
    refine stage: norm + 1) is 12 launches of each of the bilateral and
    the Gaussian kernel, and its label maps match the same call on the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm
    from wseg_tpu_torch.ops.crf_gauss import gauss_blur_cm

    rng = np.random.RandomState(3)
    s, h, w, c = 2, 96, 128, 21
    sums = torch.from_numpy(rng.rand(s, h, w, c).astype(np.float32) * 8)
    labels = np.zeros((s, c - 1), np.float32)
    labels[:, [3, 7]] = 1
    windows = np.asarray([[0, 0, 90, 120], [4, 8, 80, 100]], np.int32)
    imgs = torch.from_numpy((rng.rand(s, h, w, 3) * 255).astype(np.uint8))
    pp = make_device_postprocess((0.0,), (0.0,), crf_iters=10,
                                 crf_dtype="float32", crf_stride=2,
                                 crf_full_stride=2, crf_refine_iters=1)
    before = (bilateral_message_cm.launches, gauss_blur_cm.launches)
    on_card = pp.dispatch_group(sums.cuda(), labels, windows, imgs.cuda(),
                                8).cpu()
    assert (bilateral_message_cm.launches,
            gauss_blur_cm.launches) == (before[0] + 12, before[1] + 12)
    on_cpu = pp.dispatch_group(sums, labels, windows, imgs, 8)
    assert float((on_card == on_cpu).float().mean()) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape,r", [((2, 1, 16, 24), 3),
                                     ((2, 5, 20, 28), 6),
                                     ((1, 3, 5, 9), 6),
                                     ((2, 3, 19, 30), 3),    # W % 4 = 2
                                     ((2, 2, 13, 10), 0),
                                     ((1, 2, 40, 70), 16),
                                     ((3, 4, 50, 20), 6),    # one band
                                     ((8, 21, 192, 256), 3),
                                     ((8, 21, 384, 512), 6),
                                     ((8, 1, 384, 512), 6),
                                     ((8, 1, 192, 256), 3)])
def test_gauss_kernel_matches_plain_on_card(shape, r, masked):
    """One launch per call, the mask multiply inside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import math

    from wseg_tpu_torch.ops.crf_gauss import (
        gauss_blur_cm,
        gauss_blur_cm_reference,
    )

    sxy = max(r / 2.0, 0.5)
    k1d = [math.exp(-i * i / (2.0 * sxy ** 2)) for i in range(-r, r + 1)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(shape, generator=gen, device="cuda")
    mask = None
    if masked:
        b, _, h, w = shape
        mask = (torch.rand((b, 1, h, w), generator=gen, device="cuda")
                > 0.3).float()
    before = gauss_blur_cm.launches
    got = gauss_blur_cm(x, k1d, r, mask=mask)
    torch.cuda.synchronize()
    assert gauss_blur_cm.launches == before + 1
    want = gauss_blur_cm_reference(x, k1d, r, mask)
    # same taps and order; only FMA contraction differs
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
def test_gauss_kernel_refuses_what_it_cannot_run():
    """A radius over the kernel's and a mask of another shape raise and
    launch nothing; there is no other path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wseg_tpu_torch.ops.crf_gauss import MAX_R, gauss_blur_cm

    x = torch.rand((1, 2, 40, 64), device="cuda")
    before = gauss_blur_cm.launches
    with pytest.raises(ValueError, match="radius"):
        gauss_blur_cm(x, [1.0] * (2 * MAX_R + 3), MAX_R + 1)
    with pytest.raises(ValueError, match="mask"):
        gauss_blur_cm(x, [1.0, 2.0, 1.0], 1,
                      mask=torch.ones((1, 2, 40, 64), device="cuda"))
    with pytest.raises(ValueError, match="mask on"):
        gauss_blur_cm(x, [1.0, 2.0, 1.0], 1, mask=torch.ones((1, 1, 40, 64)))
    assert gauss_blur_cm.launches == before


VARIANTS = [("propagate_fold_cm", {"block_b": 4}, 1e-5),
            ("propagate_fold_cm", {"block_b": 4,
                                   "store_dtype": torch.bfloat16}, None),
            ("propagate_dxfirst_cm", {"block_b": 1}, 1e-5),
            ("propagate_dxfirst_cm", {"block_b": 3,
                                      "store_dtype": torch.bfloat16}, None),
            ("propagate_mxu_cm", {"block_b": 2, "precision": "highest"}, 1e-5),
            ("propagate_mxu_cm", {"block_b": 2, "precision": "default"}, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw,rel", VARIANTS)
@pytest.mark.parametrize("b,h,w,c,dil", [(2, 20, 24, 3, (1, 2, 4)),
                                         (8, 48, 48, 21,
                                          (1, 2, 4, 8, 12, 24))])
def test_pamr_variant_matches_plain_on_card(name, kw, rel, b, h, w, c, dil):
    """float32 variants within 1e-5 relative (sum order and FMA);
    bfloat16 planes and single-pass bf16 reads within 1e-2 absolute (a
    step's rounding may fall one bf16 ulp apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import pamr_variants as pv

    gen = torch.Generator(device="cuda").manual_seed(1)
    aff = torch.softmax(torch.randn((b, 8 * len(dil), h, w), generator=gen,
                                    device="cuda"), dim=1)
    m = torch.softmax(torch.randn((b, c, h, w), generator=gen,
                                  device="cuda") * 3, dim=1)
    kernel = getattr(pv, name)
    plain = getattr(pv, name + "_reference")
    before = kernel.launches
    got = kernel(aff, m, dil, 10, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(aff, m, dil, 10,
                 **{k: v for k, v in kw.items() if k != "block_b"})
    err = float((got - want).abs().max())
    if rel is None:
        assert err <= 1e-2, err
    else:
        assert err <= rel * float(want.abs().max()), err


@pytest.mark.gpu
def test_pamr_variants_refuse_shapes_above_their_limits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import pamr_variants as pv

    aff = torch.zeros(1, 8, 100, 100, device="cuda")
    m = torch.zeros(1, 2, 100, 100, device="cuda")
    with pytest.raises(ValueError, match="pixels"):
        pv.propagate_fold_cm(aff, m, (1,), 1)
    with pytest.raises(ValueError, match="block_b 5"):
        pv.propagate_dxfirst_cm(aff[:, :, :8, :8].contiguous(),
                                m[:, :, :8, :8].contiguous(), (1,), 1,
                                block_b=5)
    with pytest.raises(ValueError, match="output tiles"):
        pv.propagate_mxu_cm(aff, m, (1,), 1, block_b=4)
