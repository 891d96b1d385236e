"""Port PAMR (``wseg_tpu_torch/ops/pamr.py``, ``ops/pamr_cuda.py``) vs
the JAX package's lax path and its Pallas kernels in interpret mode
(as tests/test_pamr_pallas.py runs them), on numpy-seeded inputs; and,
marked ``gpu``, the CUDA kernels against their plain versions.

JAX is imported inside the parity tests only, so the card tests run
where JAX is missing:
``python -m pytest tests/test_torch_pamr.py -m gpu --noconftest``.

Tolerances: the plain port and the JAX lax path do the same float32
arithmetic in the same tap order, so they agree to ~1e-7 on the
affinities and ~5e-6 after 10 propagation steps; the Pallas affinity
takes a one-pass variance (E[x^2] - E[x]^2) where the port takes the
lax path's two-pass one, within 1e-5 on the softmax affinities here.
"""

import numpy as np
import pytest
import torch

FLAGSHIP_DIL = (1, 2, 4, 8, 12, 24)
# (B, H, W): the flagship's 384 crop at stride 8, and an odd non-square
SHAPES = [(2, 48, 48), (1, 29, 41)]


def _inputs(seed, b, h, w, c=21):
    rng = np.random.RandomState(seed)
    im = rng.rand(b, h, w, 3).astype(np.float32)
    logits = rng.randn(b, h, w, c).astype(np.float32) * 3
    mask = np.exp(logits - logits.max(-1, keepdims=True))
    return im, (mask / mask.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_affinity_matches_jax_lax_and_pallas(shape):
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.pamr import pamr_affinity as jax_affinity
    from wseg_tpu.ops.pamr_pallas import pamr_affinity_pallas
    from wseg_tpu_torch.ops.pamr import pamr_affinity

    im, _ = _inputs(0, *shape)
    got = pamr_affinity(torch.from_numpy(im), FLAGSHIP_DIL).numpy()
    assert got.shape == shape + (48,)
    want = np.asarray(jax_affinity(im, FLAGSHIP_DIL))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(pamr_affinity_pallas(im, FLAGSHIP_DIL))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_propagate_matches_jax_lax_and_pallas(shape):
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.pamr import pamr_affinity as jax_affinity
    from wseg_tpu.ops.pamr import pamr_propagate as jax_propagate
    from wseg_tpu.ops.pamr_pallas import pamr_propagate_pallas
    from wseg_tpu_torch.ops.pamr import pamr_propagate

    im, mask = _inputs(1, *shape)
    aff = np.array(jax_affinity(im, FLAGSHIP_DIL))
    got = pamr_propagate(torch.from_numpy(aff), torch.from_numpy(mask),
                         FLAGSHIP_DIL, 10).numpy()
    want = np.asarray(jax_propagate(aff, mask, FLAGSHIP_DIL, 10))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(pamr_propagate_pallas(aff, mask, FLAGSHIP_DIL,
                                                  10))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "lax"])
def test_pamr_matches_jax(impl):
    """Full PAMR: guide resized (align_corners) from the crop to the
    mask size, affinity, 10 steps; both port impls take the plain
    versions on CPU tensors."""
    from wseg_tpu.ops.pamr import pamr as jax_pamr
    from wseg_tpu_torch.ops.pamr import pamr

    rng = np.random.RandomState(2)
    im = rng.rand(2, 96, 80, 3).astype(np.float32)
    _, mask = _inputs(3, 2, 12, 10)
    got = pamr(torch.from_numpy(im), torch.from_numpy(mask), FLAGSHIP_DIL,
               10, impl=impl).numpy()
    want = np.asarray(jax_pamr(im, mask, FLAGSHIP_DIL, 10, impl="lax"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    from wseg_tpu_torch.ops import pamr_cuda as pc

    im, mask = _inputs(4, 1, 20, 24)
    im_cm = torch.from_numpy(im).permute(0, 3, 1, 2).contiguous()
    m_cm = torch.from_numpy(mask).permute(0, 3, 1, 2).contiguous()
    before = (pc.pamr_affinity_cm.launches, pc.pamr_propagate_cm.launches)
    aff = pc.pamr_affinity_cm(im_cm, (1, 3))
    out = pc.pamr_propagate_cm(aff, m_cm, (1, 3), 4)
    assert (pc.pamr_affinity_cm.launches,
            pc.pamr_propagate_cm.launches) == before
    assert torch.equal(aff, pc.pamr_affinity_cm_reference(im_cm, (1, 3)))
    assert torch.equal(out, pc.pamr_propagate_cm_reference(aff, m_cm,
                                                           (1, 3), 4))
    # affinities are a softmax over the 16 taps; 0 steps is the identity
    np.testing.assert_allclose(aff.sum(1).numpy(), 1.0, atol=1e-6)
    assert torch.equal(pc.pamr_propagate_cm(aff, m_cm, (1, 3), 0), m_cm)
    assert pc.pamr_taps((1, 3))[:3] == [(-1, -1), (-1, 0), (-1, 1)]


def test_wrappers_reject_bad_inputs():
    from wseg_tpu_torch.ops import pamr_cuda as pc

    im = torch.rand(1, 3, 8, 8)
    aff = torch.rand(1, 16, 8, 8)
    m = torch.rand(1, 2, 8, 8)
    with pytest.raises(TypeError):
        pc.pamr_affinity_cm(im.double(), (1,))
    with pytest.raises(ValueError):
        pc.pamr_affinity_cm(im[0], (1,))
    with pytest.raises(ValueError):
        pc.pamr_affinity_cm(im, (0,))
    with pytest.raises(ValueError):
        pc.pamr_propagate_cm(aff, m, (1,), 2)       # 16 taps vs 8
    with pytest.raises(TypeError):
        pc.pamr_propagate_cm(aff, m.double(), (1, 2), 2)
    with pytest.raises(ValueError):
        pc.pamr_propagate_cm(aff, m, (1, 2), -1)
    with pytest.raises(ValueError):
        from wseg_tpu_torch.ops.pamr import pamr
        pamr(torch.rand(1, 8, 8, 3), torch.rand(1, 8, 8, 2), impl="xla")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,dil", [(8, 48, 48, FLAGSHIP_DIL),
                                       (3, 29, 41, FLAGSHIP_DIL),
                                       (2, 96, 96, (1, 2, 4)),
                                       (1, 170, 170, FLAGSHIP_DIL)])
def test_kernels_match_plain_on_card(b, h, w, dil):
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    gen = torch.Generator(device="cuda").manual_seed(0)
    im = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    m = torch.softmax(torch.randn((b, 21, h, w), generator=gen,
                                  device="cuda") * 3, dim=1)
    before = (pc.pamr_affinity_cm.launches, pc.pamr_propagate_cm.launches)
    aff = pc.pamr_affinity_cm(im, dil)
    out = pc.pamr_propagate_cm(aff, m, dil, 10)
    torch.cuda.synchronize()
    assert (pc.pamr_affinity_cm.launches,
            pc.pamr_propagate_cm.launches) == (before[0] + 1, before[1] + 1)
    aff_ref = pc.pamr_affinity_cm_reference(im, dil)
    out_ref = pc.pamr_propagate_cm_reference(aff_ref, m, dil, 10)
    # same float32 arithmetic; sum order and FMA contraction differ
    assert float((aff - aff_ref).abs().max()) <= 1e-5
    assert float((out - out_ref).abs().max()) <= 1e-5 * float(
        out_ref.abs().max())


@pytest.mark.gpu
def test_pamr_refuses_plain_versions_on_card():
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc
    from wseg_tpu_torch.ops.pamr import pamr

    im = torch.rand(1, 16, 16, 3, device="cuda")
    m = torch.rand(1, 8, 8, 2, device="cuda")
    before = (pc.pamr_affinity_cm.launches, pc.pamr_propagate_cm.launches)
    with pytest.raises(ValueError, match="CPU tensors only"):
        pamr(im, m, (1, 2), 2, impl="lax")
    pamr(im, m, (1, 2), 2, impl="auto")
    assert (pc.pamr_affinity_cm.launches,
            pc.pamr_propagate_cm.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_propagate_kernel_refuses_planes_above_shared_memory():
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    aff = torch.zeros(1, 48, 200, 200, device="cuda")
    m = torch.zeros(1, 2, 200, 200, device="cuda")
    with pytest.raises(ValueError, match="shared-memory limit"):
        pc.pamr_propagate_cm(aff, m, FLAGSHIP_DIL, 1)
