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
    # the library's own limit is no lower than the first kernel's (two
    # float32 planes and 512 bytes of tap tables a block)
    with torch.cuda.device(0):
        limit = pc._library().wseg_pamr_propagate_max_plane()
    assert limit == pc.MAX_PLANE >= (232448 - 512) // 8


def _model_fit(g, p, n, threads, smem):
    """Clusters an H100-like card holds at once: 8 GPCs of 16 SMs, CTAs
    an SM by the 228 KB of shared memory (1 KB each reserved) and by
    threads (the card's count comes from
    cudaOccupancyMaxActiveClusters)."""
    per_sm = min(233472 // (smem + 1024), 2048 // threads, 32)
    return 8 * (16 * per_sm // n)


# (b, c, h, w, dilations): the flagship, the lab's second shape, odd and
# small planes, one and two channels, 1 and 8 dilations, the largest plane
PLAN_SHAPES = [(8, 21, 48, 48, 6), (8, 21, 96, 96, 6), (3, 21, 29, 41, 6),
               (2, 20, 47, 53, 3), (1, 1, 48, 48, 6), (4, 2, 7, 9, 1),
               (1, 21, 170, 170, 6), (2, 5, 1, 300, 8), (1, 3, 2, 14528, 2)]


@pytest.mark.parametrize("b,c,h,w,n_dil", PLAN_SHAPES)
def test_propagate_plans_cover_the_tensor_once_within_limits(b, c, h, w,
                                                             n_dil):
    from wseg_tpu_torch.ops import pamr_cuda as pc

    plans = list(pc.propagate_candidates(b, c, h, w, n_dil, 10, _model_fit,
                                         132))
    assert plans
    for plan in plans:
        rows = [y for y0, y1 in plan.bands() for y in range(y0, y1)]
        assert rows == list(range(h))
        assert all(y1 > y0 for y0, y1 in plan.bands())
        chans = [k for c0, c1 in plan.channel_groups()
                 for k in range(c0, c1)]
        assert chans == list(range(c))
        assert plan.g in pc.GROUPS and plan.g <= c
        assert 1 <= plan.n <= min(h, pc.MAX_CLUSTER)
        assert plan.threads % 32 == 0 and plan.threads <= pc.MAX_THREADS
        band = max(y1 - y0 for y0, y1 in plan.bands()) * w
        # a thread takes the fewest pixels of the band it can
        assert -(-band // plan.threads) == -(-band // pc.MAX_THREADS)
        assert plan.smem_bytes() <= pc.SMEM_LIMIT
        # as many dilations' affinities staged as fit
        assert 0 <= plan.sdil <= n_dil
        assert plan.sdil == n_dil or (plan.smem_bytes() + 4 * 8 * band
                                      > pc.SMEM_LIMIT)
        assert plan.clusters == _model_fit(*plan.occupancy_args())
        assert 1 <= plan.p <= min(pc.MAX_PIXELS, -(-band // plan.threads))
    best = pc.propagate_plan(b, c, h, w, n_dil, 10, _model_fit, 132)
    assert best.cost == min(p.cost for p in plans)


def test_propagate_plan_refuses_what_no_launch_takes():
    from wseg_tpu_torch.ops import pamr_cuda as pc

    side = int(pc.MAX_PLANE ** 0.5) + 1
    with pytest.raises(ValueError, match="shared-memory limit"):
        pc.propagate_plan(1, 2, side, side, 6, 10, _model_fit, 132)
    with pytest.raises(ValueError, match="shared-memory limit"):
        pc.propagate_plan(1, 1, 1, pc.MAX_PLANE + 1, 1, 10, _model_fit, 132)
    # the largest plane fits at G = 1, nothing staged
    plan = pc.propagate_plan(1, 4, 1, pc.MAX_PLANE, 1, 10, _model_fit, 132)
    assert (plan.g, plan.sdil, plan.smem_bytes()) == (1, 0, pc.SMEM_LIMIT)
    with pytest.raises(ValueError, match="no propagation launch"):
        pc.propagate_plan(2, 21, 48, 48, 6, 10, lambda *a: 0, 132)
    with pytest.raises(ValueError):
        pc.propagate_plan(0, 21, 48, 48, 6, 10, _model_fit, 132)


def test_propagate_plan_picks_channel_groups_and_carveout():
    from wseg_tpu_torch.ops import pamr_cuda as pc

    # groups are the kernel's instances up to C; a last group short of G
    # runs with zero slots (21 = 8 + 8 + 5)
    gs = {p.g for p in pc.propagate_candidates(8, 21, 48, 48, 6, 10,
                                               _model_fit, 132)}
    assert gs == set(pc.GROUPS) == {1, 2, 3, 4, 8}
    gs = {p.g for p in pc.propagate_candidates(2, 5, 24, 24, 6, 10,
                                               _model_fit, 132)}
    assert gs == {1, 2, 3, 4}
    g8 = next(p for p in pc.propagate_candidates(8, 21, 48, 48, 6, 10,
                                                 _model_fit, 132)
              if p.g == 8)
    assert list(g8.channel_groups()) == [(0, 8), (8, 16), (16, 21)]
    # the flagship and the lab's second shape keep the plan the sweep
    # found fastest; each fits one SM's largest carveout (228 KB)
    plan = pc.propagate_plan(8, 21, 48, 48, 6, 10, _model_fit, 132)
    assert (plan.g, plan.n, plan.threads, plan.p, plan.sdil) == (
        3, 2, 576, 2, 4)
    assert plan.waves <= 1.0
    assert plan.smem_bytes() == 4 * (2 * 3 * 48 * 48 + 8 * 4 * 24 * 48)
    plan = pc.propagate_plan(8, 21, 96, 96, 6, 10, _model_fit, 132)
    assert (plan.g, plan.n, plan.threads, plan.p, plan.sdil) == (
        3, 2, 768, 2, 0)
    assert plan.smem_bytes() + 1024 <= 228 * 1024


def _explicit_plan(b, c, h, w, n_dil, g, n, sdil=0, p=1, threads=None):
    from wseg_tpu_torch.ops import pamr_cuda as pc

    band = -(-h // n) * w
    if threads is None:
        threads = min(pc.MAX_THREADS, -(-band // 32) * 32)
    return pc.PropagatePlan(b, c, h, w, n_dil, g, n, threads, p, sdil, 1,
                            132, 0.0)


def _launch(aff, m, dil, steps, plan):
    """Run the kernel with an explicit plan, counted as
    ``pamr_propagate_cm`` counts it."""
    import ctypes

    from wseg_tpu_torch.ops import pamr_cuda as pc

    ints = plan.host_ints()
    return pc._launch_propagate(aff, m, tuple(dil), steps,
                                (ctypes.c_int * len(ints))(*ints),
                                (ctypes.c_int * len(dil))(*dil))


# (b, c, h, w, dilations, steps, G, N): H not divisible by N, C not
# divisible by G (a last group of zero slots), C = 1 and 2, 1 and 8
# dilations, 0 and 1 steps, 16-CTA clusters, several pixels a thread and
# the largest plane (G = 1)
EDGE_CASES = [
    (2, 21, 47, 48, FLAGSHIP_DIL, 10, 8, 5),
    (2, 21, 48, 48, FLAGSHIP_DIL, 10, 8, 7),
    (1, 1, 33, 20, FLAGSHIP_DIL, 10, 1, 4),
    (2, 2, 29, 41, FLAGSHIP_DIL, 10, 2, 3),
    (3, 5, 24, 24, (1,), 10, 3, 2),
    (1, 6, 40, 36, (1, 2, 3, 5, 8, 13, 21, 34), 10, 4, 8),
    (2, 4, 30, 30, FLAGSHIP_DIL, 0, 4, 3),
    (2, 4, 30, 30, FLAGSHIP_DIL, 1, 4, 16),
    (1, 3, 170, 170, FLAGSHIP_DIL, 2, 1, 8),
    (1, 2, 96, 96, FLAGSHIP_DIL, 3, 2, 2),
    (1, 2, 1, 29056, (1, 2), 2, 1, 1),
]
# (b, c, h, w, dilations, steps, G, N, staged dilations, pixels a thread
# takes together, threads): some, all, and all of 8 dilations'
# affinities staged in shared memory; two pixels a thread, the band an
# odd multiple of the threads, and more than two passes
STAGED_CASES = [
    (2, 21, 47, 48, FLAGSHIP_DIL, 10, 3, 2, 4, 1, None),
    (2, 5, 29, 41, FLAGSHIP_DIL, 10, 4, 3, 6, 1, None),
    (1, 6, 40, 36, (1, 2, 3, 5, 8, 13, 21, 34), 10, 4, 8, 8, 1, None),
    (2, 21, 48, 48, FLAGSHIP_DIL, 10, 3, 2, 4, 2, 576),
    (2, 21, 48, 48, FLAGSHIP_DIL, 10, 8, 4, 0, 2, 96),
    (1, 3, 37, 29, FLAGSHIP_DIL, 3, 3, 1, 0, 2, 160),
    (1, 7, 45, 31, FLAGSHIP_DIL, 4, 4, 3, 2, 2, 128),
]


def _card_inputs(b, c, h, w, dil, seed):
    from wseg_tpu_torch.ops import pamr_cuda as pc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    im = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    m = torch.softmax(torch.randn((b, c, h, w), generator=gen,
                                  device="cuda") * 3, dim=1)
    return pc.pamr_affinity_cm(im, dil), m


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,dil,steps,g,n", EDGE_CASES)
def test_propagate_kernel_matches_plain_at_plan_edges(b, c, h, w, dil, steps,
                                                      g, n):
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    plan = _explicit_plan(b, c, h, w, len(dil), g, n)
    assert plan.smem_bytes() <= pc.SMEM_LIMIT
    aff, m = _card_inputs(b, c, h, w, dil, h * w + c)
    before = pc.pamr_propagate_cm.launches
    got = _launch(aff, m, dil, steps, plan)
    again = _launch(aff, m, dil, steps, plan)
    want = pc.pamr_propagate_cm_reference(aff, m, dil, steps)
    torch.cuda.synchronize()
    assert pc.pamr_propagate_cm.launches == before + 2
    assert torch.equal(got, again)
    # same float32 arithmetic in tap order; FMA contraction differs
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,dil,steps,g,n,sdil,p,threads",
                         STAGED_CASES)
def test_propagate_kernel_matches_plain_with_staged_affinities(
        b, c, h, w, dil, steps, g, n, sdil, p, threads):
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    plan = _explicit_plan(b, c, h, w, len(dil), g, n, sdil=sdil, p=p,
                          threads=threads)
    assert plan.smem_bytes() <= pc.SMEM_LIMIT
    aff, m = _card_inputs(b, c, h, w, dil, h * w + sdil)
    got = _launch(aff, m, dil, steps, plan)
    want = pc.pamr_propagate_cm_reference(aff, m, dil, steps)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.gpu
def test_propagate_kernel_takes_unaligned_tensors():
    """Contiguous views at a storage offset of one float, on a plane
    whose H * W is a multiple of 4: the mask's 16-byte staging copies
    must not be taken."""
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    b, c, h, w = 2, 5, 24, 24
    aff, m = _card_inputs(b, c, h, w, FLAGSHIP_DIL, 7)
    m1 = torch.empty(m.numel() + 1, device="cuda")[1:].view(b, c, h, w)
    a1 = torch.empty(aff.numel() + 1, device="cuda")[1:].view(aff.shape)
    m1.copy_(m)
    a1.copy_(aff)
    assert m1.is_contiguous() and m1.data_ptr() % 16 == 4
    got = pc.pamr_propagate_cm(a1, m1, FLAGSHIP_DIL, 10)
    want = pc.pamr_propagate_cm(aff, m, FLAGSHIP_DIL, 10)
    ref = pc.pamr_propagate_cm_reference(aff, m, FLAGSHIP_DIL, 10)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.gpu
def test_propagate_kernel_is_deterministic_and_counted():
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    aff, m = _card_inputs(8, 21, 48, 48, FLAGSHIP_DIL, 5)
    before = pc.pamr_propagate_cm.launches
    outs = [pc.pamr_propagate_cm(aff, m, FLAGSHIP_DIL, 10) for _ in range(2)]
    torch.cuda.synchronize()
    assert pc.pamr_propagate_cm.launches == before + 2
    assert torch.equal(outs[0], outs[1])
    plan = pc.propagate_plan_for(m, FLAGSHIP_DIL, 10)
    assert plan.clusters > 0 and plan.smem_bytes() <= pc.SMEM_LIMIT


@pytest.mark.gpu
def test_propagate_entry_refuses_plans_it_cannot_take():
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    aff = torch.rand(1, 48, 24, 24, device="cuda")
    m = torch.rand(1, 6, 24, 24, device="cuda")
    good = _explicit_plan(1, 6, 24, 24, 6, 4, 2)
    _launch(aff, m, FLAGSHIP_DIL, 1, good)
    for bad in (_explicit_plan(1, 6, 24, 24, 6, 8, 2),   # G > C
                _explicit_plan(1, 6, 24, 24, 6, 5, 2),   # no G 5 instance
                _explicit_plan(1, 6, 24, 24, 6, 4, 25),  # N > H
                _explicit_plan(1, 6, 24, 24, 6, 4, 17),  # N > 16
                good.__class__(**{**good.__dict__, "threads": 48}),
                # more staged dilations than the call has
                good.__class__(**{**good.__dict__, "sdil": 7}),
                good.__class__(**{**good.__dict__, "p": 3})):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _launch(aff, m, FLAGSHIP_DIL, 1, bad)


# ------------------------------------------------------ the affinity plan
# (b, h, w, dilations): the flagship, the lab's second shape, W of 1, 47,
# 129 and 29,056 (column tiles), 1 and 8 dilations, a dilation >= H, a
# plane whose window needs more than 48 KB of shared memory
AFFINITY_SHAPES = [(8, 48, 48, FLAGSHIP_DIL), (8, 96, 96, FLAGSHIP_DIL),
                   (1, 20, 1, (1,)), (1, 30, 47, (1, 2, 3)),
                   (2, 17, 129, (1, 2, 4, 8, 12, 24, 32, 40)),
                   (1, 5, 48, (3, 7)), (1, 1, 29056, (1, 2)),
                   (1, 170, 170, FLAGSHIP_DIL), (3, 29, 41, FLAGSHIP_DIL),
                   (64, 48, 48, FLAGSHIP_DIL)]


@pytest.mark.parametrize("b,h,w,dil", AFFINITY_SHAPES)
def test_affinity_plans_cover_each_pixel_once_within_limits(b, h, w, dil):
    from wseg_tpu_torch.ops import pamr_cuda as pc

    plan = pc.affinity_plan(b, h, w, dil)
    seen = np.zeros((h, w), np.int64)
    for y, x0, x1 in plan.tiles():
        assert 0 < x1 - x0 <= plan.cols
        seen[y, x0:x1] += 1
    assert (seen == 1).all()
    gx, gy, gb = plan.grid
    assert len(list(plan.tiles())) == gx * gy and gb == b <= 65535
    assert gy == h <= 65535 and plan.ctas == gx * gy * b
    # every pixel of a tile has its lanes; whole warps, within the limit
    assert plan.cols * pc.AFFINITY_LANES <= plan.threads
    assert plan.threads % 32 == 0
    assert plan.threads <= pc.AFFINITY_MAX_THREADS
    assert plan.threads - plan.cols * pc.AFFINITY_LANES < 32
    assert plan.smem_bytes() <= pc.SMEM_LIMIT
    assert plan.host_ints() == (plan.cols, plan.threads, plan.smem_bytes())


def test_affinity_plan_picks_lanes_and_tiles():
    from wseg_tpu_torch.ops import pamr_cuda as pc

    # the flagship: a CTA per image row, 4 lanes a pixel (384 CTAs of
    # 192 threads); the window is the whole 48x48 image (rows 24 above
    # and below)
    plan = pc.affinity_plan(8, 48, 48, FLAGSHIP_DIL)
    assert (plan.cols, plan.threads, plan.ctas) == (48, 192, 384)
    assert plan.smem_bytes() == 4 * (3 * 48 * 48 + 48 * 56)
    # (8, 96, 96): 49 rows of the window, 384 threads
    plan = pc.affinity_plan(8, 96, 96, FLAGSHIP_DIL)
    assert (plan.cols, plan.threads, plan.ctas) == (96, 384, 768)
    assert plan.smem_bytes() == 4 * (3 * 49 * 96 + 48 * 104)
    # a row wider than a CTA's 128 pixels: even column tiles
    plan = pc.affinity_plan(1, 3, 129, (1,))
    assert (plan.cols, plan.threads, plan.grid[0]) == (65, 288, 2)
    # a window too large at 128 columns takes narrower tiles
    plan = pc.affinity_plan(1, 170, 170, (1, 60))
    assert plan.grid[0] > 2 and plan.smem_bytes() <= pc.SMEM_LIMIT
    assert pc.affinity_smem(-(-170 // (plan.grid[0] - 1)), (1, 60), 170,
                            170) > pc.SMEM_LIMIT
    # a dilation beyond the plane clamps like max(h, w)
    assert pc.affinity_reach((1, 500), 20, 30) == 30
    assert (pc.affinity_smem(30, (1, 500), 20, 30)
            == pc.affinity_smem(30, (1, 30), 20, 30))


def test_affinity_plan_refuses_what_no_launch_takes():
    from wseg_tpu_torch.ops import pamr_cuda as pc

    # a 400-row reach over 400 columns: one column a CTA still stages
    # 400 x 400 x 3 floats
    with pytest.raises(ValueError, match="shared-memory limit"):
        pc.affinity_plan(1, 400, 400, (1, 400))
    with pytest.raises(ValueError):
        pc.affinity_plan(0, 48, 48, FLAGSHIP_DIL)
    with pytest.raises(ValueError):
        pc.affinity_plan(1, 65536, 4, (1,))
    with pytest.raises(ValueError):
        pc.affinity_plan(1, 48, 48, (0,))


def test_affinity_plan_takes_dilations_up_to_68_on_large_planes():
    """The limit its docstring states: one column's window of (1 + 2 r)^2
    pixels of three planes fits shared memory for a largest dilation r of
    68 with 8 dilations, not 69."""
    from wseg_tpu_torch.ops import pamr_cuda as pc

    dil = (1, 2, 4, 8, 12, 24, 32)
    plan = pc.affinity_plan(1, 200, 200, dil + (68,))
    assert plan.smem_bytes() <= pc.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared-memory limit"):
        pc.affinity_plan(1, 200, 200, dil + (69,))


def test_affinity_pitch_spreads_a_warps_stores_over_the_banks():
    """A warp's store of one round: lane l = group * 8 + pixel writes tap
    8 i + group + 4 u of tile pixel slot0 + pixel, at (tap) * pitch +
    slot; the 32 addresses fall in 32 banks."""
    from wseg_tpu_torch.ops import pamr_cuda as pc

    g = pc.AFFINITY_LANES
    lanes = 32 // g
    for px in range(1, 300):
        pitch = pc.affinity_pitch(px)
        assert pitch >= px and pitch % lanes == 0 and pitch % 4 == 0
        for slot0 in range(0, px, lanes):
            for i in range(8):
                for u in range(8 // g):
                    banks = {((8 * i + grp + g * u) * pitch + slot0 + k) % 32
                             for grp in range(g) for k in range(lanes)}
                    assert len(banks) == 32


# ------------------------------------------------ the affinity on the card
CARD_AFFINITY_SHAPES = [(1, 20, 1, (1,)), (8, 48, 48, FLAGSHIP_DIL),
                        (1, 30, 47, (1, 2, 3)),
                        (2, 17, 129, (1, 2, 4, 8, 12, 24, 32, 40)),
                        (1, 5, 48, (3, 7)), (8, 96, 96, FLAGSHIP_DIL),
                        (1, 1, 29056, (1, 2)), (1, 170, 170, FLAGSHIP_DIL)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,dil", CARD_AFFINITY_SHAPES)
def test_affinity_kernel_matches_plain_on_card(b, h, w, dil):
    """One to eight dilations, a largest dilation >= H, W of 1, 47, 48,
    129 and 29,056, B of 1, 2 and 8: within 1e-5 of the plain version,
    two runs bit-equal, one launch a call."""
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    gen = torch.Generator(device="cuda").manual_seed(h * w + len(dil))
    im = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    before = pc.pamr_affinity_cm.launches
    got = pc.pamr_affinity_cm(im, dil)
    again = pc.pamr_affinity_cm(im, dil)
    want = pc.pamr_affinity_cm_reference(im, dil)
    torch.cuda.synchronize()
    assert pc.pamr_affinity_cm.launches == before + 2
    assert got.shape == (b, 8 * len(dil), h, w)
    assert torch.equal(got, again)
    # same float32 arithmetic; sum order and FMA contraction differ
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_affinity_kernel_takes_unaligned_guides():
    """A contiguous guide at a storage offset of one float, W a multiple
    of 4 (whole rows of an aligned guide take the 16-byte copies): the
    4-byte copies give the same bits."""
    _card()
    from wseg_tpu_torch.ops import pamr_cuda as pc

    b, h, w = 2, 24, 48
    gen = torch.Generator(device="cuda").manual_seed(3)
    im = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    im1 = torch.empty(im.numel() + 1, device="cuda")[1:].view(im.shape)
    im1.copy_(im)
    assert im1.is_contiguous() and im1.data_ptr() % 16 == 4
    got = pc.pamr_affinity_cm(im1, FLAGSHIP_DIL)
    want = pc.pamr_affinity_cm(im, FLAGSHIP_DIL)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_affinity_entry_refuses_plans_it_cannot_take():
    """The C entry checks the plan: a launch for which it was not made
    fails with a CUDA error and is not counted."""
    _card()
    import ctypes

    from wseg_tpu_torch.ops import pamr_cuda as pc

    im = torch.rand(1, 3, 24, 24, device="cuda")
    dil = (1, 2)
    good = pc.affinity_plan(1, 24, 24, dil)
    dil_c = (ctypes.c_int * 2)(*dil)

    def launch(ints):
        return pc._launch_affinity(im, dil, (ctypes.c_int * 3)(*ints), dil_c)

    launch(good.host_ints())
    before = pc.pamr_affinity_cm.launches
    cols, threads, smem = good.host_ints()
    for bad in ((cols, threads, smem + 4),  # not this plan's smem
                (cols, 544, smem),          # above 512 threads
                (cols, threads - 1, smem),  # not whole warps
                (25, threads, smem),        # columns > W
                (0, threads, smem),         # no columns
                (cols, 32, smem)):          # fewer lanes than pixels
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(bad)
    assert pc.pamr_affinity_cm.launches == before
