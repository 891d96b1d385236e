"""The bilateral-message kernel's schedule on the CPU: the host plan
(row pitch, bands, channel groups, the shared-memory fit) and the
banded plain version, which runs the kernel's residue classes, bands and
per-output tap order, against the plain version and the JAX package's
Pallas kernel (interpret mode)."""

import numpy as np
import pytest
import torch

from wseg_tpu_torch.ops.crf import _bilateral_taps
from wseg_tpu_torch.ops import crf_bilateral
from wseg_tpu_torch.ops.crf_bilateral import (
    LIMITS,
    MAX_SLOTS,
    SMEM_LIMIT,
    band_plan,
    band_steps,
    bilateral_message_cm_banded_reference,
    bilateral_message_cm_reference,
)

# the fast CRF's negated 9x9 grid of pitch 20 (sxy 40 at stride 2)
GRID = tuple((-dy, -dx) for dy, dx in _bilateral_taps(40.0, 2.0))
OFF_GRID = ((-2, 3), (0, -1), (20, 0))  # the last falls outside at H 8
PITCH_ONE = tuple((dy, dx) for dy in range(-3, 4) for dx in (-2, 0, 5)
                  if (dy, dx) != (0, 0))
REPEATED = ((1, 1), (1, 1), (0, 0), (-3, 2), (1, 1), (2, -6))

CASES = [  # (shape, taps, row pitch)
    ((2, 3, 45, 53), GRID, 20),     # H not a multiple of the pitch
    ((1, 3, 8, 10), OFF_GRID, 2),
    ((2, 4, 37, 20), PITCH_ONE, 1),  # 37 class rows: four bands
    ((2, 1, 45, 53), GRID, 20),     # the norm filter's C = 1
    ((1, 2, 9, 7), REPEATED, 1),    # repeated taps chain in one cell
    ((1, 21, 24, 16), GRID, 20),    # three channel groups of 7
]


def _inputs(shape, taps, seed):
    rng = np.random.RandomState(seed)
    b, c, h, w = shape
    q = torch.from_numpy(rng.rand(b, c, h, w).astype(np.float32))
    wt = torch.from_numpy(rng.rand(b, len(taps), h, w).astype(
        np.float32)).to(torch.bfloat16)
    return q, wt


@pytest.mark.parametrize("shape,taps,pitch", CASES)
def test_banded_version_matches_plain(shape, taps, pitch):
    q, wt = _inputs(shape, taps, 0)
    got = bilateral_message_cm_banded_reference(q, wt, taps)
    want = bilateral_message_cm_reference(q, wt, taps)
    if taps == GRID:
        # (dy desc, dx desc) is the grid's own order: the same float sums
        assert torch.equal(got, want)
    else:
        # the same products, summed in the schedule's order
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("shape,taps,pitch", CASES)
def test_plan_covers_every_output_and_tap_once(shape, taps, pitch):
    _, c, h, w = shape
    plan = band_plan(taps, c, h, w)
    assert plan.pitch == pitch
    assert 1 <= plan.group <= min(c, 8) and 1 <= plan.rows <= 10
    assert plan.smem_bytes() <= SMEM_LIMIT
    assert plan.rows <= plan.kernel_rows in (2, 10)
    assert plan.chunk * plan.kernel_rows <= MAX_SLOTS
    # the bands of all classes cover every output row once, and stage
    # at most ``staged`` rows each
    rows = []
    for rho, j0, j1, i_lo, i_hi in plan.bands(h):
        rows += [rho + j * plan.pitch for j in range(j0, j1)]
        assert 0 < j1 - j0 <= plan.rows and i_hi - i_lo <= plan.staged
    assert sorted(rows) == list(range(h))
    # every (output row, tap) pair whose source row lies in the image is
    # visited once, reading q at y + dy from a staged row of its class
    steps = list(band_steps(plan, h))
    pairs = [(y, k) for y, k, _, _ in steps]
    assert len(pairs) == len(set(pairs))
    want = {(y, k) for y in range(h) for k, (dy, dx) in enumerate(taps)
            if 0 <= y + dy < h and abs(dx) < w}
    assert set(pairs) == want
    for y, k, yq, dx in steps:
        assert (yq - y, dx) == taps[k]


def test_plan_groups_channels_and_shortens_bands_for_one_channel():
    flagship = band_plan(GRID, 21, 192, 256)
    assert (flagship.pitch, flagship.group, flagship.rows,
            flagship.staged) == (20, 7, 10, 10)
    assert flagship.dx == (80, 60, 40, 20, 0, -20, -40, -60, -80)
    norm = band_plan(GRID, 1, 192, 256)
    assert (norm.group, norm.rows, norm.staged) == (1, 2, 10)
    assert (flagship.kernel_rows, norm.kernel_rows) == (10, 2)


def test_host_ints_carry_the_plans_geometry():
    """The C entry's Plan order: {P, dy_lo, ndy, ndx, dx_lo, dx_hi, J, JT,
    G, S, SW, D, L, qvec, wvec, smem}; the entry only checks them."""
    plan = band_plan(GRID, 21, 192, 256)
    ints = plan.host_ints(True, False)
    assert ints == (20, -4, 9, 9, -80, 80, 10, 10, 7, 10, plan.stride,
                    plan.chunk, 1, 1, 0, plan.smem_bytes())
    assert ints[-1] == 73960  # the shared memory the card runs report


def test_library_with_other_limits_is_refused(monkeypatch):
    """The wrapper holds a built kernel's limits against its own before
    it plans a launch: a library built from a changed source raises."""
    import ctypes

    class Lib:  # a built library: ctypes functions take attributes
        def __init__(self, limits):
            def write_limits(addr):
                out = ctypes.cast(addr, ctypes.POINTER(ctypes.c_int))
                for e, v in enumerate(limits):
                    out[e] = v
                return len(limits)

            self.limits = limits
            self.wseg_crf_bilateral_message = lambda *a: 0
            self.wseg_crf_bilateral_limits = write_limits

    build = crf_bilateral._library.__wrapped__
    monkeypatch.setattr(crf_bilateral._build, "load",
                        lambda name: Lib(LIMITS))
    assert build().limits == LIMITS
    changed = LIMITS[:4] + (LIMITS[4] + 2,) + LIMITS[5:]
    monkeypatch.setattr(crf_bilateral._build, "load",
                        lambda name: Lib(changed))
    with pytest.raises(RuntimeError, match="change both together"):
        build()


def test_plan_refuses_a_band_that_cannot_fit():
    # pitch 1 with a reach of 600 rows: 1,200 staged rows of one channel
    with pytest.raises(ValueError, match="does not fit"):
        band_plan(((-600, 0), (1, 0), (600, 0)), 1, 1200, 512)


def test_banded_version_matches_pallas():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.crf_pallas import bilateral_message_pallas_cm

    rng = np.random.RandomState(4)
    taps = [(int(rng.randint(-6, 7)), 2 * int(rng.randint(-4, 5)))
            for _ in range(8)]
    q = rng.rand(2, 5, 16, 24).astype(np.float32)
    w = torch.from_numpy(rng.rand(2, len(taps), 16, 24).astype(
        np.float32)).to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bilateral_message_pallas_cm(
            jnp.asarray(q), jnp.asarray(w.float().numpy()), taps))
    got = bilateral_message_cm_banded_reference(torch.from_numpy(q), w,
                                                taps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
