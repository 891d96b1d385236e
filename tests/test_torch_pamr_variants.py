"""The port's PAMR propagation variants (``wseg_tpu_torch/ops/
pamr_variants.py``) against the three TPU kernels of the JAX package's
kernel lab ``tools/bench_pamr.py``, run in Pallas interpret mode on the
CPU; their CPU dispatch and launch counters; and the port's lab
``python -m wseg_tpu_torch.bench_pamr`` on the CPU.

``tools/bench_pamr.py`` is not a package module, so it is loaded by
path.  Inputs are numpy-seeded; the JAX kernels fold ``block_b`` batch
items per grid step, the port's ``block_b`` channel planes per thread
block, and neither changes the result.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIL = (1, 2, 4)
SHAPE = (2, 20, 24, 3)      # (B, H, W, C)
STEPS = 3


def _lab():
    spec = importlib.util.spec_from_file_location(
        "bench_pamr_lab", os.path.join(REPO, "tools", "bench_pamr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed):
    rng = np.random.RandomState(seed)
    b, h, w, c = SHAPE
    logits = rng.randn(b, h, w, 8 * len(DIL)).astype(np.float32)
    aff = np.exp(logits - logits.max(-1, keepdims=True))
    aff /= aff.sum(-1, keepdims=True)
    m = rng.rand(b, h, w, c).astype(np.float32)
    return aff.astype(np.float32), (m / m.sum(-1, keepdims=True)).astype(
        np.float32)


def _jax_run(name, aff, mask, **kw):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(getattr(_lab(), name)(
            jnp.asarray(aff), jnp.asarray(mask), dilations=DIL,
            num_iter=STEPS, **kw))


def _port_run(name, aff, mask, **kw):
    from wseg_tpu_torch.ops import pamr_variants as pv

    return getattr(pv, name)(torch.from_numpy(aff), torch.from_numpy(mask),
                             DIL, STEPS, **kw).numpy()


@pytest.mark.parametrize("name,jax_kw,port_kw,tol", [
    # float32 planes: the same products summed in the same order
    ("propagate_fold", {"block_b": 2}, {"block_b": 2}, 1e-5),
    ("propagate_dxfirst", {"block_b": 1}, {"block_b": 1}, 1e-5),
    ("propagate_mxu", {"block_b": 2}, {"block_b": 2}, 1e-5),
    # bfloat16 planes: a step's rounding may fall one bf16 ulp apart,
    # 8e-3 is two ulps below 1
    ("propagate_fold", {"block_b": 2, "store_dtype": "bfloat16"},
     {"block_b": 2, "store_dtype": torch.bfloat16}, 8e-3),
])
def test_plain_variants_match_jax_lab(name, jax_kw, port_kw, tol):
    import jax
    import jax.numpy as jnp

    if "store_dtype" in jax_kw:
        jax_kw = dict(jax_kw, store_dtype=jnp.bfloat16)
    if name == "propagate_mxu":
        jax_kw = dict(jax_kw, precision=jax.lax.Precision.HIGHEST)
    aff, mask = _inputs(0)
    want = _jax_run(name, aff, mask, **jax_kw)
    got = _port_run(name, aff, mask, **port_kw)
    assert got.shape == want.shape == SHAPE
    err = float(np.abs(got - want).max())
    assert err <= tol, err
    # the steps moved the mask
    assert float(np.abs(got - mask).max()) > 1e-2


def test_mxu_default_precision_matches_jax_lab():
    """``precision="default"``: on the CPU, JAX's DEFAULT dot is float32,
    while the port follows the TPU's single bfloat16 pass (every shifted
    read rounded to bf16), so the two differ by bf16 rounding: <= 1e-2."""
    import jax

    aff, mask = _inputs(1)
    want = _jax_run("propagate_mxu", aff, mask, block_b=2,
                    precision=jax.lax.Precision.DEFAULT)
    got = _port_run("propagate_mxu", aff, mask, block_b=2,
                    precision="default")
    err = float(np.abs(got - want).max())
    assert 0 < err <= 1e-2, err


def test_cpu_tensors_take_the_plain_versions():
    from wseg_tpu_torch.ops import pamr_variants as pv

    aff, mask = _inputs(2)
    a = torch.from_numpy(aff).permute(0, 3, 1, 2).contiguous()
    m = torch.from_numpy(mask).permute(0, 3, 1, 2).contiguous()
    wrappers = (pv.propagate_fold_cm, pv.propagate_dxfirst_cm,
                pv.propagate_mxu_cm)
    before = [f.launches for f in wrappers]
    cases = [
        (pv.propagate_fold_cm, pv.propagate_fold_cm_reference,
         {"store_dtype": torch.bfloat16}),
        (pv.propagate_dxfirst_cm, pv.propagate_dxfirst_cm_reference, {}),
        (pv.propagate_mxu_cm, pv.propagate_mxu_cm_reference,
         {"precision": "default"}),
    ]
    for kernel, plain, kw in cases:
        got = kernel(a, m, DIL, STEPS, block_b=3, **kw)
        assert torch.equal(got, plain(a, m, DIL, STEPS, **kw))
    assert [f.launches for f in wrappers] == before  # no kernel on CPU
    # 0 steps is the identity; the NHWC entry is the channels-major one
    assert torch.equal(pv.propagate_fold_cm(a, m, DIL, 0), m)
    nhwc = pv.propagate_dxfirst(torch.from_numpy(aff),
                                torch.from_numpy(mask), DIL, STEPS)
    assert torch.equal(nhwc.permute(0, 3, 1, 2),
                       pv.propagate_dxfirst_cm_reference(a, m, DIL, STEPS))
    # the groupings the kernels are handed
    taps = [(-2, 1), (0, -1), (-2, -1), (3, 1)]
    assert pv._dy_groups(taps) == [(-2, [(0, 1), (2, -1)]), (0, [(1, -1)]),
                                   (3, [(3, 1)])]
    assert pv._order(pv._dx_groups(taps)) == [1, 2, 0, 3]
    plan, n_groups = pv._plan(taps, pv._dx_groups(taps))
    assert n_groups == 2 and list(plan) == [0, -1, 1, -2, -1, 2, -2, 1, 0,
                                            3, 1, 3, 0, 2, 4]


def test_wrappers_reject_bad_inputs():
    from wseg_tpu_torch.ops import pamr_variants as pv

    a = torch.rand(1, 16, 8, 8)
    m = torch.rand(1, 2, 8, 8)
    with pytest.raises(TypeError):
        pv.propagate_fold_cm(a, m, (1, 2), 2, store_dtype=torch.float16)
    with pytest.raises(ValueError):
        pv.propagate_mxu_cm(a, m, (1, 2), 2, precision="high")
    with pytest.raises(ValueError):
        pv.propagate_dxfirst_cm(a, m, (1, 2), 2, block_b=0)
    with pytest.raises(ValueError):
        pv.propagate_fold_cm(a, m, (1,), 2)          # 16 taps vs 8
    with pytest.raises(TypeError):
        pv.propagate_mxu_cm(a, m.double(), (1, 2), 2)


def test_lab_entry_point_on_cpu():
    """``python -m wseg_tpu_torch.bench_pamr --device cpu`` runs every
    row of the lab on the plain versions.  The baseline and plain rows
    are the reference itself (error 0); the float32 variants sum the
    same products in another order (<= 1e-5); bfloat16 planes and the
    single-pass bf16 reads stay within 1e-2."""
    from wseg_tpu_torch import bench_pamr

    rows = bench_pamr.main(["--device", "cpu", "--shape", "2,20,24,3",
                            "--iters", "2", "--reps", "1"])
    names = [r["name"] for r in rows]
    assert names == [name for name, *_ in bench_pamr.ROWS]
    for r in rows:
        assert r["launches"] == 0 and r["ms"] > 0 and r["chained_ms"] > 0
        if r["name"] in ("baseline", "plain", "aff_kernel", "aff_plain"):
            assert r["err"] == 0.0, r
        elif "bf16" in r["name"] or "default" in r["name"]:
            assert 0 < r["err"] <= 1e-2, r
        else:
            assert r["err"] <= 1e-5, r
