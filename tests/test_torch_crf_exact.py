"""The exact permutohedral CRF of the port against the JAX package.

Host tables against ``wseg_tpu.ops.crf_native``; the plain filter
against the native filter and ``wseg_tpu.ops.crf_lattice.lattice_filter``;
``ExactCRF`` against ``crf_inference_lattice`` (the f32 XLA oracle of
the Pallas path, no interpret mode) and the native mean field; the
exact-mode ``MultiScaleServer`` against ``crf_inference_lattice`` on the
JAX server's merged maps; the kernel wrappers' CPU dispatch and their
refusal to fall back.  The ``gpu`` cases hold the CUDA kernels against
the plain versions on the card; JAX is imported inside the CPU cases
only, so ``python -m pytest tests/test_torch_crf_exact.py -m gpu
--noconftest`` runs there.
"""

import os

import numpy as np
import pytest
import torch

THRESHS = (0.0, 0.1)


def _smooth(rng, h, w):
    """Low-frequency RGB image (photo-like lattice occupancy)."""
    low = torch.from_numpy(rng.rand(3, max(h // 12, 2), max(w // 12, 2)))
    img = torch.nn.functional.interpolate(low[None], size=(h, w),
                                          mode="bilinear",
                                          align_corners=False)[0]
    return (img.permute(1, 2, 0).numpy() * 255).astype(np.uint8)


def _probs(rng, h, w, c=21):
    p = rng.rand(h, w, c).astype(np.float32) + 0.05
    return p / p.sum(-1, keepdims=True)


def _pred(q, t):
    fgm = np.where(q[..., 1:] < t, 0.0, q[..., 1:])
    return np.argmax(np.concatenate([q[..., :1], fgm], -1), -1)


def _features(kind, img):
    from wseg_tpu_torch.ops.crf_lattice import (
        bilateral_features,
        gaussian_features,
    )
    if kind == "bilateral":
        return bilateral_features(img, 80.0, 13.0)
    return gaussian_features(img.shape[:2], 3.0)


@pytest.mark.parametrize("kind", ["bilateral", "gaussian"])
def test_tables_match_the_jax_native_build(kind):
    """Same offsets and blur neighbours, barycentric weights within 1e-6
    (one float32 rounding: FMA contraction may differ); the CSR is the
    exact transpose of the offsets table, also for a window embedded in
    a larger canvas."""
    from wseg_tpu.ops import crf_native as jax_native
    from wseg_tpu_torch.ops import crf_native

    img = _smooth(np.random.RandomState(0), 40, 48)
    feats = _features(kind, img)
    off, bary, nbr, _, _, _, m = crf_native.build_lattice_tables(feats)
    j_off, j_bary, j_nbr, j_m = jax_native.build_lattice_tables(feats)
    assert m == j_m
    np.testing.assert_array_equal(off, j_off)
    np.testing.assert_array_equal(nbr, j_nbr)
    np.testing.assert_allclose(bary, j_bary, rtol=0, atol=1e-6)

    d1 = off.shape[1]
    pixel_of_row = (np.arange(40)[:, None] * 64 + 8
                    + np.arange(48)[None, :]).reshape(-1)  # 40x48 at (0, 8)
    for pix in (None, pixel_of_row):
        lat = crf_native.build_lattice_tables(feats, pix)
        pix = np.arange(40 * 48) if pix is None else pix
        rows = np.repeat(np.arange(m), np.diff(lat.row_ptr))
        n, slot = np.divmod(np.arange(off.size), d1)
        want = np.lexsort((pix[n] * d1 + slot, off.reshape(-1)))
        np.testing.assert_array_equal(lat.entries,
                                      (pix[n] * d1 + slot)[want])
        np.testing.assert_array_equal(rows, off.reshape(-1)[want])
        np.testing.assert_array_equal(lat.w_csr, bary.reshape(-1)[want])


@pytest.mark.parametrize("d", [2, 5])
def test_plain_filter_matches_native_and_jax(d):
    """The port's filter on a padded canvas (valid mask) equals the
    native filter (the JAX package's and the port's C++ copy) and the JAX
    XLA filter on the real pixels within 1e-5 relative; padded pixels
    get exactly 0."""
    import jax.numpy as jnp

    from wseg_tpu.ops import crf_native as jax_native
    from wseg_tpu.ops.crf_lattice import build_tables_host
    from wseg_tpu.ops.crf_lattice import lattice_filter as jax_filter
    from wseg_tpu_torch.ops import crf_native
    from wseg_tpu_torch.ops.crf_exact import build_exact_lattice
    from wseg_tpu_torch.ops.crf_lattice import lattice_filter

    rng = np.random.RandomState(d)
    n_pix, c = 900, 5
    valid = np.zeros(n_pix, bool)
    valid[rng.choice(n_pix, 700, replace=False)] = True
    feats = (rng.rand(700, d) * 6.0).astype(np.float32)
    vals = rng.randn(700, c).astype(np.float32)
    canvas = np.full((n_pix, c), 7.0, np.float32)
    canvas[valid] = vals

    tables = build_exact_lattice(feats, n_pix, valid)
    got = lattice_filter(torch.from_numpy(canvas), tables).numpy()
    assert (got[~valid] == 0).all()
    want_native = jax_native.permutohedral_filter(feats, vals)
    want_jax = np.asarray(jax_filter(jnp.asarray(vals), build_tables_host(
        feats, quantum=256)))
    want_port = crf_native.permutohedral_filter(feats, vals)
    for want in (want_native, want_jax, want_port):
        err = np.abs(got[valid] - want).max() / np.abs(want).max()
        assert err <= 1e-5, err


@pytest.mark.parametrize("t", [3, 10])
def test_exact_crf_matches_the_lattice_oracle(t):
    """ExactCRF build + run on a 64x64 canvas with the window (8, 8, 40,
    48) against ``crf_inference_lattice`` on the window: max |dQ| <=
    1e-4 and >= 99.5% equal labels; against the native mean field, < 1%
    of labels differ (the JAX package's own bound)."""
    import jax.numpy as jnp

    from wseg_tpu.ops import crf_native as jax_native
    from wseg_tpu.ops.crf_lattice import (
        bilateral_features,
        build_tables_host,
        crf_inference_lattice,
        gaussian_tables,
    )
    from wseg_tpu_torch.engine.infer import ExactCRF

    rng = np.random.RandomState(t)
    h, w, hc, wc, pt, pl = 40, 48, 64, 64, 8, 8
    img = _smooth(rng, h, w)
    probs = _probs(rng, h, w)
    canvas = np.full((hc, wc, 21), 0.3, np.float32)
    canvas[pt:pt + h, pl:pl + w] = probs

    ex = ExactCRF(THRESHS, crf_iters=t)
    tables = ex.build(img, (hc, wc), (pt, pl, h, w))
    merged = torch.from_numpy(canvas)
    q = ex.q(tables, merged).numpy()
    labels = ex.run(tables, merged).numpy()
    assert np.isfinite(q).all()
    q = q[pt:pt + h, pl:pl + w]
    for k, th in enumerate(THRESHS):
        np.testing.assert_array_equal(labels[k, pt:pt + h, pl:pl + w],
                                      _pred(q, th))

    want = np.asarray(crf_inference_lattice(
        jnp.asarray(probs), gaussian_tables((h, w), 3.0),
        build_tables_host(bilateral_features(img, 80.0, 13.0),
                          quantum=1024), t=t))
    assert np.abs(q - want).max() <= 1e-4
    assert (q.argmax(-1) == want.argmax(-1)).mean() >= 0.995
    native = jax_native.crf_inference_native(img, probs, t=t)
    for th in THRESHS:
        assert (_pred(q, th) != _pred(native, th)).mean() < 0.01


def test_exact_server_matches_jax_merged_maps_through_the_oracle():
    """The port's server in exact mode (tiny flagship, float32) against
    ``crf_inference_lattice`` run on the JAX server's merged maps for the
    same weights and images: >= 99% equal ``pred_crf`` labels."""
    import jax.numpy as jnp
    from PIL import Image

    from tests.torch_parity import (
        jax_model_and_random_variables,
        port_model_from_jax,
    )
    from wseg_tpu.config import cfg as jcfg
    from wseg_tpu.engine.serving import MultiScaleServer as JaxServer
    from wseg_tpu.ops.crf_lattice import (
        bilateral_features,
        build_tables_host,
        crf_inference_lattice,
        gaussian_tables,
    )
    from wseg_tpu_torch.config import cfg as pcfg
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving import MultiScaleServer

    jmodel, variables = jax_model_and_random_variables(seed=7, size=32)
    rng = np.random.RandomState(12)
    sizes = [(40, 56), (56, 40)]
    images = [_smooth(rng, h, w) for h, w in sizes]
    labels = [np.zeros(20, np.float32) for _ in sizes]
    for lb in labels:
        lb[rng.choice(20, size=2, replace=False)] = 1.0

    def apply(test_cfg):
        test_cfg.SCALES = [1.0, 0.5]
        test_cfg.FLIP = True
        test_cfg.PAD_SIZE = [64, 64]
        test_cfg.PAD_ALIGN = 32
        test_cfg.USE_GT_LABELS = True

    def serve(server, imgs):
        try:
            futs = [server.submit(im, lb) for im, lb in zip(imgs, labels)]
            return [f.result(timeout=600) for f in futs]
        finally:
            server.close()

    apply(jcfg.TEST)
    merged = serve(JaxServer(jmodel, variables, jcfg.TEST, max_batch=4),
                   [Image.fromarray(im) for im in images])
    reset_cfg()
    try:
        apply(pcfg.TEST)
        pp = make_device_postprocess(THRESHS, THRESHS, crf_iters=10,
                                     bg_pow=3.0, crf_mode="exact")
        assert pp.exact is not None
        got = serve(MultiScaleServer(port_model_from_jax(variables),
                                     pcfg.TEST, max_batch=4,
                                     postprocess=pp), images)
    finally:
        reset_cfg()

    for img, (jmerged, _), (res, lab) in zip(images, merged, got):
        h, w = img.shape[:2]
        q = np.asarray(crf_inference_lattice(
            jnp.asarray(np.asarray(jmerged, np.float32)),
            gaussian_tables((h, w), 3.0),
            build_tables_host(bilateral_features(img, 80.0, 13.0),
                              quantum=1024), t=10))
        for th in THRESHS:
            a = res[th]["pred_crf"]
            assert a.dtype == np.uint8 and a.shape == (h, w)
            agree = (a == _pred(q, th)).mean()
            assert agree >= 0.99, (th, agree)
            assert res[th]["pred"].shape == (h, w)


def _tiny_tables(seed=0, d=5, n_pix=300, n_real=240):
    from wseg_tpu_torch.ops.crf_exact import build_exact_lattice

    rng = np.random.RandomState(seed)
    valid = np.zeros(n_pix, bool)
    valid[rng.choice(n_pix, n_real, replace=False)] = True
    feats = (rng.rand(n_real, d) * 4.0).astype(np.float32)
    return build_exact_lattice(feats, n_pix, valid), rng


def test_wrappers_on_cpu_are_the_plain_versions():
    """CPU tensors take the plain versions (no launch counted), which are
    the dense products S'^T q, B_j lat and alpha S' lat of the splat
    matrix S' = diag(norm) S (pixels x vertices)."""
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    tables, rng = _tiny_tables()
    n_pix, d1, m = tables.ids.shape[0], tables.d1, tables.m
    norm = torch.from_numpy(rng.rand(n_pix).astype(np.float32))
    q = torch.from_numpy(rng.randn(n_pix, 7).astype(np.float32))
    before = [f.launches for f in (k.lattice_weights, k.lattice_splat,
                                   k.lattice_blur, k.lattice_slice)]
    wn_pix, wn_csr = k.lattice_weights(tables.w, tables.w_csr,
                                       tables.entries, norm)
    lat = k.lattice_splat(tables, wn_csr, q)
    blurred = k.lattice_blur(lat, tables.nbr[1])
    out = k.lattice_slice(blurred, tables.ids, wn_pix, tables.alpha)
    assert [f.launches for f in (k.lattice_weights, k.lattice_splat,
                                 k.lattice_blur, k.lattice_slice)] == before

    s = np.zeros((n_pix, m + 1))
    ids, w = tables.ids.numpy(), tables.w.numpy()
    for p in range(n_pix):
        for r in range(d1):
            s[p, ids[p, r]] += w[p, r] * norm[p].item()
    b = np.eye(m + 1)
    b[m, m] = 0
    for v, (n1, n2) in enumerate(tables.nbr[1].numpy()):
        b[v, n1] += 0.5
        b[v, n2] += 0.5
    b[:, m] = 0
    lat_want = s.T @ q.numpy().astype(np.float64)
    np.testing.assert_allclose(lat.numpy(), lat_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(blurred.numpy(), b @ lat_want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), tables.alpha * s @ b @ lat_want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wn_pix.numpy(), w * norm.numpy()[:, None],
                               rtol=1e-6)


def test_launch_counts_survive_concurrent_launchers():
    """The serving CRF pool launches from several threads: no count is
    lost when many threads bump one counter with a short switch
    interval."""
    import sys
    import threading

    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    def bump():
        for _ in range(2000):
            k._count(k.lattice_blur)

    before = k.lattice_blur.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        counted = k.lattice_blur.launches - before
        k.lattice_blur.launches = before
    assert not any(t.is_alive() for t in threads)
    assert counted == 16 * 2000


def test_no_fallback_off_the_cpu(monkeypatch, tmp_path):
    """A tensor off the CPU takes the kernel or raises: a meta tensor
    raises, and without nvcc the kernel library does not build.  The
    host lattice library raises when no C++ compiler builds it."""
    from wseg_tpu_torch import _build
    from wseg_tpu_torch.ops import crf_lattice_cuda as k
    from wseg_tpu_torch.ops import crf_native

    tables, _ = _tiny_tables()
    meta = tables.to("meta")
    n_pix = tables.ids.shape[0]
    ones = torch.ones(n_pix, device="meta")
    calls = [
        lambda: k.lattice_weights(meta.w, meta.w_csr, meta.entries, ones),
        lambda: k.lattice_splat(meta, meta.w_csr, ones[:, None]),
        lambda: k.lattice_blur(torch.ones(meta.m + 1, 3, device="meta"),
                               meta.nbr[0]),
        lambda: k.lattice_filter_cuda(ones[:, None], meta, meta.w,
                                      meta.w_csr),
        lambda: k.lattice_slice(torch.ones(meta.m + 1, 3, device="meta"),
                                meta.ids, meta.w, meta.alpha),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    k._library.cache_clear()
    crf_native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k._library()
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            crf_native.permutohedral_filter(
                np.zeros((4, 2), np.float32), np.ones((4, 1), np.float32))
    finally:
        k._library.cache_clear()
        crf_native._library.cache_clear()
    assert not (tmp_path / "kernels").exists()


def test_infer_val_exact_mode_writes_crf_pngs(tmp_path):
    """``python -m wseg_tpu_torch.infer_val --device cpu --set
    TEST.CRF_MODE exact`` serves through ExactCRF and writes the crf/
    PNGs of both thresholds."""
    from PIL import Image

    from tests.synthetic_voc import make_synthetic_voc
    from tests.torch_parity import (
        jax_model_and_random_variables,
        port_model_from_jax,
    )
    from tests.test_torch_infer_val import _write_cfg
    from wseg_tpu_torch import infer_val
    from wseg_tpu_torch.config import reset_cfg

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=2)
    cfg_file = _write_cfg(tmp_path, root)
    _, variables = jax_model_and_random_variables(seed=11, size=32)
    ckpt = str(tmp_path / "port.pth")
    torch.save(port_model_from_jax(variables).state_dict(), ckpt)
    reset_cfg()
    try:
        infer_val.main(["--cfg", cfg_file, "--resume", ckpt,
                        "--snapshot-dir", str(tmp_path / "snap"),
                        "--logdir", str(tmp_path / "logs"),
                        "--workers", "2", "--device", "cpu",
                        "--infer-list", os.path.join(root, "val_voc.txt"),
                        "--mask-output-dir", str(tmp_path / "out"),
                        "--set", "TEST.CRF_MODE", "exact"])
    finally:
        reset_cfg()
    for suffix in ("0", "1"):
        names = sorted(os.listdir(tmp_path / f"out_{suffix}" / "crf"))
        assert len(names) == 2
        for name in names:
            a = np.asarray(Image.open(tmp_path / f"out_{suffix}" / "crf"
                                      / name))
            assert a.shape == (60, 80) and a.max() <= 20


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bilateral", "gaussian"])
def test_kernels_match_plain_on_card(kind):
    """Each kernel against its plain version on the same card tensors,
    1e-5 relative (f32, another summation order), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import crf_lattice_cuda as k
    from wseg_tpu_torch.ops.crf_exact import build_exact_lattice

    rng = np.random.RandomState(5)
    hc, wc, h, w = 96, 128, 90, 120
    img = _smooth(rng, h, w)
    valid = np.zeros((hc, wc), bool)
    valid[3:3 + h, 5:5 + w] = True
    tables = build_exact_lattice(_features(kind, img), hc * wc,
                                 valid.reshape(-1)).to("cuda")
    norm = torch.rand(hc * wc, device="cuda")
    q = torch.rand(hc * wc, 21, device="cuda")
    lat0 = torch.rand(tables.m + 1, 21, device="cuda")
    lat0[-1] = 0
    q1 = q[:, :1].clone()  # the norm's C = 1

    def splat_plain(v):
        return k.lattice_splat_reference(tables.row_ptr, tables.entries,
                                         tables.w_csr, v, tables.d1)

    cases = [  # (counted wrapper, kernel call, plain call)
        (k.lattice_weights,
         lambda: k.lattice_weights(tables.w, tables.w_csr, tables.entries,
                                   norm),
         lambda: k.lattice_weights_reference(tables.w, tables.w_csr,
                                             tables.entries, norm)),
        (k.lattice_splat, lambda: k.lattice_splat(tables, tables.w_csr, q),
         lambda: splat_plain(q)),
        (k.lattice_splat, lambda: k.lattice_splat(tables, tables.w_csr, q1),
         lambda: splat_plain(q1)),
        (k.lattice_blur, lambda: k.lattice_blur(lat0, tables.nbr[2]),
         lambda: k.lattice_blur_reference(lat0, tables.nbr[2])),
        (k.lattice_slice,
         lambda: k.lattice_slice(lat0, tables.ids, tables.w, tables.alpha),
         lambda: k.lattice_slice_reference(lat0, tables.ids, tables.w,
                                           tables.alpha)),
    ]
    for fn, kernel, plain in cases:
        before = fn.launches
        got = kernel()
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for g, wnt in zip(got, want):
            err = float((g - wnt).abs().max()) / float(wnt.abs().max())
            assert err <= 1e-5, (fn.__name__, err)
    again = k.lattice_splat(tables, tables.w_csr, q)
    assert torch.equal(again, k.lattice_splat(tables, tables.w_csr, q))


@pytest.mark.gpu
def test_exact_crf_on_card_matches_the_host_oracle():
    """ExactCRF on the card against the port's C++ mean field on the
    host: max |dQ| <= 1e-4, and bit-equal labels from two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.engine.infer import ExactCRF
    from wseg_tpu_torch.ops.crf_native import crf_inference_native

    rng = np.random.RandomState(6)
    h, w, hc, wc, pt, pl = 90, 120, 96, 128, 2, 4
    img = _smooth(rng, h, w)
    probs = _probs(rng, h, w)
    canvas = torch.full((hc, wc, 21), 0.3, device="cuda")
    canvas[pt:pt + h, pl:pl + w] = torch.from_numpy(probs).cuda()
    ex = ExactCRF(THRESHS, crf_iters=10)
    tables = ex.build(img, (hc, wc), (pt, pl, h, w), device="cuda")
    q = ex.q(tables, canvas)[pt:pt + h, pl:pl + w].cpu().numpy()
    want = crf_inference_native(img, probs, t=10)
    assert np.abs(q - want).max() <= 1e-4
    first = ex.run(tables, canvas)
    tables2 = ex.build(img, (hc, wc), (pt, pl, h, w), device="cuda")
    assert torch.equal(first, ex.run(tables2, canvas))
