"""The per-image ``InferenceEngine``, the host-view paths of
``MultiScaleServer`` (``DEVICE_VIEWS`` off, and images over the device
canvas split off a device-view group), the host merges and the
per-image ``infer_val`` path against ``wseg_tpu``'s, from the same
weights on the same numpy-seeded images (CPU, float32, the size-32 test
model).

Tolerances: PIL views equal; host merges within 1e-6; merged scores
within 1e-4 absolute; labels equal; label maps >= 99% equal where a CRF
runs (the JAX fast CRF's tap weights take its XLA loop on the CPU, see
tests/test_torch_serving.py; the per-image path's host C++ CRF is one
algorithm in two builds).
"""

import os

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    jax_model_and_random_variables,
    port_model_from_jax,
)

THRESHS = (0.0, 0.1)
# (h, w): the third exceeds the 64x64 device canvas of _server_cfg
SIZES = [(48, 40), (40, 56), (72, 64)]


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


@pytest.fixture(scope="module")
def models():
    """The JAX model, its weights and its jitted steps (shared by every
    JAX engine and server of this file), and the port's model."""
    from wseg_tpu.engine.infer import make_infer_merge_fn
    from wseg_tpu.engine.train_loop import make_infer_fn

    jmodel, variables = jax_model_and_random_variables(seed=31, size=32)
    with torch.no_grad():
        port = port_model_from_jax(variables)
    shared = {"u8": make_infer_fn(jmodel, device_norm=True),
              "f32": make_infer_fn(jmodel),
              "mv": make_infer_merge_fn(jmodel)}
    return jmodel, variables, shared, port


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(32)
    imgs = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in SIZES]
    labels = [np.zeros(20, np.float32) for _ in SIZES]
    for lb in labels:
        lb[rng.choice(20, size=2, replace=False)] = 1.0
    return imgs, labels


def _engine_cfg(test_cfg, method, device_merge=False):
    test_cfg.METHOD = method
    test_cfg.SCALES = [1.0, 0.5]
    test_cfg.FLIP = True
    test_cfg.PAD_SIZE = [64, 64] if method == "multiscale" else [96, 96]
    test_cfg.PAD_ALIGN = 32
    test_cfg.CROP_SIZE = [64, 64]
    test_cfg.CROP_GRID_SIZE = [2, 2]
    test_cfg.DEVICE_MERGE = device_merge
    test_cfg.USE_GT_LABELS = False


def _server_cfg(test_cfg, device_views, device_merge, use_gt):
    """Scales 1 and 0.5 on a 64x64 device canvas, buckets padded to 80:
    every image has the ((80, 80), (80, 80)) signature, so one group
    holds the images that fit the canvas and the one that does not."""
    test_cfg.SCALES = [1.0, 0.5]
    test_cfg.FLIP = True
    test_cfg.PAD_SIZE = [64, 64]
    test_cfg.PAD_ALIGN = 80
    test_cfg.CRF_DTYPE = "float32"
    test_cfg.DEVICE_VIEWS = device_views
    test_cfg.DEVICE_MERGE = device_merge
    test_cfg.USE_GT_LABELS = use_gt


@pytest.mark.parametrize("transfer", ["float32", "uint8"])
def test_multiscale_views_build_matches_jax(transfer):
    """Host views (PIL bicubic, flip, zero padding) equal JAX's."""
    from PIL import Image

    from wseg_tpu.data.multiscale import MultiscaleViews as JaxViews
    from wseg_tpu_torch.data.multiscale import MultiscaleViews

    img = (np.random.RandomState(33).rand(45, 61, 3) * 255).astype(np.uint8)
    args = ([1.0, 0.5, 1.5], True, (64, 64), True, 32)
    jv, jp, jf = JaxViews(*args, transfer=transfer).build(
        Image.fromarray(img))
    views, pads, flips = MultiscaleViews(*args, transfer=transfer).build(img)
    assert pads == jp and flips == jf
    for a, b in zip(views, jv):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_host_merges_match_jax():
    """``merge_multiscale`` and ``finalize_device_merge`` (OpenCV
    resizes) on seeded masks: within 1e-6."""
    from wseg_tpu.data.multiscale import merge_multiscale as jax_merge
    from wseg_tpu.engine.infer import finalize_device_merge as jax_final
    from wseg_tpu_torch.data.multiscale import (
        MultiscaleViews,
        merge_multiscale,
    )
    from wseg_tpu_torch.engine.infer import finalize_device_merge

    rng = np.random.RandomState(34)
    pads, flips = MultiscaleViews([1.0, 0.5], True, (64, 64), True,
                                  32).view_windows(61, 45)
    masks = [rng.rand(*((64, 64) if p[2] > 30 else (32, 32)), 21)
             .astype(np.float32) for p in pads]
    labels = (rng.rand(20) > 0.5).astype(np.float32)
    got = merge_multiscale(masks, pads, flips, labels, (45, 61), 3.0)
    want = jax_merge(masks, pads, flips, labels, (45, 61), 3.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sums = rng.rand(64, 64, 21).astype(np.float32) * 4
    np.testing.assert_allclose(
        finalize_device_merge(sums, pads[0], (45, 61), labels, 4, 3.0),
        jax_final(sums, pads[0], (45, 61), labels, 4, 3.0), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("method,device_merge", [
    ("multiscale", False), ("multiscale", True), ("multicrop", False)],
    ids=["host-merge", "device-merge", "multicrop"])
def test_run_image_matches_jax(models, images, method, device_merge):
    """``InferenceEngine.run_image``: merged scores within 1e-4, labels
    (predicted from the views) equal."""
    from PIL import Image

    from wseg_tpu.config import cfg as jcfg
    from wseg_tpu.engine.infer import InferenceEngine as JaxEngine
    from wseg_tpu_torch.config import cfg as pcfg
    from wseg_tpu_torch.engine.infer import InferenceEngine

    jmodel, variables, shared, port = models
    _, labels = images
    _engine_cfg(jcfg.TEST, method, device_merge)
    _engine_cfg(pcfg.TEST, method, device_merge)
    jeng = JaxEngine(jmodel, variables, jcfg.TEST)
    jeng.infer = shared["u8" if jeng.uint8 else "f32"]
    eng = InferenceEngine(port, pcfg.TEST)
    # its 1.0-scale bucket (64, 96) is the per-image CLI test's
    img = (np.random.RandomState(36).rand(48, 72, 3) * 255).astype(np.uint8)
    want, jlab = jeng.run_image(Image.fromarray(img), labels[0])
    got, glab = eng.run_image(img, labels[0])
    np.testing.assert_array_equal(glab, np.asarray(jlab))
    assert got.shape == img.shape[:2] + (21,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def _pp(make, test_cfg):
    return make(THRESHS, THRESHS, crf_iters=10, bg_pow=float(test_cfg.BG_POW),
                crf_dtype=str(test_cfg.CRF_DTYPE),
                crf_stride=int(test_cfg.CRF_STRIDE),
                crf_tap_div=float(test_cfg.CRF_TAP_DIV),
                crf_full_stride=int(test_cfg.CRF_FULL_STRIDE),
                crf_refine_iters=int(test_cfg.CRF_REFINE_ITERS))


def _serve(server, images, labels):
    try:
        futs = [server.submit(im, lb) for im, lb in zip(images, labels)]
        return [f.result(timeout=600) for f in futs]
    finally:
        server.close()


@pytest.mark.parametrize("device_views,device_merge,use_gt,with_pp", [
    (True, True, True, True), (False, True, False, True),
    (False, False, False, False), (False, True, True, False)],
    ids=["oversize-split-gt", "host-views-predicted", "host-merge-scores",
         "device-merge-scores"])
def test_host_view_server_matches_jax(models, images, device_views,
                                      device_merge, use_gt, with_pp):
    """``MultiScaleServer`` against JAX's where images take host views:
    a device-view group whose third image exceeds the canvas (split off
    to the host path in the same group), and ``DEVICE_VIEWS`` off with
    the device postprocess, the host merge and the device merge.  Label
    maps >= 99% equal, merged scores within 1e-4, labels equal."""
    from PIL import Image

    from wseg_tpu.config import cfg as jcfg
    from wseg_tpu.engine.infer import make_device_postprocess as jax_pp
    from wseg_tpu.engine.serving import MultiScaleServer as JaxServer
    from wseg_tpu_torch.config import cfg as pcfg
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving import MultiScaleServer

    jmodel, variables, shared, port = models
    imgs, labels = images
    _server_cfg(jcfg.TEST, device_views, device_merge, use_gt)
    jserver = JaxServer(jmodel, variables, jcfg.TEST, max_batch=3,
                        max_wait_ms=500,
                        postprocess=_pp(jax_pp, jcfg.TEST) if with_pp
                        else None)
    jserver.infer, jserver.infer_mv = shared["u8"], shared["mv"]
    want = _serve(jserver, [Image.fromarray(im) for im in imgs], labels)

    _server_cfg(pcfg.TEST, device_views, device_merge, use_gt)
    server = MultiScaleServer(
        port, pcfg.TEST, max_batch=3, max_wait_ms=500,
        postprocess=_pp(make_device_postprocess, pcfg.TEST) if with_pp
        else None)
    paths = []
    for name in ("_process_device", "_process_host"):
        run = getattr(server, name)

        def spy(group, _run=run, _name=name):
            paths.append((_name, len(group)))
            return _run(group)

        setattr(server, name, spy)
    got = _serve(server, imgs, labels)
    assert sorted(paths) == (
        [("_process_device", 2), ("_process_host", 1)] if device_views
        else [("_process_host", 3)]), paths

    for k, ((res, lab), (jres, jlab)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(lab, np.asarray(jlab))
        if not with_pp:
            assert res.shape == imgs[k].shape[:2] + (21,)
            np.testing.assert_allclose(res, np.asarray(jres), rtol=0,
                                       atol=1e-4)
            continue
        for t in THRESHS:
            for key in ("pred", "pred_crf"):
                a, b = res[t][key], np.asarray(jres[t][key])
                assert a.dtype == np.uint8 and a.shape == imgs[k].shape[:2]
                agree = float((a == b).mean())
                assert agree >= 0.99, (k, t, key, agree)


def test_device_views_close_to_host_views(models, images):
    """The port's device views (one original upload, cubic resampling on
    the device) against its PIL host views, the JAX package's tolerance
    (tests/test_serving.py): mean |d merged| < 5e-3, argmax agreement
    > 0.97, labels equal."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.serving import MultiScaleServer

    _, _, _, port = models
    imgs, _ = images
    runs = []
    for device_views in (False, True):
        _server_cfg(cfg.TEST, device_views, True, False)
        runs.append(_serve(MultiScaleServer(port, cfg.TEST, max_batch=3),
                           imgs[:2], [None, None]))
    for (m_h, l_h), (m_d, l_d) in zip(*runs):
        assert m_d.shape == m_h.shape
        assert np.abs(m_d - m_h).mean() < 5e-3, np.abs(m_d - m_h).mean()
        am = (np.argmax(m_d, -1) == np.argmax(m_h, -1)).mean()
        assert am > 0.97, am
        np.testing.assert_array_equal(l_d, l_h)


@pytest.mark.parametrize("where", ["finisher", "host-half"])
def test_server_failure_resolves_only_its_images(models, images, where):
    """A failure on the finisher thread fails that group's futures, and a
    failure in the host-view half of a split group fails only that half;
    the server keeps serving."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving import MultiScaleServer

    _, _, _, port = models
    imgs, labels = images
    _server_cfg(cfg.TEST, True, True, True)
    server = MultiScaleServer(port, cfg.TEST, max_batch=3, max_wait_ms=500,
                              postprocess=_pp(make_device_postprocess,
                                              cfg.TEST))
    boom = RuntimeError("injected")
    if where == "finisher":
        finalize = server.postprocess.finalize
        calls = []

        def failing(*args, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise boom
            return finalize(*args, **kw)

        server.postprocess.finalize = failing
    else:
        def failing(group):
            raise boom

        server._process_host = failing
    try:
        futs = [server.submit(im, lb) for im, lb in zip(imgs, labels)]
        errors = [f.exception(timeout=600) for f in futs]
        again = server.submit(imgs[0], labels[0]).result(timeout=600)
    finally:
        server.close()
    # the first group is all three images: 2 on the device path, the
    # third (over the canvas) on the host path
    failed = [e is boom for e in errors]
    assert failed == ([True, True, False] if where == "finisher"
                      else [False, False, True]), errors
    assert again[0][0.0]["pred"].shape == imgs[0].shape[:2]


@pytest.mark.parametrize("split,n,strict_env", [
    ("val_voc", 1449, ""), ("val_voc", 3, ""), ("train_augvoc", 10582, "1"),
    ("train_augvoc", 7, "1"), ("val", 2, "yes"), ("my_list", 5, "1")])
def test_check_split_integrity_matches_jax(monkeypatch, split, n,
                                           strict_env):
    """The split check warns or, under ``WSEG_STRICT_SPLITS``, raises
    exactly where JAX's does."""
    import warnings

    from wseg_tpu.data.pascal_voc import check_split_integrity as jax_check
    from wseg_tpu_torch.data.pascal_voc import check_split_integrity

    monkeypatch.setenv("WSEG_STRICT_SPLITS", strict_env)

    def outcome(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                fn(split, n)
            except AssertionError:
                return "raised"
        return "warned" if rec else "ok"

    assert outcome(check_split_integrity) == outcome(jax_check)


def test_infer_val_per_image_writes_the_same_pngs(tmp_path, monkeypatch,
                                                  models):
    """``python -m wseg_tpu_torch.infer_val`` with ``TEST.DEVICE_MERGE
    False`` (the per-image ``InferenceEngine`` and the host C++ CRF) and a
    heatmap and scoremap writer writes the root CLI's files: CRF PNGs
    >= 99% equal per map; the plain maps equal wherever the port's two
    top thresholded scores are more than 2e-4 apart (twice the merged
    scores' tolerance) and >= 98% equal in all (the seeded model's
    near-uniform maps have top-two margins of ~1e-8 over much of the
    image, and float32 rounding flips ~1% of those pixels, each with a
    margin <= 7.5e-9, while the scores agree within 4e-6); heatmaps
    within one level, scoremaps within 1e-4.  The root
    CLI's engine borrows the fixture's jitted forward (its (2, 64, 96)
    views were compiled by test_run_image_matches_jax) and skips its
    init."""
    from PIL import Image

    import wseg_tpu_torch.infer_val as port_cli
    from tests.synthetic_voc import make_synthetic_voc
    from tests.test_torch_infer_val import _root_infer_val, _write_cfg
    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch.config import reset_cfg as reset_port_cfg

    _, variables, shared, port = models
    monkeypatch.setattr(
        "wseg_tpu.engine.infer.make_infer_fn",
        lambda model, device_norm=False: shared["u8" if device_norm
                                                else "f32"])
    # the CLI's test-mode init only gives the tree its checkpoint fills
    monkeypatch.setattr("wseg_tpu.engine.train_loop.init_test_variables",
                        lambda model, rng, shape: variables)
    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=2)
    cfg_file = _write_cfg(tmp_path, root)
    ckpt = str(tmp_path / "port.pth")
    torch.save(port.state_dict(), ckpt)
    reset_jax_cfg()

    def argv(out):
        return ["--cfg", cfg_file, "--resume", ckpt,
                "--snapshot-dir", str(tmp_path / "snap"),
                "--logdir", str(tmp_path / "logs"), "--workers", "2",
                "--infer-list", os.path.join(root, "val_voc.txt"),
                "--mask-output-dir", str(tmp_path / out),
                "--set", "TEST.DEVICE_MERGE", "False", "TEST.SCALES", "[1.0]"]

    jax_cli = _root_infer_val()
    on = [True] + [False] * 4
    for cli in (jax_cli, port_cli):
        monkeypatch.setattr(cli, "HEATMAPS", on)
        monkeypatch.setattr(cli, "SCOREMAPS", on)
    jax_cli.main(argv("jax"))
    reset_port_cfg()
    try:
        port_cli.main(argv("port") + ["--device", "cpu"])
        # the port's scores of each image under the CLI's settings
        from wseg_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
        from wseg_tpu_torch.engine.infer import InferenceEngine

        cfg_from_file(cfg_file)
        cfg_from_list(argv("")[-4:])
        engine = InferenceEngine(port, cfg.TEST)
        scores = {}
        for name in os.listdir(os.path.join(root, "JPEGImages")):
            img = np.asarray(Image.open(os.path.join(
                root, "JPEGImages", name)).convert("RGB"))
            scores[name[:-4]] = engine.run_image(img, None)[0]
    finally:
        reset_port_cfg()
    os.remove(ckpt)  # ~0.4 GB

    def decided(name, thresh):
        """Pixels whose top two thresholded scores are > 2e-4 apart."""
        s = scores[name[:-4]].copy()
        fg = s[..., 1:]
        fg[fg < thresh] = 0.0
        top2 = np.sort(s, axis=-1)[..., -2:]
        return top2[..., 1] - top2[..., 0] > 2e-4

    n_files = 0
    for suffix, subs in (("0", ("no_crf", "crf", "heatmap", "scoremap")),
                         ("1", ("no_crf", "crf"))):
        for sub in subs:
            jdir = tmp_path / f"jax_{suffix}" / sub
            pdir = tmp_path / f"port_{suffix}" / sub
            names = sorted(os.listdir(jdir))
            assert names and sorted(os.listdir(pdir)) == names
            for name in names:
                if sub == "scoremap":
                    np.testing.assert_allclose(np.load(pdir / name),
                                               np.load(jdir / name),
                                               rtol=0, atol=1e-4)
                elif sub == "heatmap":
                    a = np.asarray(Image.open(pdir / name), np.int32)
                    b = np.asarray(Image.open(jdir / name), np.int32)
                    assert np.abs(a - b).max() <= 1, name
                else:
                    a, b = Image.open(pdir / name), Image.open(jdir / name)
                    assert a.mode == "P" and a.getpalette() == b.getpalette()
                    a, b = np.asarray(a), np.asarray(b)
                    assert a.shape == b.shape == (60, 80)
                    if sub == "crf":
                        assert (a == b).mean() >= 0.99, (suffix, name)
                    else:
                        sure = decided(name, float("0." + suffix))
                        assert (a == b)[sure].all(), (suffix, name)
                        assert (a == b).mean() >= 0.98, (suffix, name)
                n_files += 1
    assert n_files == 12
