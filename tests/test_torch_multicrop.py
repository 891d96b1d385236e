"""Multicrop serving (``TEST.METHOD multicrop``): the port's crop grid,
host crop views and merge, ``MultiCropServer`` and ``infer_val`` against
``wseg_tpu``'s, from the same weights on the same numpy-seeded images
(CPU, float32, the size-32 test model).

Geometry: PAD 64x96, crops 48x48 on a 2x2 grid (strides 32 and 48) with
flip, 8 views an image.  Tolerances: grid, views and host merge as float32
arithmetic allows (1e-6); merged scores within 1e-4 absolute; labels
equal; CRF label maps >= 99% equal (the JAX CRF's tap weights take its
XLA loop on the CPU, the port's the bfloat16 Pallas semantics, see
tests/test_torch_serving.py).
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
SIZES = [(40, 56), (64, 48)]  # (h, w)


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


@pytest.fixture(scope="module")
def models():
    """The JAX model, its weights and its jitted crop step (shared by
    every JAX server of this file), and the port's model."""
    from wseg_tpu.engine.serving_crop import make_crop_infer_fn

    jmodel, variables = jax_model_and_random_variables(seed=21, size=32)
    with torch.no_grad():
        port = port_model_from_jax(variables)
    return jmodel, variables, make_crop_infer_fn(jmodel), port


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(22)
    imgs = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in SIZES]
    labels = [np.zeros(20, np.float32) for _ in SIZES]
    for lb in labels:
        lb[rng.choice(20, size=2, replace=False)] = 1.0
    return imgs, labels


def _crop_cfg(test_cfg, use_gt=True):
    test_cfg.METHOD = "multicrop"
    test_cfg.PAD_SIZE = [64, 96]
    test_cfg.CROP_SIZE = [48, 48]
    test_cfg.CROP_GRID_SIZE = [2, 2]
    test_cfg.FLIP = True
    test_cfg.CRF_DTYPE = "float32"
    test_cfg.USE_GT_LABELS = use_gt


def _pp(make, test_cfg):
    return make(THRESHS, THRESHS, crf_iters=10, bg_pow=1.0,
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


@pytest.mark.parametrize("pad,crop,grid,flip", [
    ((64, 64), (48, 48), (2, 2), True),
    ((64, 80), (48, 40), (2, 3), False),
    ((640, 640), (448, 448), (2, 2), True),
    ((1024, 1024), (448, 448), (2, 2), True),  # the default: sparse
    ((64, 64), (80, 48), (1, 1), True),  # crop over the canvas
], ids=["square", "rect", "covering", "sparse-default", "crop-too-big"])
def test_grid_and_crop_views_match_jax(pad, crop, grid, flip):
    """``grid_coords`` and ``CropViews.build`` equal JAX's; both refuse a
    sparse grid and a crop larger than the canvas."""
    from PIL import Image

    from wseg_tpu.data.multiscale import CropViews as JaxCropViews
    from wseg_tpu.engine.serving_crop import grid_coords as jax_grid
    from wseg_tpu_torch.data.multiscale import CropViews, grid_coords

    try:
        want = jax_grid(pad, crop, grid)
    except AssertionError as e:
        with pytest.raises(ValueError, match="sparse|exceeds"):
            grid_coords(pad, crop, grid)
        with pytest.raises(ValueError):
            CropViews(crop, grid, pad, flip)
        with pytest.raises(AssertionError):
            JaxCropViews(crop, grid, pad, flip)
        assert "sparse" in str(e) or "exceeds" in str(e)
        return
    assert grid_coords(pad, crop, grid) == want
    if pad[0] > 100:
        return
    img = (np.random.RandomState(23).rand(40, 56, 3) * 255).astype(np.uint8)
    jv, jc, jf = JaxCropViews(crop, grid, pad, flip).build(
        Image.fromarray(img))
    views, coords, flips = CropViews(crop, grid, pad, flip).build(img)
    assert coords == jc and flips == jf and len(views) == len(jv)
    for a, b in zip(views, jv):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_merge_crops_matches_jax():
    """Host MergeCrops maths on seeded masks: within 1e-6."""
    from wseg_tpu.data.multiscale import merge_crops as jax_merge
    from wseg_tpu_torch.data.multiscale import CropViews, merge_crops

    rng = np.random.RandomState(24)
    views = CropViews((48, 48), (2, 2), (64, 64), True)
    img = np.zeros((40, 56, 3), np.uint8)
    _, coords, flips = views.build(img)
    masks = [rng.rand(48, 48, 21).astype(np.float32) for _ in coords]
    labels = (rng.rand(20) > 0.5).astype(np.float32)
    got = merge_crops(masks, coords, flips, labels, (40, 56))
    want = jax_merge(masks, coords, flips, labels, (40, 56))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_gt,with_pp", [
    (True, True), (False, True), (True, False), (False, False)],
    ids=["gt-postprocess", "predicted-postprocess", "gt-scores",
         "predicted-scores"])
def test_multicrop_server_matches_jax(models, images, use_gt, with_pp):
    """``MultiCropServer`` against JAX's: with the device postprocess
    (label maps >= 99% equal, labels equal) and without (merged scores
    within 1e-4, labels equal)."""
    from PIL import Image

    from wseg_tpu.config import cfg as jcfg
    from wseg_tpu.engine.infer import make_device_postprocess as jax_pp
    from wseg_tpu.engine.serving_crop import MultiCropServer as JaxServer
    from wseg_tpu_torch.config import cfg as pcfg
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving_crop import MultiCropServer

    jmodel, variables, crop_fn, port = models
    imgs, labels = images
    _crop_cfg(jcfg.TEST, use_gt)
    jserver = JaxServer(jmodel, variables, jcfg.TEST, max_batch=2,
                        postprocess=_pp(jax_pp, jcfg.TEST) if with_pp
                        else None)
    jserver.infer_crops = crop_fn
    want = _serve(jserver, [Image.fromarray(im) for im in imgs], labels)

    _crop_cfg(pcfg.TEST, use_gt)
    got = _serve(MultiCropServer(
        port, pcfg.TEST, max_batch=2,
        postprocess=_pp(make_device_postprocess, pcfg.TEST) if with_pp
        else None), imgs, labels)

    for k, ((res, lab), (jres, jlab)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(lab, np.asarray(jlab))
        if use_gt:
            np.testing.assert_array_equal(lab, labels[k])
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


def test_postprocess_slot_cap(models, images, monkeypatch):
    """The writer math in chunks under a forced budget: one slot a chunk
    at a budget below one slot's bytes gives the same label maps as one
    chunk (the rows are independent); the cap follows the budget."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine import serving
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving_crop import MultiCropServer

    _, _, _, port = models
    imgs, labels = images
    _crop_cfg(cfg.TEST)
    runs, calls = [], []
    for budget in (serving.CPU_PP_BUDGET, 1.0):
        pp = _pp(make_device_postprocess, cfg.TEST)
        dispatch = pp.dispatch_group

        def counted(*args, _d=dispatch, **kw):
            calls.append(args[0].shape[0])
            return _d(*args, **kw)

        pp.dispatch_group = counted
        monkeypatch.setattr(serving, "CPU_PP_BUDGET", budget)
        server = MultiCropServer(port, cfg.TEST, max_batch=2,
                                 max_wait_ms=500, postprocess=pp)
        if budget == 1.0:
            assert server._pp_slot_cap(64, 96, 21) == 1
        runs.append(_serve(server, imgs, labels))
    assert calls == [2, 1, 1], calls
    for (a, _), (b, _) in zip(*runs):
        for t in THRESHS:
            for key in ("pred", "pred_crf"):
                np.testing.assert_array_equal(a[t][key], b[t][key])

    per_slot = 384 * 512 * 21 * 4 * serving.PP_BYTES_PER_CANVAS_BYTE
    monkeypatch.setattr(serving, "CPU_PP_BUDGET", 16 * per_slot)
    server = MultiCropServer(port, cfg.TEST)
    try:
        assert server._pp_slot_cap(384, 512, 21) == 16
        assert server._pp_slot_cap(1024, 1024, 21) < 16
        assert server._pp_slot_cap(4096, 4096, 21) == 1
    finally:
        server.close()


def test_infer_val_multicrop_writes_the_same_pngs(tmp_path, monkeypatch,
                                                  models):
    """``python -m wseg_tpu_torch.infer_val`` with ``TEST.METHOD
    multicrop`` writes the root CLI's PNGs (>= 99% of pixels per map).
    The root CLI's server borrows the fixture's jitted crop step (same
    model, same geometry as the server tests above) and skips its init,
    so JAX compiles nothing new."""
    from PIL import Image

    from tests.synthetic_voc import make_synthetic_voc
    from tests.test_torch_infer_val import _root_infer_val, _write_cfg
    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch import infer_val as port_cli
    from wseg_tpu_torch.config import reset_cfg as reset_port_cfg

    _, variables, crop_fn, port = models
    monkeypatch.setattr("wseg_tpu.engine.serving_crop.make_crop_infer_fn",
                        lambda model: crop_fn)
    # the CLI's test-mode init only gives the tree its checkpoint fills
    monkeypatch.setattr("wseg_tpu.engine.train_loop.init_test_variables",
                        lambda model, rng, shape: variables)
    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=2)
    cfg_file = _write_cfg(tmp_path, root)
    ckpt = str(tmp_path / "port.pth")
    torch.save(port.state_dict(), ckpt)
    reset_jax_cfg()
    sets = ["--set", "TEST.METHOD", "multicrop", "TEST.PAD_SIZE", "[64, 96]",
            "TEST.CROP_SIZE", "[48, 48]", "TEST.CROP_GRID_SIZE", "[2, 2]",
            "TEST.BATCH_SIZE", "2"]

    def argv(out):
        return ["--cfg", cfg_file, "--resume", ckpt,
                "--snapshot-dir", str(tmp_path / "snap"),
                "--logdir", str(tmp_path / "logs"), "--workers", "2",
                "--infer-list", os.path.join(root, "val_voc.txt"),
                "--mask-output-dir", str(tmp_path / out)] + sets

    _root_infer_val().main(argv("jax"))
    reset_port_cfg()
    try:
        port_cli.main(argv("port") + ["--device", "cpu"])
    finally:
        reset_port_cfg()
    os.remove(ckpt)  # ~0.4 GB
    n_files = 0
    for suffix in ("0", "1"):
        for sub in ("no_crf", "crf"):
            jdir = tmp_path / f"jax_{suffix}" / sub
            pdir = tmp_path / f"port_{suffix}" / sub
            names = sorted(os.listdir(jdir))
            assert names and sorted(os.listdir(pdir)) == names
            for name in names:
                a, b = Image.open(pdir / name), Image.open(jdir / name)
                assert a.mode == "P" and a.getpalette() == b.getpalette()
                a, b = np.asarray(a), np.asarray(b)
                assert a.shape == b.shape == (60, 80)
                assert (a == b).mean() >= 0.99, (suffix, sub, name)
                n_files += 1
    assert n_files == 8
