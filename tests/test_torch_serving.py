"""The slice as a whole: JAX ``MultiScaleServer`` + device postprocess vs
the port's, from the same weights, on the same images (CPU, float32).

Settings: scales [1.0, 0.5] with flip, PAD_ALIGN 32, fast CRF defaults
(coarse-to-fine, bilateral stride 2) with float32 messages.  The JAX
server's CRF takes its XLA loop on the CPU (float32 tap weights) while
the port follows the Pallas path (bfloat16 tap weights), so the CRF
label maps are held to >= 99% agreement, as the plain ones.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    jax_model_and_random_variables,
    port_model_from_jax,
)

THRESHS = (0.0, 0.1)
SIZES = [(40, 56), (56, 40), (40, 56)]  # (h, w)


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _apply_test_cfg(test_cfg, use_gt):
    test_cfg.SCALES = [1.0, 0.5]
    test_cfg.FLIP = True
    test_cfg.PAD_SIZE = [64, 64]
    test_cfg.PAD_ALIGN = 32
    test_cfg.CRF_DTYPE = "float32"
    test_cfg.USE_GT_LABELS = use_gt


def _pp_kwargs(test_cfg):
    return dict(crf_iters=10, bg_pow=float(test_cfg.BG_POW),
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


@pytest.mark.parametrize("use_gt", [True, False],
                         ids=["gt-labels", "predicted-labels"])
def test_server_matches_jax(use_gt):
    from PIL import Image

    from wseg_tpu.config import cfg as jcfg
    from wseg_tpu.engine.infer import make_device_postprocess as jax_pp
    from wseg_tpu.engine.serving import MultiScaleServer as JaxServer
    from wseg_tpu_torch.config import cfg as pcfg
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving import MultiScaleServer

    jmodel, variables = jax_model_and_random_variables(seed=7, size=32)
    rng = np.random.RandomState(8)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in SIZES]
    labels = [np.zeros(20, np.float32) for _ in SIZES]
    for lb in labels:
        lb[rng.choice(20, size=2, replace=False)] = 1.0

    _apply_test_cfg(jcfg.TEST, use_gt)
    want = _serve(JaxServer(jmodel, variables, jcfg.TEST, max_batch=4,
                            postprocess=jax_pp(THRESHS, THRESHS,
                                               **_pp_kwargs(jcfg.TEST))),
                  [Image.fromarray(im) for im in images], labels)

    _apply_test_cfg(pcfg.TEST, use_gt)
    model = port_model_from_jax(variables)
    got = _serve(MultiScaleServer(model, pcfg.TEST, max_batch=4,
                                  postprocess=make_device_postprocess(
                                      THRESHS, THRESHS,
                                      **_pp_kwargs(pcfg.TEST))),
                 images, labels)

    for k, ((res, lab), (jres, jlab)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(lab, np.asarray(jlab))
        for t in THRESHS:
            for key in ("pred", "pred_crf"):
                a, b = res[t][key], np.asarray(jres[t][key])
                assert a.dtype == np.uint8 and a.shape == images[k].shape[:2]
                agree = float((a == b).mean())
                assert agree >= 0.99, (k, t, key, agree)


def test_server_without_postprocess_returns_merged_scores():
    """postprocess=None resolves to the cleaned, BG^pow merged scores at
    the image's own size, with labels from the per-view cls."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.serving import MultiScaleServer

    _, variables = jax_model_and_random_variables(seed=9, size=32)
    model = port_model_from_jax(variables)
    _apply_test_cfg(cfg.TEST, use_gt=False)
    img = (np.random.RandomState(10).rand(40, 56, 3) * 255).astype(np.uint8)
    with torch.no_grad():
        [(merged, labels)] = _serve(MultiScaleServer(model, cfg.TEST),
                                    [img], [None])
    assert merged.shape == (40, 56, 21) and np.isfinite(merged).all()
    assert labels.shape == (20,)
    absent = np.flatnonzero(labels == 0) + 1
    assert (merged[..., absent] == 0).all()


def test_flagship_overrides_equal_the_yaml():
    """The flagship ``--set`` list (chip_smoke.py's configuration where
    pyyaml is missing) reproduces configs/voc_resnet38.yaml."""
    from wseg_tpu_torch import flagship
    from wseg_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from wseg_tpu_torch.config import reset_cfg

    cfg_from_file(flagship.FLAGSHIP_CFG)
    from_yaml = cfg.clone()
    reset_cfg()
    cfg_from_list(flagship.FLAGSHIP_SET)
    assert cfg.clone() == from_yaml
    assert cfg.NET.MODEL == "CAM_CASA_WGAP_tf" and cfg.TEST.FLIP is True
