"""The int8 serving mode (``NET.DTYPE int8``) at model level and through
the entry points, on the CPU (the port's plain w8a8 versions).

* The int8 model's state_dict has the bf16 model's keys and shapes;
  its backbone tensors (``QuantConv`` weights and biases, the frozen
  BatchNorms' constants) stay float32, as JAX's params are (the weights
  are quantized, and the BatchNorms folded, from float32), its head's
  are bf16 as in the bf16 model; a bf16 and a float32 checkpoint load
  with ``strict=True``.
* The flagship (WRN38 + ``CAM_CASA_WGAP_tf``) in int8, dynamic and
  static, against JAX's int8 model on the same converted float32
  weights at 64x64 (two JAX compiles in all, the backbone's taps
  captured in the same forward): the five taps are bit-equal.  JAX's
  forward is jitted with XLA's excess precision off and its algebraic
  simplifier disabled, which keeps its arithmetic that of the eager
  forward (``tests/test_quant.py``'s; the taps of the two are then
  bit-equal; by default 70% of the conv3 tap's elements differ by
  rounding, ROADMAP C) in one compile.  The
  bf16 head differs as the bf16 mode's does (the port's head holds bf16
  weights, JAX casts float32 ones at each use): measured mask argmax
  agreement 0.98816 and cls within 0.0444 (dynamic), 0.98853 and
  0.0402 (static), on logits of mean magnitude 2.57.  Held: agreement
  >= 0.98, cls within 0.06.
* The port's int8 model against its own bf16 model with JAX's bounds
  (``tests/test_quant.py``): argmax agreement > 0.9, mean cls
  deviation < 0.25 of the mean magnitude, correlation > 0.9.
* The refusals: ``get_model(train=True)``, the trainers, and the
  gradient-based CAM engines (and guided backprop, FullGrad) raise
  ``ValueError`` for an int8 model; EigenCAM and AblationCAM run
  through the int8 backbone's taps.
* ``infer_val`` with static scales and no statistics file raises
  ``FileNotFoundError``; ``quant_calibrate`` -> ``infer_val`` (static,
  multiscale server) and a dynamic ``infer_val`` through the per-image
  ``InferenceEngine`` write their PNGs on a synthetic VOC.
"""

import os
import textwrap
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synthetic_voc import make_synthetic_voc
from tests.torch_parity import (
    jax_model_and_random_variables,
    port_model_from_jax,
)


@pytest.fixture(autouse=True)
def _reset_cfgs():
    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    reset_jax_cfg()
    yield
    reset_cfg()
    reset_jax_cfg()


@pytest.fixture(scope="module")
def flagship_variables():
    """Numpy-seeded float32 weights of the flagship (JAX tree)."""
    return jax_model_and_random_variables(seed=1)[1]


def _port_net(model, backbone, dtype, quant_act="dynamic"):
    from wseg_tpu_torch.config import _default_cfg

    net = _default_cfg().NET
    net.MODEL, net.BACKBONE, net.DTYPE = model, backbone, dtype
    net.QUANT_ACT = quant_act
    return net


# a model each backbone can carry (WRN38's flagship; the paper's ae on
# the others: its ASPP decoder is head and stays bf16)
STATE_MODELS = {"resnet38": "CAM_CASA_WGAP_tf", "resnet50": "ae",
                "vgg16": "ae"}


@pytest.mark.parametrize("backbone", ["resnet38", "resnet50", "vgg16"])
def test_int8_state_dict_matches_bf16(backbone):
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import QuantConv

    name = STATE_MODELS[backbone]
    m16 = get_model(_port_net(name, backbone, "bfloat16"))
    m32 = get_model(_port_net(name, backbone, "float32"))
    sd16, sd32 = m16.state_dict(), m32.state_dict()
    for act in ("dynamic", "static"):
        m8 = get_model(_port_net(name, backbone, "int8", act))
        assert any(isinstance(m, QuantConv) for m in m8.modules())
        assert all(isinstance(m, QuantConv) for m in m8._backbone.modules()
                   if isinstance(m, torch.nn.Conv2d))
        bb_keys = {f"{n}.{k}" for n in m8._backbone._modules
                    for k in m8._backbone._modules[n].state_dict()}
        sd8 = m8.state_dict()
        assert list(sd8) == list(sd16)
        for k, v in sd8.items():
            assert v.shape == sd16[k].shape, k
            assert v.dtype == (sd32[k] if k in bb_keys else sd16[k]).dtype, k
        m8.load_state_dict(sd16, strict=True)
        for k in bb_keys:
            assert torch.equal(m8.state_dict()[k], sd16[k].float()), k
        m8.load_state_dict(sd32, strict=True)
        for k, v in m8.state_dict().items():
            assert torch.equal(v, sd32[k] if k in bb_keys
                               else sd32[k].to(sd16[k].dtype)), k


def _jax_int8(variables, x, static_stats=None):
    """JAX's int8 flagship forward (dynamic, or static on the given
    {port conv name: amax})."""
    import flax.traverse_util as trav

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.models import get_model
    from wseg_tpu_torch.utils.convert import port_name

    net = jax_default_cfg().NET
    net.MODEL, net.BACKBONE = "CAM_CASA_WGAP_tf", "resnet38"
    net.DTYPE = "int8"
    net.QUANT_ACT = "static" if static_stats else "dynamic"
    jm = get_model(net, num_classes=21)
    v = dict(variables)
    if static_stats:
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": key, "dropout": key, "sg": key},
            jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))
        v["quant_stats"] = trav.unflatten_dict({
            path: jnp.asarray(static_stats[
                port_name(path[:-1] + ("kernel",))[:-len(".weight")]])
            for path in trav.flatten_dict(shapes["quant_stats"])})
    fwd = jax.jit(lambda v, x: jm.apply(
        v, x, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, _: m.name == "backbone"))
    # XLA's own arithmetic: no excess precision between fused bf16 ops,
    # no algebraic rewrites (the eager forward's numerics, in one compile)
    out, inter = fwd.lower(v, jnp.asarray(x)).compile(compiler_options={
        "xla_allow_excess_precision": False,
        "xla_disable_hlo_passes": "algsimp"})(v, jnp.asarray(x))
    taps = inter["intermediates"]["backbone"]["__call__"][0]
    return (np.asarray(out.cls, np.float32),
            np.asarray(out.masks, np.float32),
            {k: np.asarray(t.astype(jnp.float32)) for k, t in taps.items()})


@pytest.mark.parametrize("act", ["dynamic", "static"])
def test_int8_flagship_tracks_jax_int8(act, flagship_variables):
    from wseg_tpu_torch.models.backbones.common import (
        calibrating,
        quant_stats,
    )

    variables = flagship_variables
    rng = np.random.RandomState(2)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    model = port_model_from_jax(variables, dtype="int8")
    stats = None
    if act == "static":
        from wseg_tpu_torch.models import get_model
        from wseg_tpu_torch.utils.convert import state_dict_from_jax

        net = _port_net("CAM_CASA_WGAP_tf", "resnet38", "int8", "static")
        model = get_model(net, num_classes=21)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        calib = rng.randn(3, 64, 64, 3).astype(np.float32)
        with torch.no_grad(), calibrating(model):
            model(torch.from_numpy(calib))
        stats = quant_stats(model)
        assert len(stats) == 42
    taps = {}
    hook = model._backbone.register_forward_hook(
        lambda mod, args, out: taps.update(out))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    hook.remove()
    cls, masks = out.cls.float().numpy(), out.masks.float().numpy()
    jcls, jmasks, jtaps = _jax_int8(variables, x, stats)
    assert set(taps) == set(jtaps)
    for k, t in taps.items():
        np.testing.assert_array_equal(
            t.float().permute(0, 2, 3, 1).numpy(), jtaps[k], k)
    agree = float((masks.argmax(-1) == jmasks.argmax(-1)).mean())
    assert agree >= 0.98, agree
    np.testing.assert_allclose(cls, jcls, atol=6e-2, rtol=0)
    assert float(np.abs(jcls).mean()) > 1.0


def test_int8_tracks_port_bf16(flagship_variables):
    """JAX's bounds on the quantization error (tests/test_quant.py)."""
    variables = flagship_variables
    x = torch.from_numpy(
        np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    m16 = port_model_from_jax(variables, dtype="bfloat16")
    m8 = port_model_from_jax(variables, dtype="int8")
    with torch.no_grad():
        o16, o8 = m16(x), m8(x)
    agree = float((o16.masks.argmax(-1) == o8.masks.argmax(-1))
                  .float().mean())
    assert agree > 0.9, agree
    c16 = o16.cls.float().numpy().ravel()
    c8 = o8.cls.float().numpy().ravel()
    dev = np.abs(c16 - c8).mean() / (np.abs(c16).mean() + 1e-6)
    assert dev < 0.25, dev
    assert np.corrcoef(c16, c8)[0, 1] > 0.9


def test_int8_refusals_and_forward_only_cams():
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.trainer import DecTrainer
    from wseg_tpu_torch.gradcam import CAM_METHODS
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.train_SEAM import SEAMTrainer

    net = _port_net("bsl", "vgg16", "int8")
    with pytest.raises(ValueError, match="inference-only"):
        get_model(net, train=True)
    cfg.NET.DTYPE = "int8"
    for trainer in (DecTrainer, SEAMTrainer):
        with pytest.raises(ValueError, match="inference-only"):
            trainer(types.SimpleNamespace(device="cpu"))
    model = get_model(net)
    assert model.backbone_dtype == "int8"
    forward_only = {"eigencam", "scorecam", "ablationcam"}
    for name, engine in CAM_METHODS.items():
        if name in forward_only:
            continue
        with pytest.raises(ValueError, match="int8"):
            engine(model) if name in ("fullgrad", "guidedbackprop") \
                else engine(model, "conv6")
    img = np.random.RandomState(4).rand(1, 32, 32, 3).astype(np.float32)
    engines = {n: CAM_METHODS[n](model, "conv6") for n in forward_only}
    for name in ("eigencam", "ablationcam"):
        cam = engines[name](img, 3)
        assert cam.shape == (1, 32, 32) and np.isfinite(cam).all()
        assert cam.min() >= 0.0 and cam.max() <= 1.0 + 1e-6


def _write_cfg(tmp_path, root):
    p = tmp_path / "cfg.yaml"
    p.write_text(textwrap.dedent(f"""\
        NET:
          BACKBONE: "resnet38"
          MODEL: "CAM_CASA_WGAP_tf"
        TEST:
          METHOD: "multiscale"
          DATA_ROOT: "{root}"
          FLIP: True
          BATCH_SIZE: 2
          PAD_SIZE: [96, 96]
          PAD_ALIGN: 32
          SCALES: [1]
          USE_GT_LABELS: False
          BG_POW: 3
          CRF_DTYPE: "float32"
        """))
    return str(p)


def _argv(tmp_path, cfg_file, root, ckpt, out):
    return ["--cfg", cfg_file, "--resume", ckpt,
            "--snapshot-dir", str(tmp_path / "snap"),
            "--logdir", str(tmp_path / "logs"), "--workers", "2",
            "--infer-list", os.path.join(root, "val_voc.txt"),
            "--mask-output-dir", str(tmp_path / out), "--device", "cpu"]


def test_infer_val_static_needs_stats(tmp_path):
    from wseg_tpu_torch import infer_val

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=1)
    cfg_file = _write_cfg(tmp_path, root)
    argv = _argv(tmp_path, cfg_file, root, "", "out")
    for stats in ([], ["NET.QUANT_STATS", str(tmp_path / "missing.pt")]):
        with pytest.raises(FileNotFoundError,
                           match="NET.QUANT_ACT=static needs "
                                 "NET.QUANT_STATS"):
            infer_val.main(argv + ["--set", "NET.MODEL", "bsl",
                                   "NET.BACKBONE", "vgg16",
                                   "NET.DTYPE", "int8",
                                   "NET.QUANT_ACT", "static", *stats])
    assert not (tmp_path / "out_0").exists()


def test_calibrate_then_serve_int8(tmp_path, capsys):
    """quant_calibrate writes the statistics file that infer_val's
    static int8 mode loads (batched multiscale server); the dynamic mode
    serves through the per-image engine (``TEST.DEVICE_MERGE False``)."""
    from PIL import Image

    from wseg_tpu_torch import infer_val, quant_calibrate
    from wseg_tpu_torch.config import reset_cfg

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=2)
    cfg_file = _write_cfg(tmp_path, root)
    _, variables = jax_model_and_random_variables(seed=11, size=32)
    ckpt = str(tmp_path / "port.pth")
    torch.save(port_model_from_jax(variables).state_dict(), ckpt)
    stats_file = str(tmp_path / "stats.pt")
    stats = quant_calibrate.main([
        "--out", stats_file, "--images", os.path.join(root, "JPEGImages"),
        "--n", "2", "--snapshot", ckpt, "--cfg", cfg_file,
        "--device", "cpu"])
    assert "wrote " + stats_file + " 42 conv stats" in capsys.readouterr().out
    saved = torch.load(stats_file, weights_only=True)
    assert set(saved) == set(stats) and all(
        v.dtype == torch.float32 and v.dim() == 1 and v.max() > 0
        for v in saved.values())
    runs = {"static": ["NET.QUANT_ACT", "static",
                       "NET.QUANT_STATS", stats_file],
            "dynamic": ["TEST.DEVICE_MERGE", "False"]}
    for out, sets in runs.items():
        reset_cfg()
        infer_val.main(_argv(tmp_path, cfg_file, root, ckpt, out)
                       + ["--set", "NET.DTYPE", "int8", *sets])
        for sub in ("no_crf", "crf"):
            names = sorted(os.listdir(tmp_path / f"{out}_0" / sub))
            assert len(names) == 2
            for n in names:
                a = np.asarray(Image.open(tmp_path / f"{out}_0" / sub / n))
                assert a.shape == (60, 80) and a.max() <= 20
    assert "Loaded int8 activation calibration" in capsys.readouterr().out
