"""The port's SEAM train step and ``train_SEAM`` CLI against the JAX
package (float32, CPU, the same numpy-seeded weights and batch).

* Two SEAM steps for every (``mask_on``, ``er_on``) pair on the flagship
  head (``CAM_CASA_WGAP_tf``) and on ``bsl`` (classic CAM: no refined
  masks, so ``loss_er`` is logged and never optimised), against
  ``make_seam_train_step`` with ``make_optimizer``'s transform, the
  flagship head on ResNet-50, ``bsl`` on VGG16.  The JAX step is compiled
  once per head (the gates are traced), so its four pairs come from one
  cached run.  Metrics of each step: 1e-4 of the value or of 1 (the
  classic CAM head's ``loss_fg`` is left out, as in
  ``tests/test_torch_zoo_train.py``); every parameter after the steps:
  each tensor's update within ``REL`` of its largest update plus two
  float32 spacings of its values; frozen tensors bit-equal.  Dropout is
  off in both (JAX's ``flax.linen.Dropout`` patched to the identity,
  the port's at p = 0): the packages draw different bits.
* The flagship head's batch has one labelled class whose fc8 column and
  the background's are scaled so that its mask loss is live; every
  refined value keeps more than 2e-5 from its pseudo-GT threshold before
  each step, at both scales (measured on the JAX side), since a value
  within float noise of it would flip between the packages.
* ``ae`` (VGG16, ``SG_PSI`` 0): the live BatchNorms' running statistics
  after two SEAM steps against JAX's ``batch_stats``, which keep the
  first forward's statistics only; with the second forward updating
  them too (``frozen_running_stats`` patched out) they do not match.
* ``python -m wseg_tpu_torch.train_SEAM --device cpu`` and the root
  ``train_SEAM.py`` on one synthetic VOC (``CAM_CASA_WGAP_v6`` on
  VGG16, crop 48, PAMR dilations 1-2), both resumed from one
  checkpoint (the same weights as a JAX msgpack and a port ``.pth``):
  validation runs first and prints the same mAP (to the printed 3
  digits), both train an epoch and save a checkpoint.
"""

import contextlib
import io
import os
import re
import shutil
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

PAIRS = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]
# the flagship head's batch seed and labelled class: its mask loss is
# live in the first step and its refined masks keep > 2e-5 from their
# thresholds at both scales before each step (checked)
BATCH_SEED = {"CAM_CASA_WGAP_tf": 5}
CLS = 8
# the flagship head on ResNet-50 (WRN38's 104M parameters cost ~15 s a
# case on the CPU; chip_smoke.py runs it at full width); bsl and ae on
# VGG16
BACKBONES = {"CAM_CASA_WGAP_tf": "resnet50", "bsl": "resnet50", "ae": "vgg16"}
# the CLIs' head: PAMR-refined like the flagship's, on VGG16
CLI_MODEL = "CAM_CASA_WGAP_v6"
SIZE = 64
# update tolerance: the port's updates were measured within 1.7e-3
# (flagship, ER on; 2.1e-4 with ER off) and 3.0e-3 (bsl; 4.3e-4 with
# ER on) of a tensor's largest update from JAX's before the two float32
# spacings, the largest on tensors whose updates are near those spacings
REL = {"CAM_CASA_WGAP_tf": 5e-3, "bsl": 1e-3}


@pytest.fixture(autouse=True)
def _reset_cfgs():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _no_jax_dropout():
    import flax.linen as fnn

    return mock.patch.object(fnn.Dropout, "__call__",
                             lambda self, x, *a, **kw: x)


def _net(cfg_net, name):
    cfg_net.MODEL, cfg_net.BACKBONE, cfg_net.DTYPE = name, BACKBONES[name], \
        "float32"
    cfg_net.WEIGHT_DECAY, cfg_net.LR = 0.0005, 0.001
    return cfg_net


def _min_margin(masks_dec) -> float:
    m = np.asarray(masks_dec)
    cut = np.full(m.shape[-1], 0.6, np.float32)
    cut[0] = 0.7
    thresh = np.maximum(m.max(axis=(1, 2), keepdims=True) * cut, 0.2)
    return float(np.abs(m - thresh).min())


def _case(name, seed=1, sg_psi=0.3):
    """JAX model, variables and batch (uint8 images, labels).  The
    flagship head's batch has one labelled class, whose fc8 column and
    the background's are scaled so that both win somewhere (the other
    classes' columns made negative): its mask loss is then live."""
    from tests.torch_parity import jax_zoo_model_and_random_variables

    jm, variables = jax_zoo_model_and_random_variables(
        name, BACKBONES[name], seed=seed, size=SIZE, sg_psi=sg_psi)
    rng = np.random.RandomState(BATCH_SEED.get(name, 3))
    image = (rng.rand(2, SIZE, SIZE, 3) * 255).astype(np.uint8)
    labels = np.zeros((2, 20), np.float32)
    if name in BATCH_SEED:
        labels[:, CLS - 1] = 1.0
        k = np.array(variables["params"]["fc8"]["kernel"])
        k0 = k.copy()
        k[..., 1:] = -np.abs(k0[..., 1:])
        k[..., CLS] = k0[..., CLS] * 3.0
        k[..., 0] = k0[..., 3] * 3.0
        variables["params"]["fc8"]["kernel"] = k
    else:
        for i in range(2):
            labels[i, rng.choice(20, size=rng.randint(1, 3),
                                 replace=False)] = 1
    return jm, variables, {"image": image, "labels": labels}


def _jax_steps(name, variables, jm, batch, pairs, steps=2, sg_psi=0.3):
    """Per pair: the metrics of ``steps`` JAX SEAM steps from
    ``variables`` and the variables after them (numpy)."""
    import jax
    import jax.numpy as jnp

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.engine.seam import make_seam_train_step
    from wseg_tpu.engine.train_loop import (
        _normalise_batch_image,
        create_train_state,
    )
    from wseg_tpu.ops.resize import resize_bilinear
    from wseg_tpu.parallel.optim import make_optimizer as jax_optimizer

    net = _net(jax_default_cfg().NET, name)
    net.SG_PSI = sg_psi
    tx, _ = jax_optimizer(net, BACKBONES[name], variables["params"])
    step = make_seam_train_step(jm, tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    img, raw = _normalise_batch_image(jb["image"])
    half = (SIZE // 2, SIZE // 2)
    img2 = resize_bilinear(img, half, align_corners=True)
    raw2 = resize_bilinear(raw, half, align_corners=True)
    refined = jax.jit(lambda v, x, r: jm.apply(v, x, r, jb["labels"],
                                               train=False).masks_dec)
    out = {}
    with _no_jax_dropout():
        for pair in pairs:
            state = create_train_state(jm, tx, None, None,
                                       variables=variables)
            metrics = []
            for _ in range(steps):
                v = {"params": state.params}
                if state.batch_stats:
                    v["batch_stats"] = state.batch_stats
                if name in BATCH_SEED:
                    for x, r in ((img, raw), (img2, raw2)):
                        assert _min_margin(refined(v, x, r)) > 2e-5
                state, m = step(state, jb, jax.random.PRNGKey(0),
                                jnp.float32(pair[0]), jnp.float32(pair[1]))
                metrics.append({k: float(x) for k, x in m.items()})
            new = {"params": jax.device_get(state.params)}
            if state.batch_stats:
                new["batch_stats"] = jax.device_get(state.batch_stats)
            out[pair] = (metrics, new)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's results per head, computed once per module (one compile)."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, variables, batch = _case(name)
            cache[name] = (variables, batch,
                           _jax_steps(name, variables, jm, batch, PAIRS))
        return cache[name]
    return get


def _port_model(variables, name, sg_psi=0.3):
    from tests.torch_parity import no_port_dropout, port_zoo_model_from_jax

    model = port_zoo_model_from_jax(variables, name, BACKBONES[name],
                                    train=True, sg_psi=sg_psi)
    no_port_dropout(model)
    return model


def _port_steps(model, name, batch, pair, steps=2):
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.seam import seam_train_step
    from wseg_tpu_torch.optim import make_optimizer

    optimizer, labels = make_optimizer(_net(cfg.NET, name), model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [seam_train_step(model, optimizer, tb, pair[0], pair[1],
                           device_jitter=False) for _ in range(steps)]
    return got, labels


@pytest.mark.parametrize("mask_on,er_on", PAIRS)
@pytest.mark.parametrize("name", ["CAM_CASA_WGAP_tf", "bsl"])
def test_two_seam_steps_match_jax(name, mask_on, er_on, jax_runs):
    from wseg_tpu_torch.optim import FROZEN
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    variables, batch, runs = jax_runs(name)
    want, new_vars = runs[(mask_on, er_on)]
    model = _port_model(variables, name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got, labels = _port_steps(model, name, batch, (mask_on, er_on))
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k, v in w.items():
            if k == "loss_fg" and name == "bsl":
                continue    # a mean of masks divided by channel maxima
            assert abs(float(g[k]) - v) <= 1e-4 * max(1.0, abs(v)), (k, v)
    assert want[0]["loss_er"] > 0
    if name == "bsl":
        # ER never reaches bsl's loss: loss is the classification loss
        assert "loss_mask" not in want[0]
        assert abs(want[0]["loss"] - want[0]["loss_cls"]) < 1e-6
    else:
        assert want[0]["loss_mask"] > 0, "the mask loss must be live"

    after = model.state_dict()
    want_sd = state_dict_from_jax(new_vars)
    assert set(want_sd) == set(after)
    for key, w in want_sd.items():
        d_ours = (after[key] - before[key]).numpy()
        d_want = w.numpy() - before[key].numpy()
        scale = float(np.abs(d_want).max())
        if labels.get(key, FROZEN) == FROZEN:
            assert torch.equal(after[key], before[key]), key
            continue
        assert scale > 0, key
        ulp = float(np.spacing(np.abs(before[key].numpy()).max()))
        np.testing.assert_allclose(d_ours, d_want, rtol=0,
                                   atol=REL[name] * scale + 2 * ulp,
                                   err_msg=key)


def test_ae_running_statistics_match_jax_batch_stats(monkeypatch):
    """Two SEAM steps of ``ae`` (live BatchNorms in the decoder): the
    running statistics move as JAX's ``batch_stats`` do (the first
    forward's only); updating them in the half-scale forward too
    breaks that."""
    from wseg_tpu_torch.engine import seam
    from wseg_tpu_torch.models.backbones.common import BatchNorm

    jm, variables, batch = _case("ae", sg_psi=0.0)
    batch["labels"][:] = 0.0
    batch["labels"][:, [4, 9]] = 1.0
    want = _jax_steps("ae", variables, jm, batch, [(1.0, 1.0)],
                      sg_psi=0.0)[(1.0, 1.0)][1]["batch_stats"]
    from wseg_tpu_torch.utils.convert import state_dict_from_jax
    want_sd = state_dict_from_jax({"params": {}, "batch_stats": want})
    assert want_sd and all(k.endswith(("running_mean", "running_var"))
                           for k in want_sd)

    def running(model):
        return {f"{n}.{b}": getattr(m, b).clone()
                for n, m in model.named_modules()
                if isinstance(m, BatchNorm)
                for b in ("running_mean", "running_var")}

    def err(model):
        got = running(model)
        assert set(got) == set(want_sd)
        start = state_dict_from_jax(variables)
        return max(float(((got[k] - w).abs().max()
                          / (w - start[k]).abs().max()))
                   for k, w in want_sd.items())

    model = _port_model(variables, "ae", sg_psi=0.0)
    _port_steps(model, "ae", batch, (1.0, 1.0))
    # relative to each buffer's movement over the two steps
    assert err(model) <= 1e-3, err(model)

    monkeypatch.setattr(seam, "frozen_running_stats",
                        lambda model: contextlib.nullcontext())
    model = _port_model(variables, "ae", sg_psi=0.0)
    _port_steps(model, "ae", batch, (1.0, 1.0))
    assert err(model) > 0.1


def _write_cfg(tmp_path, root):
    p = tmp_path / "cfg.yaml"
    p.write_text(textwrap.dedent(f"""\
        DATASET:
          CROP_SIZE: 48
          ROOT: "{root}"
          FILENAME: "train_augvoc"
        TRAIN:
          BATCH_SIZE: 2
          NUM_EPOCHS: 0
          PRETRAIN: 0
        NET:
          BACKBONE: "vgg16"
          MODEL: "{CLI_MODEL}"
          LR: 0.0005
          DTYPE: "float32"
          PAMR_KERNEL: [1, 2]
          PAMR_ITER: 2
          PAMR_IMPL: "lax"
          PRE_WEIGHTS_PATH: "{root}/no_such_weights.pth"
        TEST:
          DATA_ROOT: "{root}"
        """))
    return str(p)


def test_train_seam_cli_matches_jax(tmp_path, capsys):
    import flax.serialization
    import importlib.util

    from tests.synthetic_voc import make_synthetic_voc
    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )
    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch import train_SEAM
    from wseg_tpu_torch.config import reset_cfg

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=4, n_val=3)
    cfg_file = _write_cfg(tmp_path, root)
    suffix = "e000Xs-9.000"
    snap = tmp_path / "snap"
    run_dir = snap / "pascal_voc" / "seam" / "r"
    run_dir.mkdir(parents=True)
    _, variables = jax_zoo_model_and_random_variables(
        CLI_MODEL, "vgg16", seed=2, size=48)
    (run_dir / f"model_enc_{suffix}.msgpack").write_bytes(
        flax.serialization.to_bytes(variables["params"]))
    torch.save(port_zoo_model_from_jax(variables, CLI_MODEL, "vgg16",
                                       train=True).state_dict(),
               str(run_dir / f"model_enc_{suffix}.pth"))
    argv = ["--dataset", "pascal_voc", "--cfg", cfg_file, "--exp", "seam",
            "--run", "r", "--snapshot-dir", str(snap),
            "--logdir", str(tmp_path / "logs"), "--workers", "0",
            "--resume", suffix]

    def run(fn):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            fn()
        out = text.getvalue()
        maps = [float(v) for v in re.findall(r"mAP: ([-0-9.]+)", out)]
        assert len(maps) == 1, out[-2000:]
        return maps[0], out

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "root_train_SEAM", os.path.join(repo, "train_SEAM.py"))
    root_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_cli)
    reset_jax_cfg()
    jax_map, _ = run(lambda: root_cli.main(argv))
    jax_saved = sorted(f for f in os.listdir(run_dir)
                       if f.endswith(".msgpack") and suffix not in f)

    reset_cfg()
    trainer = None

    def port():
        nonlocal trainer
        trainer = train_SEAM.main(argv + ["--device", "cpu"])
    port_map, out = run(port)
    assert abs(port_map - jax_map) <= 1e-3, (port_map, jax_map)
    assert "loss_er" in out and "Validation" in out
    assert out.index("mAP:") < out.index("Epoch[0] Loss")
    assert jax_saved and len(trainer.checkpoint.checkpoints) >= 2
    assert os.path.isfile(run_dir / f"model_enc_"
                          f"{trainer.checkpoint.checkpoints[-1]}.pth")
    capsys.readouterr()
    shutil.rmtree(snap)     # ~0.7 GB of checkpoints


@pytest.mark.parametrize("name", ["CAM_CASA_WGAP_tf", "CAM_CASA_WGAP_tf_v2"])
def test_head_fc7_on_vgg16_is_refused(name):
    """ROADMAP C3: the fc7 heads on VGG16.  JAX keeps the backbone's fc7
    (its biased 1x1 conv) and the head's fc7 apart
    (``params["backbone"]["fc7"]`` and ``params["fc7"]``); the port keeps
    the reference's flat state_dict names, where both are ``fc7``, so
    ``get_model`` refuses the pair instead of dropping VGG16's fc7 from
    the state_dict."""
    from tests.torch_parity import jax_zoo_model_and_random_variables
    from wseg_tpu_torch.config import _default_cfg
    from wseg_tpu_torch.models import get_model

    _, variables = jax_zoo_model_and_random_variables(name, "vgg16",
                                                      size=32)
    params = variables["params"]
    assert "bias" in params["backbone"]["fc7"]
    assert "bias" not in params["fc7"]
    net = _default_cfg().NET
    net.MODEL, net.BACKBONE = name, "vgg16"
    with pytest.raises(ValueError, match="C3"):
        get_model(net, num_classes=21)
    net.BACKBONE = "resnet50"
    assert "fc7.weight" in get_model(net, num_classes=21).state_dict()
