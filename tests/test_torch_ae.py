"""The port's SoftMaxAE (``NET.MODEL ae``) on ResNet-50/101 and VGG16 vs
the JAX package, float32 on the CPU, same weights (numpy-seeded, carried
over by ``state_dict_from_jax``) and numpy-seeded inputs.

Dropout and the stochastic gate draw different bits in the two packages
(a torch.Generator against JAX keys).  So train mode is held in two
ways: with ``NET.SG_PSI 0`` (the gate then returns the deep branch
exactly on both sides) and dropout switched off in the test only (JAX's
``flax.linen.Dropout`` patched to the identity, the port's dropout ``p``
set to 0), which covers batch-statistics BatchNorm, its gradient and the
running-statistics updates; and in eval mode (JAX ``train=False`` with
labels), which covers the running-statistics BN and the gate's blend.
The gate's and dropout's own draws have statistical tests.

Card-only cases are marked ``gpu``; they and the module itself import
no JAX (the CPU parity tests import it inside).
"""

import os

import numpy as np
import pytest
import torch

SIZE = 65            # odd, as the configs' 321 crop: odd feature planes
CLS = 5              # the labelled class of the train batches (channel)


@pytest.fixture(autouse=True)
def _reset_cfgs():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax.linen.Dropout as the identity (test-only; nothing in the JAX
    package changes)."""
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **kw: x)


def _no_port_dropout(model):
    from wseg_tpu_torch.models.backbones.common import Dropout

    n = 0
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
            n += 1
    return n


def _check(ours, ref, rel=2e-5, name=""):
    """max |ours - ref| <= rel * max |ref|: float32 through up to 101
    layers, summed in another order (the rounding scales with the
    tensor's magnitude)."""
    ref = np.asarray(ref, np.float32)
    ours = np.asarray(ours, np.float32)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-6), (name, err)


def _image(seed=0, b=2, size=SIZE):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(
        np.float32)


def _batch(seed=17, b=2):
    rng = np.random.RandomState(seed)
    image = (rng.rand(b, SIZE, SIZE, 3) * 255).astype(np.uint8)
    labels = np.zeros((b, 20), np.float32)
    labels[:, CLS - 1] = 1.0
    jitter = np.array([[1.1, 0.9, 1.2, 0.0, 2, 0, 3, 1, 1.0],
                       [0.8, 1.25, 0.7, 0.0, 1, 3, 0, 2, 1.0]],
                      np.float32)[:b]
    return {"image": image, "labels": labels, "jitter": jitter}


# --------------------------------------------------------------- backbones
@pytest.mark.parametrize("name", ["resnet50", "vgg16", "resnet101"])
def test_backbone_taps_match_jax(name):
    """Full-depth taps on a 65x65 image; rel 2e-5 of each tap's max."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import random_variables

    from wseg_tpu.models.backbones import get_backbone as jax_backbone
    from wseg_tpu_torch.models.backbones import get_backbone
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    jm = jax_backbone(name, jnp.float32)
    x = _image(seed=3)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    variables = random_variables(shapes, seed=4)
    want = jm.apply(variables, jnp.asarray(x))
    bb = get_backbone(name).eval()
    bb.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = bb(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want) == {"conv3", "conv6"}
    stride6 = 8 if name == "vgg16" else 16
    for tap, stride in (("conv3", 4), ("conv6", stride6)):
        g = got[tap].permute(0, 2, 3, 1).numpy()
        assert g.shape[1] == -(-SIZE // stride), (tap, g.shape)
        _check(g, want[tap], name=f"{name} {tap}")


def test_resnet_names_are_torchvisions():
    from wseg_tpu_torch.models.backbones import ResNet50, VGG16

    names = set(ResNet50().state_dict())
    for key in ("conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
                "layer1.0.downsample.0.weight",
                "layer1.0.downsample.1.running_mean", "layer4.2.bn3.bias",
                "layer2.3.conv2.weight"):
        assert key in names, key
    assert not any(k.startswith("layer4.0.downsample.2") for k in names)
    vgg = set(VGG16().state_dict())
    assert {"conv1_1.weight", "conv5_3.bias", "fc6.weight",
            "fc7.bias"} <= vgg and len(vgg) == 30


# ------------------------------------------------------------- small parts
@pytest.mark.parametrize("use_scale", [True, False])
def test_affine_norm_matches_jax(use_scale):
    """Exact: one multiply-add per element on both sides."""
    import jax
    import jax.numpy as jnp

    from wseg_tpu.models.backbones.common import AffineNorm as JaxAffine
    from wseg_tpu_torch.models.backbones.common import AffineNorm

    x = np.random.RandomState(0).randn(2, 5, 7, 16).astype(np.float32)
    jm = JaxAffine(16, use_scale=use_scale)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = AffineNorm(16, use_scale=use_scale)
    if use_scale:
        rng = np.random.RandomState(1)
        scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
        bias = (0.1 * rng.randn(16)).astype(np.float32)
        v = {"params": {"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)}}
        port.weight.data = torch.from_numpy(scale)
        port.bias.data = torch.from_numpy(bias)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert set(port.state_dict()) == (
        {"weight", "bias", "running_mean", "running_var"} if use_scale
        else {"running_mean", "running_var"})


def test_stochastic_gate_eval_matches_jax():
    import jax.numpy as jnp

    from wseg_tpu.ops.sg import stochastic_gate as jax_gate
    from wseg_tpu_torch.ops.sg import stochastic_gate

    rng = np.random.RandomState(0)
    x1, x2 = (rng.randn(2, 3, 4, 5).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_gate(jnp.asarray(x1), jnp.asarray(x2), 0.3,
                               train=False))
    got = stochastic_gate(torch.from_numpy(x1), torch.from_numpy(x2), 0.3,
                          train=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stochastic_gate_train_statistics():
    """Each element is the corrected deep branch with probability 1 - psi
    (within 4 sigma), else the shallow one; the mean is x1; a seeded
    generator repeats its draws; psi 0 returns x1 exactly."""
    from wseg_tpu_torch.ops.sg import StochasticGate

    psi = 0.3
    gate = StochasticGate(psi).train()
    x1 = torch.full((64, 32, 9, 9), 2.0)
    x2 = torch.full((64, 32, 9, 9), -1.0)
    gate.generator = torch.Generator().manual_seed(0)
    y = gate(x1, x2)
    deep = (2.0 - psi * -1.0) / (1.0 - psi)
    assert set(torch.unique(y).tolist()) == {
        torch.tensor(deep).item(), -1.0}
    frac = float((y != -1.0).float().mean())
    sigma = (psi * (1 - psi) / y.numel()) ** 0.5
    assert abs(frac - (1 - psi)) < 4 * sigma, frac
    assert abs(float(y.mean()) - 2.0) < 4 * sigma * (deep + 1.0)
    gate.generator = torch.Generator().manual_seed(0)
    assert torch.equal(gate(x1, x2), y)
    assert torch.equal(StochasticGate(0.0).train()(x1, x2), x1)
    assert torch.equal(gate.eval()(x1, x2), 0.7 * x1 + 0.3 * x2)


def test_dropout_draws_from_its_generator():
    from wseg_tpu_torch.models.backbones.common import Dropout

    d = Dropout(0.5).train()
    d.generator = torch.Generator().manual_seed(0)
    x = torch.ones(64, 32, 9, 9)
    y = d(x)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    frac = float((y == 0).float().mean())
    assert abs(frac - 0.5) < 4 * (0.25 / y.numel()) ** 0.5
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)


@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_matches_flax(affine):
    """A live BN at a small batch (n = B*H*W = 2*3*5 = 30): output and
    running statistics after two train steps against ``flax.linen.
    BatchNorm`` (momentum 0.9) to 1e-6, then eval mode on the running
    averages.  ``nn.BatchNorm2d``'s unbiased running variance is off by
    n/(n-1) (~3%), far outside that tolerance."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from wseg_tpu_torch.models.backbones.common import BatchNorm

    rng = np.random.RandomState(0)
    xs = [(rng.randn(2, 3, 5, 8) * 2 + 1).astype(np.float32)
          for _ in range(2)]
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, use_scale=affine, use_bias=affine)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    port = BatchNorm(8, affine=affine).train()
    if affine:
        scale = (1 + 0.1 * rng.randn(8)).astype(np.float32)
        bias = (0.1 * rng.randn(8)).astype(np.float32)
        v = {"params": {"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)},
             "batch_stats": v["batch_stats"]}
        port.weight.data = torch.from_numpy(scale)
        port.bias.data = torch.from_numpy(bias)
    torch_bn = torch.nn.BatchNorm2d(8, affine=False).train()
    for x in xs:
        want, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {**v, **upd}
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)
    stats = v["batch_stats"]
    for ours, key in ((port.running_mean, "mean"),
                      (port.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(stats[key]),
                                   atol=1e-6, rtol=1e-6)
        assert ours.dtype == torch.float32
    gap = float((torch_bn.running_var - port.running_var).abs().max())
    assert gap > 1e-3, gap
    x = xs[0]
    jm_eval = jm.clone(use_running_average=True)
    want = jm_eval.apply(v, jnp.asarray(x))
    got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- decoder
@pytest.mark.parametrize("train", [False, True])
def test_decoder_matches_jax(train, request):
    """``SoftMaxAEDecoder`` on random taps (conv3 (2, 17, 17, 256), conv6
    (2, 5, 5, 2048), resnet50's at a 65 crop): the logits (rel 2e-5).
    Train mode (psi 0, no dropout) adds the gradient of sum(logits * G)
    for a random G with respect to every parameter and both taps --
    batch-statistics BatchNorm's backward -- (rel 5e-5 of each tensor's
    largest gradient) and the running statistics after the step
    (rel 2e-5)."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import random_variables

    from wseg_tpu.models.heads.softmax_ae import (
        SoftMaxAEDecoder as JaxDecoder,
    )
    from wseg_tpu_torch.models.heads.softmax_ae import SoftMaxAEDecoder
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    if train:
        request.getfixturevalue("no_jax_dropout")
    psi = 0.0 if train else 0.3
    rng = np.random.RandomState(2)
    c3 = np.maximum(rng.randn(2, 17, 17, 256), 0).astype(np.float32)
    c6 = np.maximum(rng.randn(2, 5, 5, 2048), 0).astype(np.float32)
    g = rng.randn(2, 17, 17, 20).astype(np.float32)
    jm = JaxDecoder(21, psi)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key, "sg": key}, jnp.asarray(c3),
        jnp.asarray(c6)))
    variables = random_variables(shapes, seed=6)

    def jax_loss(params, a3, a6):
        y, upd = jm.apply({**variables, "params": params}, a3, a6,
                          train=True, rngs={"dropout": key, "sg": key},
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    if train:
        (grads, (want, upd)) = jax.jit(jax.grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True))(
            variables["params"], jnp.asarray(c3), jnp.asarray(c6))
    else:
        want = jm.apply(variables, jnp.asarray(c3), jnp.asarray(c6))

    # the JAX decoder's paths lack the model's "decoder" level
    sd = state_dict_from_jax({col: {"decoder": tree}
                              for col, tree in variables.items()})
    port = SoftMaxAEDecoder(21, 2048, sg_psi=psi)
    port.load_state_dict(sd, strict=True)
    port.train(train)
    if train:
        assert _no_port_dropout(port) == 3
    t3 = torch.from_numpy(c3).permute(0, 3, 1, 2).requires_grad_(train)
    t6 = torch.from_numpy(c6).permute(0, 3, 1, 2).requires_grad_(train)
    got = port(t3, t6).permute(0, 2, 3, 1)
    _check(got.detach().numpy(), want, name="logits")
    if not train:
        return
    (got * torch.from_numpy(g)).sum().backward()
    g_params, g3, g6 = grads
    want_g = state_dict_from_jax({"params": {"decoder": g_params}})
    n = 0
    for name, p in port.named_parameters():
        _check(p.grad.numpy(), want_g[name].numpy(), rel=5e-5, name=name)
        n += 1
    assert n == 39
    _check(t3.grad.permute(0, 2, 3, 1).numpy(), g3, rel=5e-5, name="conv3")
    _check(t6.grad.permute(0, 2, 3, 1).numpy(), g6, rel=5e-5, name="conv6")
    after = state_dict_from_jax({"decoder": upd["batch_stats"]})
    own = port.state_dict()
    assert len(after) == 14          # 7 live BNs x (mean, var)
    for name, w in after.items():
        assert not torch.equal(w, sd[name]), name
        _check(own[name].numpy(), w.numpy(), name=name)


# --------------------------------------------------------------- the model
def _jax_train_outputs(jm, variables, batch, train):
    import jax
    import jax.numpy as jnp

    from wseg_tpu.engine.train_loop import _normalise_batch_image

    img, raw = _normalise_batch_image(jnp.asarray(batch["image"]),
                                      jnp.asarray(batch["jitter"]))
    labels = jnp.asarray(batch["labels"])
    key = jax.random.PRNGKey(1)
    if not train:
        return jm.apply(variables, img, raw, labels, train=False), None
    return jm.apply(variables, img, raw, labels, train=True,
                    rngs={"dropout": key, "sg": key},
                    mutable=["batch_stats"])


@pytest.mark.parametrize("mode", ["test", "eval_labels", "train"])
def test_ae_model_matches_jax(mode, request):
    """The ``ae`` StageNet on ResNet-50: test mode (``cls``, ``masks``);
    with labels in eval mode (running-statistics BN, the gate's blend) and
    in train mode (psi 0, no dropout: batch statistics, then the running
    statistics after the step): ``cls``, ``cls_fg``, ``masks``,
    ``masks_dec`` (PAMR of the detached masks on the 17x17 stride-4
    grid), ``mask_logits``.  rel 2e-5; PAMR's output 1e-4 absolute."""
    import jax.numpy as jnp

    from tests.torch_parity import (
        jax_ae_model_and_random_variables,
        port_ae_model_from_jax,
    )

    from wseg_tpu_torch.engine.train_loop import normalise_batch_image
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    train = mode == "train"
    if train:
        request.getfixturevalue("no_jax_dropout")
    psi = 0.0 if train else 0.3
    jm, variables = jax_ae_model_and_random_variables("resnet50", seed=1,
                                                      sg_psi=psi)
    model = port_ae_model_from_jax(variables, "resnet50", train=train,
                                   sg_psi=psi)
    if mode == "test":
        x = _image(seed=0)
        want = jm.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.masks.shape == (2, SIZE, SIZE, 21)
        for key in ("cls", "masks"):
            _check(getattr(got, key).numpy(), getattr(want, key), name=key)
        return
    if train:
        assert _no_port_dropout(model) == 3
    batch = _batch()
    want, upd = _jax_train_outputs(jm, variables, batch, train)
    image, raw = normalise_batch_image(torch.from_numpy(batch["image"]),
                                       torch.from_numpy(batch["jitter"]))
    with torch.set_grad_enabled(train):
        got = model(image, raw, torch.from_numpy(batch["labels"]))
    assert got.mask_logits.shape == (2, 17, 17, 21)
    assert got.masks_dec.shape == got.masks.shape == (2, SIZE, SIZE, 21)
    for key in ("cls", "cls_fg", "masks", "mask_logits"):
        _check(getattr(got, key).detach().numpy(), getattr(want, key),
               name=key)
    np.testing.assert_allclose(got.masks_dec.numpy(), want.masks_dec,
                               atol=1e-4, rtol=0)
    assert float(got.masks_dec[..., 1:CLS].abs().max()) == 0.0
    if train:
        own = model.state_dict()
        new = state_dict_from_jax({"params": {},
                                   "batch_stats": upd["batch_stats"]})
        assert len(new) == 14
        for name, w in new.items():
            _check(own[name].numpy(), w.numpy(), name=name)


def _sharpen(variables):
    """Make the labelled class and the background split the pixels: the
    other classes' logit columns scaled by 0.1 with a bias of -5, so the
    pseudo-GT holds exactly the background and class CLS and the mask
    loss is live."""
    head = variables["params"]["decoder"]["last_conv3"]
    k, b = np.array(head["kernel"]), np.array(head["bias"])
    keep = k[..., CLS - 1].copy()
    k *= 0.1
    b[:] = -5.0
    k[..., CLS - 1], b[CLS - 1] = keep, 0.0
    head["kernel"], head["bias"] = k, b
    return variables


def _min_margin(masks_dec):
    """Smallest distance of a refined-mask value to its pseudo-GT
    threshold (``pseudo_gtmask``'s cut-offs)."""
    m = np.asarray(masks_dec)
    cut = np.full(m.shape[-1], 0.6, np.float32)
    cut[0] = 0.7
    thresh = np.maximum(m.max(axis=(1, 2), keepdims=True) * cut, 0.2)
    return float(np.abs(m - thresh).min())


def _jax_two_steps(jm, variables, batch, backbone, cfg_net):
    import jax
    import jax.numpy as jnp
    import optax

    from wseg_tpu.engine.train_loop import _normalise_batch_image
    from wseg_tpu.losses import get_criterion, self_supervision_loss
    from wseg_tpu.parallel.optim import make_optimizer

    params = variables["params"]
    tx, _ = make_optimizer(cfg_net, backbone, params)
    opt_state = tx.init(params)
    criterion = get_criterion("SoftMargin")
    img, raw = _normalise_batch_image(jnp.asarray(batch["image"]),
                                      jnp.asarray(batch["jitter"]))
    labels = jnp.asarray(batch["labels"])

    def loss_fn(p):
        out = jm.apply({"params": p,
                        "batch_stats": variables["batch_stats"]}, img, raw,
                       labels, train=False)
        l_mask, _ = self_supervision_loss(out.mask_logits, out.masks_dec,
                                          labels)
        loss_cls = jnp.mean(criterion(out.cls, labels))
        return loss_cls + jnp.mean(l_mask), (
            loss_cls, jnp.mean(l_mask), out.masks_dec)

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    aux = []
    for _ in range(2):
        grads, (l_cls, l_mask, dec) = grad_fn(params)
        aux.append((float(l_cls), float(l_mask), _min_margin(dec)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return {"params": params, "batch_stats": variables["batch_stats"]}, aux


# (model seed, batch seed) per backbone: the pseudo-GT is a threshold of
# ``masks_dec``, and a value within float noise (4.5e-6 between the
# packages here) of its threshold would flip between them and move the
# loss by a whole pixel's weight; these seeds keep every value > 2e-5
# from its threshold in both steps (checked on the JAX side)
SGD_SEEDS = {"resnet50": (1, 9), "vgg16": (3, 13)}


@pytest.mark.parametrize("backbone", ["resnet50", "vgg16"])
def test_two_sgd_steps_match_jax(backbone):
    """Two SGD steps (momentum exercised) with each backbone's LR
    multipliers and frozen stem, the mask loss live (``_sharpen``), in
    eval mode (running-statistics BN, the gate's blend at psi 0.3, no
    dropout) as the flagship's parity test: every parameter after the
    steps against ``jax.grad`` of the same loss + ``make_optimizer``'s
    transform.  Tolerance: each tensor's update agrees to 2e-2 of its
    largest update plus two float32 spacings of its values (the
    saturated masks make this loss's gradient ill-conditioned: the
    port's float32 steps differ from the same steps in float64 by up to
    1.4e-2 of a backbone tensor's largest update, and from JAX's by as
    much); frozen tensors and the running statistics stay bit-equal.

    Batch-statistics BN's gradient is held in ``test_decoder_matches_
    jax[True]`` instead: through the whole model at batch 2 the
    train-mode gradient is ill-conditioned in float32 (the backbone's
    tap gradient of a float32 port within 0.6% of a float64 port's, the
    JAX float32 one within 2.1%), so no float32 tolerance tells a fault
    from rounding there."""
    from tests.torch_parity import (
        jax_ae_model_and_random_variables,
        port_ae_model_from_jax,
    )
    from wseg_tpu.config import cfg as jcfg
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.train_loop import train_step
    from wseg_tpu_torch.optim import FROZEN, make_optimizer
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    model_seed, batch_seed = SGD_SEEDS[backbone]
    jm, variables = jax_ae_model_and_random_variables(backbone,
                                                      seed=model_seed)
    variables = _sharpen(variables)
    batch = _batch(batch_seed)
    jcfg.NET.WEIGHT_DECAY = 0.0005
    jcfg.NET.LR = 0.001
    new_vars, aux = _jax_two_steps(jm, variables, batch, backbone, jcfg.NET)

    model = port_ae_model_from_jax(variables, backbone, train=True).eval()
    cfg.NET.MODEL, cfg.NET.BACKBONE = "ae", backbone
    cfg.NET.WEIGHT_DECAY, cfg.NET.LR = 0.0005, 0.001
    optimizer, labels = make_optimizer(cfg.NET, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = [train_step(model, optimizer, tb, 1.0, device_jitter=True)
               for _ in range(2)]
    for (l_cls, l_mask, margin), m in zip(aux, metrics):
        assert margin > 2e-5, margin
        assert abs(float(m["loss_cls"]) - l_cls) <= 1e-4 * max(1, l_cls)
        assert abs(float(m["loss_mask"]) - l_mask) <= 1e-4 * max(1, l_mask)
    assert aux[0][1] > 0, "the mask loss must be live"

    after = model.state_dict()
    want = state_dict_from_jax(new_vars)
    assert set(want) == set(after)
    moved = 0
    for name, w in want.items():
        d_ours = (after[name] - before[name]).numpy()
        d_want = w.numpy() - before[name].numpy()
        scale = float(np.abs(d_want).max())
        if labels.get(name, FROZEN) == FROZEN:
            assert torch.equal(after[name], before[name]), name
            assert scale == 0.0, name
            continue
        assert scale > 0, name
        ulp = float(np.spacing(np.abs(before[name].numpy()).max()))
        np.testing.assert_allclose(d_ours, d_want, rtol=0,
                                   atol=2e-2 * scale + 2 * ulp, err_msg=name)
        moved += 1
    assert moved == sum(lab != FROZEN for lab in labels.values())


@pytest.mark.parametrize("backbone", ["resnet101", "vgg16"])
def test_lr_groups_match_jax_label_params(backbone):
    from tests.torch_parity import (
        jax_ae_model_and_random_variables,
        port_ae_model_from_jax,
    )
    from wseg_tpu.parallel.optim import label_params as jax_labels
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.optim import (
        FROZEN,
        NEW_B,
        NEW_W,
        PRE_B,
        PRE_W,
        label_params,
        make_optimizer,
    )
    from wseg_tpu_torch.utils.convert import labels_from_jax

    _, variables = jax_ae_model_and_random_variables(backbone, seed=0,
                                                     size=33)
    want = labels_from_jax(jax_labels(variables["params"], backbone))
    model = port_ae_model_from_jax(variables, backbone, train=True)
    got = label_params(model, backbone)
    assert set(got) <= set(want)
    for name, lab in got.items():
        assert lab == want[name], name
    rest = {n: lab for n, lab in want.items() if n not in got}
    assert set(rest.values()) <= {FROZEN}
    assert all(n.endswith(("running_mean", "running_var")) for n in rest)
    # live and affine-only decoder norms are head parameters
    for name in ("fc8_skip.1.weight", "aspp.aspp2.bn.weight",
                 "shallow_mask.fc_cls.1.weight"):
        assert got[name] == NEW_W, name
    assert got["last_conv.8.bias"] == got["last_conv.5.bias"] == NEW_B
    if backbone == "vgg16":
        assert got["conv1_2.weight"] == FROZEN
        assert got["conv2_1.bias"] == PRE_B and got["fc7.weight"] == PRE_W
        mults = (1.0, 2.0, 10.0, 20.0)
    else:
        assert got["conv1.weight"] == FROZEN == got["layer1.0.bn1.weight"]
        assert got["layer1.0.conv1.weight"] == PRE_W
        mults = (1.0, 1.0, 10.0, 10.0)

    cfg.NET.MODEL, cfg.NET.BACKBONE = "ae", backbone
    optimizer, _ = make_optimizer(cfg.NET, model)
    lr = {g["name"]: g["lr"] for g in optimizer.param_groups}
    base = float(cfg.NET.LR)
    assert [lr[g] for g in ("pre_w", "pre_b", "new_w", "new_b")] == \
        [base * m for m in mults]


# --------------------------------------------------------- checkpoints
def test_port_checkpoint_loads_into_jax(tmp_path):
    """A port-saved ``ae`` .pth (seeded weights, random running
    statistics) through ``load_reference_checkpoint(strict=True)``:
    every tensor and statistic lands, and the JAX model's test-mode
    outputs agree with the port's (rel 2e-5)."""
    import flax.traverse_util as trav
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import jax_ae_model_and_random_variables

    from wseg_tpu.utils.torch_convert import load_reference_checkpoint
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import (
        seeded_init_,
        stabilize_scratch_init,
    )
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    cfg.NET.MODEL, cfg.NET.BACKBONE, cfg.NET.DTYPE = "ae", "vgg16", "float32"
    model = get_model(cfg.NET)
    seeded_init_(model, torch.Generator().manual_seed(3))
    stabilize_scratch_init(model, 0.1)
    path = str(tmp_path / "ae.pth")
    torch.save(model.state_dict(), path)

    jm, variables = jax_ae_model_and_random_variables("vgg16", seed=0)
    loaded = load_reference_checkpoint(variables, path, "ae", "vgg16",
                                       strict=True)
    back = state_dict_from_jax(loaded)
    own = model.state_dict()
    assert set(back) == set(own)
    for name, w in back.items():
        assert torch.equal(w, own[name]), name
    assert len(trav.flatten_dict(loaded["batch_stats"])) == 14
    x = _image(seed=5)
    want = jm.apply(loaded, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("cls", "masks"):
        _check(getattr(got, key).numpy(), getattr(want, key), name=key)
    del jax


@pytest.mark.parametrize("backbone", ["resnet50", "vgg16"])
def test_load_pretrained_backbone_matches_jax_loader(backbone, tmp_path):
    """A synthetic ImageNet checkpoint written by ``torch.save`` with the
    release's names (torchvision's ResNet with its ``fc`` classifier and
    BN batch counters; the flat VGG16) loads into the port's backbone and
    into the JAX one with the same tensors; the head stays as it was."""
    from tests.torch_parity import (
        jax_ae_model_and_random_variables,
        port_ae_model_from_jax,
    )
    from wseg_tpu.utils.torch_convert import (
        load_pretrained_backbone as jax_load,
    )
    from wseg_tpu_torch.models.backbones import get_backbone
    from wseg_tpu_torch.models.backbones.common import seeded_init_
    from wseg_tpu_torch.utils.convert import (
        load_pretrained_backbone,
        state_dict_from_jax,
    )

    src = get_backbone(backbone)
    seeded_init_(src, torch.Generator().manual_seed(7))
    sd = dict(src.state_dict())
    if backbone == "resnet50":
        sd["fc.weight"] = torch.randn(1000, 2048)
        sd["fc.bias"] = torch.randn(1000)
        sd["bn1.num_batches_tracked"] = torch.tensor(5)
    path = str(tmp_path / "imagenet.pth")
    torch.save(sd, path)

    jm, variables = jax_ae_model_and_random_variables(backbone, seed=0,
                                                      size=33)
    model = port_ae_model_from_jax(variables, backbone)
    head = {k: v.clone() for k, v in model.state_dict().items()
            if k not in src.state_dict()}
    n = load_pretrained_backbone(model, path)
    assert n == len(src.state_dict())
    jax_params = jax_load(variables["params"], path, backbone)
    want = state_dict_from_jax({"params": jax_params,
                                "batch_stats": variables["batch_stats"]})
    own = model.state_dict()
    for name, w in want.items():
        assert torch.equal(own[name], w), name
    for name, w in src.state_dict().items():
        assert torch.equal(own[name], w), name
    for name, w in head.items():
        assert torch.equal(own[name], w), name


# ---------------------------------------------------- configs and factory
@pytest.mark.parametrize("name", ["voc_resnet50.yaml", "voc_resnet101.yaml",
                                  "voc_vgg16.yaml"])
def test_ae_config_sets_equal_their_yaml(name):
    from wseg_tpu_torch import flagship
    from wseg_tpu_torch.config import (
        cfg,
        cfg_from_file,
        cfg_from_list,
        reset_cfg,
    )

    cfg_from_file(os.path.join(flagship.REPO, "configs", name))
    from_yaml = cfg.clone()
    reset_cfg()
    cfg_from_list(flagship.CONFIG_SETS[name])
    assert cfg.clone() == from_yaml
    assert cfg.NET.MODEL == "ae" and int(cfg.DATASET.CROP_SIZE) == 321


def test_get_model_builds_ae_and_raises_elsewhere():
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.stage_net import StageNet

    cfg.NET.MODEL = "ae"
    for bb in ("resnet50", "resnet101", "vgg16"):
        cfg.NET.BACKBONE = bb
        cfg.NET.SG_PSI = 0.25
        m = get_model(cfg.NET)
        assert isinstance(m, StageNet) and not m.training
        assert m.sg.psi == 0.25
    # the transformer heads build too, with the reference's modules
    for model, bb, names in (
            ("CAM_CASA_WGAP_tf_v4", "resnet50", {"selfattn.q.weight"}),
            ("CAM_CASA_WGAP_tf_v5", "resnet38", {"selfattn.qkv.weight"}),
            ("CAM_CASA_WGAP_tf_v9", "resnet38",
             {"fc6.weight", "selfattn.pre_softmax_proj.weight"})):
        cfg.NET.MODEL, cfg.NET.BACKBONE = model, bb
        m = get_model(cfg.NET)
        assert m.spec.name == model and not m.training
        assert names <= set(m.state_dict()), model
    # and a key outside wseg_tpu's registry raises
    cfg.NET.MODEL = "CAM_CASA_WGAP_tf_v11"
    with pytest.raises(NotImplementedError, match="Unknown model"):
        get_model(cfg.NET)


def test_scratch_init_zeroes_resnet_conv3_only():
    from wseg_tpu_torch.models.backbones import ResNet50, VGG16
    from wseg_tpu_torch.models.backbones.common import stabilize_scratch_init

    r = ResNet50()
    stabilize_scratch_init(r, 0.0)
    convs = [(n, p) for n, p in r.named_parameters() if p.dim() == 4]
    assert len(convs) == 53
    for name, p in convs:
        assert bool((p == 0).all()) == name.endswith("conv3.weight"), name
    v = VGG16()
    before = {k: t.clone() for k, t in v.state_dict().items()}
    stabilize_scratch_init(v, 0.0)
    assert all(torch.equal(t, before[k]) for k, t in v.state_dict().items())


# -------------------------------------------------------------- the card
@pytest.mark.gpu
def test_ae_train_step_on_card():
    """One bf16-autocast train step of the resnet50 ``ae`` model at batch
    4, crop 129 (an odd 33x33 PAMR plane): finite losses, running
    statistics float32 and moved, one launch of each PAMR kernel, and the
    step's refined masks from the kernels equal to the plain path's
    (1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.train_loop import (
        normalise_batch_image,
        train_step,
    )
    from wseg_tpu_torch.engine.trainer import build_train_model
    from wseg_tpu_torch.ops.pamr import pamr, pamr_reference
    from wseg_tpu_torch.ops.pamr_cuda import (
        pamr_affinity_cm,
        pamr_propagate_cm,
    )
    from wseg_tpu_torch.optim import make_optimizer

    cfg.NET.MODEL, cfg.NET.BACKBONE, cfg.NET.DTYPE = "ae", "resnet50", \
        "bfloat16"
    cfg.NET.PRE_WEIGHTS_PATH = ""
    model = build_train_model(torch.device("cuda"), seed=0)
    opt, _ = make_optimizer(cfg.NET, model)
    rng = np.random.RandomState(0)
    b, crop = 4, 129
    batch = {"image": torch.from_numpy((rng.rand(b, crop, crop, 3) * 255)
                                       .astype(np.uint8)).cuda(),
             "labels": torch.zeros(b, 20, device="cuda"),
             "jitter": torch.tensor([[1, 1, 1, 0, 0, 1, 2, 3, 0]] * b,
                                    dtype=torch.float32, device="cuda")}
    batch["labels"][:, CLS - 1] = 1
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("fc8_skip.1.running")}
    n_aff, n_prop = pamr_affinity_cm.launches, pamr_propagate_cm.launches
    metrics = train_step(model, opt, batch, 1.0)
    torch.cuda.synchronize()
    assert (pamr_affinity_cm.launches - n_aff,
            pamr_propagate_cm.launches - n_prop) == (1, 1)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    for k, v in stats.items():
        now = model.state_dict()[k]
        assert now.dtype == torch.float32 and not torch.equal(now, v), k
        assert bool(torch.isfinite(now).all()), k
    model.eval()
    with torch.no_grad():
        image, raw = normalise_batch_image(batch["image"], batch["jitter"])
        out = model(image)
        masks = torch.softmax(model._features(image)[0], dim=-1)
        assert masks.shape == (b, 33, 33, 21)
        err = float((pamr(raw, masks) - pamr_reference(raw, masks))
                    .abs().max())
    assert err <= 1e-5, err
    assert bool(torch.isfinite(out.masks).all())
