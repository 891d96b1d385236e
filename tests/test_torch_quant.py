"""The int8 serving mode's modules against the JAX package (CPU, numpy-
seeded inputs and weights; the port runs the plain versions of
``ops/qconv.py``), and the last two training modules, Adam and
``--profile-dir``.

* ``QuantConv``: the port's against ``wseg_tpu``'s on the same bf16
  input and float32 weights, dynamic and static, with and without bias,
  1x1 stride 2, 3x3 at dilation 2 and 12 and at stride 2, and the cin
  < 16 stems.  The quantized path is integer arithmetic between two
  IEEE-exact scalings, so xq, wq, sw, sx, the int32 sums and the bf16
  output are required to be equal (JAX's intermediates are recomputed
  from ``common.py``'s expressions, and that recomputation is first
  held bit-equal to the module's output).  The cin < 16 path is a
  float32-accumulated conv: its bf16 output may differ by one bf16 ulp
  where XLA's and PyTorch's CPU convs sum in another order (none seen
  on these cases, but the order is the libraries' choice).
* Static calibration: ``amax`` equal to JAX's ``quant_stats`` after two
  calibrating passes (rtol 1e-6), out of the state_dict, and the weight
  cache refreshed by ``load_state_dict`` and by new statistics.
* ``quant_stats_from_jax`` carries the flagship's JAX ``quant_stats``
  collection into ``load_quant_stats`` name for name.
* Adam: two steps of ``make_optimizer`` with ``NET.OPT Adam`` against
  JAX's on the same gradients (float32 tolerance).
* ``--profile-dir``: the trainer traces steps 10-20 of its first epoch.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (
    jax_zoo_model_and_random_variables,
    port_zoo_model_from_jax,
)

# (id, cin, cout, k, stride, dilation, bias, act_mode)
CASES = [
    ("dyn_3x3_d2_bias", 64, 48, 3, 1, 2, True, "dynamic"),
    ("dyn_1x1_s2", 32, 40, 1, 2, 1, False, "dynamic"),
    ("dyn_3x3_d12_bias", 48, 24, 3, 1, 12, True, "dynamic"),
    ("dyn_3x3_s2", 64, 64, 3, 2, 1, False, "dynamic"),
    ("static_3x3_d2", 64, 48, 3, 1, 2, False, "static"),
    ("static_1x1_s2_bias", 32, 40, 1, 2, 1, True, "static"),
    ("static_3x3_d12_bias", 48, 24, 3, 1, 12, True, "static"),
    ("static_3x3_s2_d2", 32, 16, 3, 2, 2, False, "static"),
    ("stem_3x3_bias", 3, 16, 3, 1, 1, True, "dynamic"),
    ("stem_7x7_s2", 3, 16, 7, 2, 1, False, "static"),
]
PLANE = (2, 24, 21)


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _inputs(cin, cout, k, bias, seed):
    """bf16 activations NHWC (as float32 values), an outlier channel;
    He-normal HWIO kernel; a small bias."""
    rng = np.random.RandomState(seed)
    b, h, w = PLANE
    x = rng.randn(b, h, w, cin) * 1.5
    x[..., cin // 3] *= 20.0
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    wk = (rng.randn(k, k, cin, cout)
          * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    bv = (rng.randn(cout) * 0.1).astype(np.float32) if bias else None
    return x, wk, bv


def _jax_conv(cout, k, stride, dil, bias, mode):
    from wseg_tpu.models.backbones.common import conv

    return conv(cout, k, stride, dil, use_bias=bias,
                dtype="int8_static" if mode == "static" else "int8")


def _jax_intermediates(x, wk, bv, stride, pad, dil, mode, amax):
    """``wseg_tpu``'s QuantConv arithmetic (common.py:173-221), step by
    step: (xq NHWC, wq HWIO, sw, sx or None, acc NHWC int32, y bf16)."""
    xb = jnp.asarray(x, jnp.bfloat16)
    w = jnp.asarray(wk)
    dn = ("NHWC", "HWIO", "NHWC")
    padding = [(pad, pad)] * 2 if pad else "VALID"
    if mode == "static":
        sc = jnp.maximum(jnp.asarray(amax), 1e-12) / 127.0
        wf = w * sc[None, None, :, None]
        sw = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12) / 127.0
        wq = jnp.clip(jnp.round(wf / sw), -127, 127).astype(jnp.int8)
        xq = jnp.clip(jnp.round(xb.astype(jnp.float32) / sc),
                      -127, 127).astype(jnp.int8)
        sx = None
    else:
        sw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-12) / 127.0
        wq = jnp.clip(jnp.round(w / sw), -127, 127).astype(jnp.int8)
        sx = jnp.maximum(jnp.max(jnp.abs(xb.astype(jnp.float32)),
                                 axis=(1, 2, 3), keepdims=True),
                         1e-12) / 127.0
        xq = jnp.clip(jnp.round(xb.astype(jnp.float32) / sx),
                      -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), padding, rhs_dilation=(dil, dil),
        dimension_numbers=dn, preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (sw if sx is None else sx * sw)
    if bv is not None:
        y = y + jnp.asarray(bv)
    return (np.asarray(xq), np.asarray(wq), np.asarray(sw),
            None if sx is None else np.asarray(sx).reshape(-1),
            np.asarray(acc), np.asarray(y.astype(jnp.bfloat16)
                                        .astype(jnp.float32)))


def _port_conv(cin, cout, k, stride, dil, bias, mode, wk, bv):
    from wseg_tpu_torch.models.backbones.common import INT8, INT8_STATIC, conv

    m = conv(cin, cout, k, stride, dil, bias=bias,
             quant=INT8_STATIC if mode == "static" else INT8)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(wk.transpose(3, 2, 0, 1)))
        if bias:
            m.bias.copy_(torch.from_numpy(bv))
    return m.eval()


def _nchw(x):
    t = torch.from_numpy(np.array(x)).to(torch.bfloat16)
    return t.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _ulps(a, b):
    """bf16 ulps between two arrays of bf16 values (as float32)."""
    ia = a.view(np.int32) >> 16
    ib = b.view(np.int32) >> 16
    return np.abs(ia.astype(np.int64) - ib.astype(np.int64))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_quantconv_matches_jax(case):
    from wseg_tpu_torch.models.backbones.common import calibrating
    from wseg_tpu_torch.ops.qconv import qconv_s8, quantize_act

    name, cin, cout, k, stride, dil, bias, mode = case
    x, wk, bv = _inputs(cin, cout, k, bias, seed=len(name))
    pad = (k - 1) // 2 * dil
    jm = _jax_conv(cout, k, stride, dil, bias, mode)
    params = {"kernel": jnp.asarray(wk)}
    if bias:
        params["bias"] = jnp.asarray(bv)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = {"params": params}
    quantized = cin >= 16
    port = _port_conv(cin, cout, k, stride, dil, bias, mode, wk, bv)
    amax = None
    if mode == "static" and quantized:
        # calibrate on the first image only: the second one then
        # exceeds the calibrated range somewhere (clipping exercised)
        init = jm.init(jax.random.PRNGKey(0), xb[:1])
        _, mut = jm.apply({"params": params,
                           "quant_stats": init["quant_stats"]}, xb[:1],
                          mutable=["quant_stats"])
        variables["quant_stats"] = mut["quant_stats"]
        amax = np.asarray(mut["quant_stats"]["amax"])
        with torch.no_grad(), calibrating(port):
            port(_nchw(x[:1]))
        np.testing.assert_array_equal(port.amax.numpy(), amax)
    want = np.asarray(jm.apply(variables, xb).astype(jnp.float32))
    with torch.no_grad():
        got = port(_nchw(x)).float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    if not quantized:
        assert int(_ulps(got, want).max()) <= 1
        return

    jxq, jwq, jsw, jsx, jacc, jy = _jax_intermediates(
        x, wk, bv, stride, pad, dil, mode, amax)
    # the recomputation is JAX's module, bit for bit
    np.testing.assert_array_equal(jy, want)
    static = mode == "static"
    wq, sw, sc = port.quantized_weight(static)
    xq, sx = quantize_act(_nchw(x), sc)
    acc = qconv_s8(xq, wq, sx, sw, None, stride, pad, dil, acc_only=True)
    assert xq.shape[-1] % 32 == 0 and not xq[..., cin:].any()
    np.testing.assert_array_equal(xq[..., :cin].numpy(), jxq)
    np.testing.assert_array_equal(
        wq[..., :cin].numpy(), jwq.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(sw.numpy(), jsw)
    if static:
        assert sx is None
    else:
        np.testing.assert_array_equal(sx.numpy(), jsx)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), jacc)
    np.testing.assert_array_equal(got, want)


def test_static_calibration_state_and_cache():
    """amax max-accumulates over calibrating passes as JAX's
    ``quant_stats`` does, stays out of the state_dict, and the cached
    quantized weight follows a ``load_state_dict`` and new statistics."""
    from wseg_tpu_torch.models.backbones.common import (
        calibrating,
        load_quant_stats,
        quant_stats,
    )

    cin, cout = 32, 24
    x, wk, _ = _inputs(cin, cout, 3, False, seed=3)
    jm = _jax_conv(cout, 3, 1, 1, False, "static")
    xb = jnp.asarray(x, jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), xb)
    params = {"kernel": jnp.asarray(wk)}
    _, mut = jm.apply({"params": params, "quant_stats": v["quant_stats"]},
                      xb * 0.5, mutable=["quant_stats"])
    _, mut = jm.apply({"params": params, "quant_stats": mut["quant_stats"]},
                      xb, mutable=["quant_stats"])
    want = np.asarray(mut["quant_stats"]["amax"])

    port = _port_conv(cin, cout, 3, 1, 1, False, "static", wk, None)
    with torch.no_grad(), calibrating(port):
        port(_nchw(x) * 0.5)
        port(_nchw(x))
    assert not port.calibrating
    np.testing.assert_allclose(port.amax.numpy(), want, rtol=1e-6)
    assert set(port.state_dict()) == {"weight"}
    assert set(quant_stats(port)) == {""}

    with torch.no_grad():
        y1 = port(_nchw(x))
        wq1, sw1, _ = (t.clone() for t in port.quantized_weight(True))
        # doubling the weight doubles sw and keeps wq (exact in float32)
        port.load_state_dict({"weight": port.weight.detach() * 2.0})
        wq2, sw2, _ = port.quantized_weight(True)
        assert torch.equal(wq2, wq1) and torch.equal(sw2, sw1 * 2.0)
        y2 = port(_nchw(x))
        assert not torch.equal(y1, y2)
        load_quant_stats(port, {"": port.amax * 4.0})
        y3 = port(_nchw(x))
        assert not torch.equal(y2, y3)
        port.weight.mul_(0.5)  # an in-place update refreshes it too
        y4 = port(_nchw(x))
        assert not torch.equal(y3, y4)
        load_quant_stats(port, {"": port.amax / 4.0})
        assert torch.equal(port(_nchw(x)), y1)
    with pytest.raises(KeyError):
        load_quant_stats(port, {"other": port.amax})


def test_serving_cast_keeps_quantconv_float32():
    """``get_model``'s bf16 cast leaves the QuantConvs' weights (and the
    static statistics) float32; everything else is cast."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import QuantConv

    cfg.NET.MODEL, cfg.NET.BACKBONE = "bsl", "vgg16"
    cfg.NET.DTYPE, cfg.NET.QUANT_ACT = "int8", "static"
    model = get_model(cfg.NET)
    qconvs = [m for m in model.modules() if isinstance(m, QuantConv)]
    assert len(qconvs) == 15  # 13 convs, fc6, fc7
    for m in qconvs:
        assert m.weight.dtype == torch.float32
        assert m.bias.dtype == torch.float32
        assert hasattr(m, "amax") == (m.in_channels >= 16)
        if hasattr(m, "amax"):
            assert m.amax.dtype == torch.float32
    assert model.fc8.weight.dtype == torch.bfloat16
    model.half()
    assert all(m.weight.dtype == torch.float32 for m in qconvs)


def test_quant_stats_from_jax_round_trip():
    """The flagship's JAX ``quant_stats`` collection (every static
    QuantConv's amax, random values) -> ``quant_stats_from_jax`` ->
    ``load_quant_stats`` into the port's int8 static model, name for
    name; the port's ``quant_stats`` gives the same arrays back."""
    import flax.traverse_util as trav

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.models import get_model as jax_get_model
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import (
        load_quant_stats,
        quant_stats,
    )
    from wseg_tpu_torch.utils.convert import quant_stats_from_jax

    net = jax_default_cfg().NET
    net.MODEL, net.BACKBONE = "CAM_CASA_WGAP_tf", "resnet38"
    net.DTYPE, net.QUANT_ACT = "int8", "static"
    jm = jax_get_model(net, num_classes=21)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key, "sg": key},
        jnp.zeros((1, 32, 32, 3), jnp.float32), train=False))
    flat = trav.flatten_dict(shapes["quant_stats"])
    rng = np.random.RandomState(0)
    tree = trav.unflatten_dict({
        path: rng.rand(*v.shape).astype(np.float32)
        for path, v in flat.items()})

    stats = quant_stats_from_jax({"quant_stats": tree})
    assert len(stats) == len(flat) == 42  # every WRN38 conv but conv1a
    cfg.NET.MODEL, cfg.NET.BACKBONE = "CAM_CASA_WGAP_tf", "resnet38"
    cfg.NET.DTYPE, cfg.NET.QUANT_ACT = "int8", "static"
    model = get_model(cfg.NET)
    load_quant_stats(model, stats)
    back = quant_stats(model)
    for path, v in trav.flatten_dict(tree).items():
        name = ".".join(p for p in path[1:-1])
        np.testing.assert_array_equal(back[name].numpy(), v)


def test_two_adam_steps_match_jax():
    """``NET.OPT Adam``: two steps on the same gradients as JAX's
    ``make_optimizer`` (per-group LRs, L2 decay on the weight groups,
    BETA1 0.5, frozen stem and BNs untouched), float32 tolerance: the
    two divide by sqrt(v_hat) + eps in another order, and torch forms
    the first moment as ``m + (1 - b1) (g - m)`` (lerp), optax as ``b1 m
    + (1 - b1) g``; where the two steps' gradients nearly cancel, m's
    rounding, divided by a small sqrt(v), moves a parameter by up to
    ~2e-7 (seen: 1.7e-7 at LR multiplier 20), hence atol 1e-6."""
    import optax

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.parallel.optim import make_optimizer as jax_make_optimizer
    from wseg_tpu_torch.config import _default_cfg
    from wseg_tpu_torch.optim import FROZEN, make_optimizer
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    _, variables = jax_zoo_model_and_random_variables("bsl", "vgg16",
                                                      seed=5, size=32)
    params = variables["params"]
    jnet = jax_default_cfg().NET
    pnet = _default_cfg().NET
    for net in (jnet, pnet):
        net.OPT, net.LR, net.WEIGHT_DECAY, net.BETA1 = "Adam", 1e-3, 5e-4, 0.5
        net.BACKBONE = "vgg16"
    tx, _ = jax_make_optimizer(jnet, "vgg16", params)
    state = tx.init(params)
    model = port_zoo_model_from_jax(variables, "bsl", "vgg16", train=True)
    opt, labels = make_optimizer(pnet, model)
    assert isinstance(opt, torch.optim.Adam)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(7)
    jparams = params
    for _ in range(2):
        grads = jax.tree.map(
            lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32),
            params)
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gsd = state_dict_from_jax({"params": grads})
        for n, p in model.named_parameters():
            p.grad = gsd[n].clone() if p.requires_grad else None
        opt.step()
    want = state_dict_from_jax({"params": jparams})
    for n, p in model.named_parameters():
        got = p.detach()
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        if labels[n] == FROZEN:
            assert torch.equal(got, before[n]), n
        else:
            assert not torch.equal(got, before[n]), n


def test_profile_dir_traces_steps_10_to_20(tmp_path, capsys):
    """A stubbed train step over 21 batches: the profiler is on for
    steps 10-20 of the first epoch, the trace is written, and a later
    epoch is not traced."""
    from wseg_tpu_torch.engine.trainer import DecTrainer

    seen = []

    def step(batch, epoch):
        seen.append((epoch, batch["i"], torch.autograd._profiler_enabled()))
        return {"loss": torch.tensor(float(batch["i"]))}

    out = str(tmp_path / "prof")
    trainer = object.__new__(DecTrainer)
    trainer.args = types.SimpleNamespace(profile_dir=out)
    trainer.start_epoch = 0
    trainer.device = torch.device("cpu")
    trainer.model = torch.nn.Identity()
    trainer.trainloader = [{"i": i} for i in range(21)]
    trainer._device_batch = lambda batch, train: batch
    trainer._train_step = step
    trainer.train_epoch(0)
    trainer.train_epoch(1)
    on = [i for e, i, p in seen if p]
    assert on == list(range(10, 21))
    assert len(seen) == 42
    assert os.path.isfile(os.path.join(out, "trace_epoch0.json"))
    assert not os.path.exists(os.path.join(out, "trace_epoch1.json"))
    assert f"Profiler trace written to {out}" in capsys.readouterr().out
