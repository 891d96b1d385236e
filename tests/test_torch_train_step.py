"""The port's train path (WRN38 + CAM_CASA_WGAP_tf, PAMR, losses,
4-group SGD) vs the JAX package, float32 on the CPU, same weights and
numpy-seeded batches.

Dropout draws different bits in the two packages (a torch.Generator
against ``fold_in(rng, step)``), so the parity tests switch it off in
both: JAX ``train=False`` with labels (as ``make_eval_step`` applies
the model) and the port's model in ``.eval()``; dropout gets its own
statistical test.

The fc8 columns of the background and of the labelled class are set so
that both win somewhere: the pseudo-GT then holds exactly the labelled
class + background and the mask loss is non-zero, so its gradient
(through PAMR's stop-gradient and the 8x upsampling) is exercised.  The
pseudo-GT is a threshold of ``masks_dec``: a value within float noise
(~1e-5 here) of its threshold would flip between the packages and move
the loss by a whole pixel's weight.  The batch seed is one whose values
all keep > 3e-4 from their thresholds in both steps (checked by
``_min_margin``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (
    jax_model_and_random_variables,
    port_model_from_jax,
)

SIZE = 64
CLS = 8         # the labelled class (mask channel); label index CLS - 1


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _variables(seed=5):
    jmodel, variables = jax_model_and_random_variables(seed=seed, size=SIZE)
    k = np.array(variables["params"]["fc8"]["kernel"])
    k0 = k.copy()
    k[..., CLS] *= 3.0
    k[..., 0] = k0[..., 3] * 3.0
    variables["params"]["fc8"]["kernel"] = k
    return jmodel, variables


def _batch(seed=17, b=2):
    rng = np.random.RandomState(seed)
    image = (rng.rand(b, SIZE, SIZE, 3) * 255).astype(np.uint8)
    labels = np.zeros((b, 20), np.float32)
    labels[:, CLS - 1] = 1.0
    jitter = np.array([[1.1, 0.9, 1.2, 0.0, 2, 0, 3, 1, 1.0],
                       [0.8, 1.25, 0.7, 0.0, 1, 3, 0, 2, 1.0]],
                      np.float32)[:b]
    return {"image": image, "labels": labels, "jitter": jitter}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check(ours, ref, atol=1e-3, rtol=5e-3, name=""):
    """The model tolerance of tests/test_torch_model.py: float32 through
    a 38-layer backbone, atol scaled by the output magnitude."""
    ref = np.asarray(ref)
    atol_k = max(atol, 2e-6 * float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(ours), ref, atol=atol_k,
                               rtol=rtol, err_msg=name)


def _min_margin(masks_dec):
    """Smallest distance of a refined-mask value to its pseudo-GT
    threshold (``pseudo_gtmask``'s cut-offs)."""
    mx = masks_dec.amax(dim=(1, 2), keepdim=True)
    cut = torch.full((masks_dec.shape[-1],), 0.6)
    cut[0] = 0.7
    return float((masks_dec - torch.clamp(mx * cut, min=0.2)).abs().min())


def _train_model(variables):
    """The port's train-mode model (float32 parameters) with the JAX
    weights, dropout off."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    cfg.NET.MODEL = "CAM_CASA_WGAP_tf"
    cfg.NET.BACKBONE = "resnet38"
    cfg.NET.DTYPE = "float32"
    cfg.NET.WEIGHT_DECAY = 0.0005
    model = get_model(cfg.NET, num_classes=21, train=True)
    assert model.training
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval(), cfg


def test_train_outputs_match_jax():
    from wseg_tpu.engine.train_loop import _normalise_batch_image

    jmodel, variables = _variables()
    batch = _batch()
    img, raw = _normalise_batch_image(jnp.asarray(batch["image"]))
    want = jmodel.apply(variables, img, raw, jnp.asarray(batch["labels"]),
                        train=False)

    from wseg_tpu_torch.engine.train_loop import normalise_batch_image

    model = port_model_from_jax(variables)
    t_img, t_raw = normalise_batch_image(torch.from_numpy(batch["image"]))
    np.testing.assert_allclose(t_raw.numpy(), np.asarray(raw), atol=1e-7)
    with torch.no_grad():
        got = model(t_img, t_raw, torch.from_numpy(batch["labels"]))
    assert got.masks.shape == got.masks_dec.shape == (2, SIZE, SIZE, 21)
    assert got.mask_logits.shape == (2, SIZE // 8, SIZE // 8, 21)
    assert got.attn_map is None and want.attn_map is None
    for key in ("cls", "cls_fg", "masks", "masks_dec", "mask_logits"):
        _check(getattr(got, key).numpy(), getattr(want, key), name=key)
    # cleaning zeroed the unlabelled classes; PAMR refined the rest
    assert float(got.masks_dec[..., 1:CLS].abs().max()) == 0.0
    assert float(got.masks_dec[..., CLS].max()) > 0.5


def _jax_two_steps(jmodel, variables, batch, cfg_net):
    import optax

    from wseg_tpu.engine.train_loop import _normalise_batch_image
    from wseg_tpu.losses import get_criterion, self_supervision_loss
    from wseg_tpu.parallel.optim import make_optimizer

    params = variables["params"]
    tx, labels_tree = make_optimizer(cfg_net, "resnet38", params)
    opt_state = tx.init(params)
    criterion = get_criterion("SoftMargin")
    img, raw = _normalise_batch_image(jnp.asarray(batch["image"]),
                                      jnp.asarray(batch["jitter"]))
    labels = jnp.asarray(batch["labels"])

    def loss_fn(p):
        out = jmodel.apply({"params": p}, img, raw, labels, train=False)
        l_mask, _ = self_supervision_loss(out.mask_logits, out.masks_dec,
                                          labels)
        loss_cls = jnp.mean(criterion(out.cls, labels))
        return loss_cls + jnp.mean(l_mask), (loss_cls, jnp.mean(l_mask))

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    aux = []
    for _ in range(2):
        grads, (l_cls, l_mask) = grad_fn(params)
        aux.append((float(l_cls), float(l_mask)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, labels_tree, aux


def test_two_sgd_steps_match_jax():
    """Two steps, so that momentum is exercised: every parameter after
    the steps against ``jax.grad`` of the same loss + ``make_optimizer``'s
    transform.  Tolerance: the update of each tensor agrees to 1e-3 of
    that tensor's largest update (float32 gradients through the stack,
    summed in a different order) plus two float32 spacings of its
    values; frozen tensors stay bit-equal."""
    from wseg_tpu.config import cfg as jcfg
    from wseg_tpu_torch.engine.train_loop import train_step
    from wseg_tpu_torch.optim import FROZEN, make_optimizer
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    jmodel, variables = _variables()
    batch = _batch()
    model, cfg = _train_model(variables)
    jcfg.NET.WEIGHT_DECAY = 0.0005
    new_params, _, aux = _jax_two_steps(jmodel, variables, batch, jcfg.NET)

    from wseg_tpu_torch.engine.train_loop import normalise_batch_image

    optimizer, labels = make_optimizer(cfg.NET, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    image, raw = normalise_batch_image(torch.from_numpy(batch["image"]),
                                       torch.from_numpy(batch["jitter"]))
    metrics = []
    for _ in range(2):
        with torch.no_grad():
            dec = model(image, raw, torch.from_numpy(batch["labels"]))
        assert _min_margin(dec.masks_dec) > 3e-4
        metrics.append(train_step(model, optimizer, _torch_batch(batch), 1.0,
                                  device_jitter=True))
    for (l_cls, l_mask), m in zip(aux, metrics):
        assert abs(float(m["loss_cls"]) - l_cls) <= 1e-4 * max(1, l_cls)
        assert abs(float(m["loss_mask"]) - l_mask) <= 1e-4 * max(1, l_mask)
    assert aux[0][1] > 0, "the mask loss must be live"

    after = model.state_dict()
    want = state_dict_from_jax({"params": new_params})
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
        # + the float32 spacing of the parameter values, which a tiny
        # update (weight decay alone) is measured against
        ulp = float(np.spacing(np.abs(before[name].numpy()).max()))
        np.testing.assert_allclose(d_ours, d_want, rtol=0,
                                   atol=1e-3 * scale + 2 * ulp, err_msg=name)
        moved += 1
    assert moved == sum(lab != FROZEN for lab in labels.values())


def test_lr_groups_match_jax_label_params():
    from wseg_tpu.parallel.optim import label_params as jax_labels
    from wseg_tpu_torch.optim import (
        FROZEN,
        NEW_B,
        NEW_W,
        PRE_W,
        label_params,
        make_optimizer,
    )
    from wseg_tpu_torch.utils.convert import labels_from_jax

    _, variables = jax_model_and_random_variables(seed=0, size=32)
    want = labels_from_jax(jax_labels(variables["params"], "resnet38"))
    model, cfg = _train_model(variables)
    got = label_params(model, "resnet38")
    assert set(got) <= set(want)
    for name, lab in got.items():
        assert lab == want[name], name
    # the JAX labels left over are the frozen BN statistics (buffers here)
    rest = {n: lab for n, lab in want.items() if n not in got}
    assert rest and set(rest.values()) == {FROZEN}
    assert all(n.endswith(("running_mean", "running_var")) for n in rest)
    assert {"selfattn.qkv.bias", "selfattn.proj.bias"} == {
        n for n, lab in got.items() if lab == NEW_B}
    assert got["conv1a.weight"] == FROZEN and got["b3.conv_branch1.weight"] \
        == PRE_W and got["fc8.weight"] == NEW_W

    optimizer, _ = make_optimizer(cfg.NET, model)
    lr = {g["name"]: (g["lr"], g["weight_decay"], len(g["params"]))
          for g in optimizer.param_groups}
    assert lr["pre_w"][:2] == (0.001, 0.0005)
    assert lr["pre_b"][:2] == (0.002, 0.0)
    assert lr["new_w"][:2] == (0.01, 0.0005)
    assert lr["new_b"][:2] == (0.02, 0.0)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert sorted(trainable) == sorted(n for n, lab in got.items()
                                       if lab != FROZEN)
    assert sum(v[2] for v in lr.values()) == len(trainable)
    assert optimizer.defaults["momentum"] == 0.9
    assert not optimizer.defaults["nesterov"]


@pytest.mark.parametrize("block,rate", [("b6", 0.3), ("b7", 0.5)])
def test_dropout2d_drops_whole_channels(block, rate):
    from wseg_tpu_torch.models.backbones.resnet38 import ResNet38
    from wseg_tpu_torch.models.backbones.common import Dropout2d

    bb = getattr(ResNet38(), block)
    drops = [bb.dropout_2b1, bb.dropout_2b2]
    assert all(isinstance(d, Dropout2d) and isinstance(d, torch.nn.Dropout2d)
               and d.p == rate for d in drops)
    d = drops[0].train()
    d.generator = torch.Generator().manual_seed(0)
    x = torch.ones(64, 128, 5, 7)
    y = d(x)
    plane = y.flatten(2)
    assert torch.equal(plane.amin(-1), plane.amax(-1))    # whole channels
    kept = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()
    assert set(torch.unique(y).tolist()) <= {0.0, kept}
    dropped = float((plane[..., 0] == 0).float().mean())
    sigma = (rate * (1 - rate) / (64 * 128)) ** 0.5
    assert abs(dropped - rate) < 4 * sigma, dropped
    # a seeded generator repeats its draws; eval mode is the identity
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)


def test_missing_or_unexpected_batch_keys_raise():
    from wseg_tpu_torch.engine.train_loop import (
        check_batch,
        expected_batch_keys,
        train_step,
    )

    batch = _torch_batch(_batch())
    no_jitter = {k: v for k, v in batch.items() if k != "jitter"}
    with pytest.raises(KeyError, match="missing \\['jitter'\\]"):
        train_step(None, None, no_jitter, 1.0, device_jitter=True)
    with pytest.raises(KeyError, match="unexpected \\['jitter'\\]"):
        train_step(None, None, batch, 1.0, device_jitter=False)
    with pytest.raises(KeyError, match="missing \\['labels'\\]"):
        check_batch({"image": batch["image"]},
                    expected_batch_keys(False, train=False))
    assert expected_batch_keys(True, train=False) == {"image", "labels"}
