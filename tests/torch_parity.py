"""Shared helpers for the JAX-vs-port parity tests (tests/test_torch_*).

Both packages get the same inputs and the same weights: the JAX model's
parameter tree is filled leaf by leaf from a numpy seed (Flax's own
init leaves every FrozenBatchNorm at the identity, which would never
test the BN fold) and converted to the port with
``state_dict_from_jax``.
"""

from __future__ import annotations

import numpy as np


def jax_model_and_random_variables(seed: int = 0, size: int = 64):
    """WRN38 + CAM_CASA_WGAP_tf (float32) with every parameter leaf
    drawn from ``seed``: He-normal kernels (the last conv of each
    residual branch scaled by 0.1 so activations stay O(1) through the
    stack), random BN affine and statistics with var > 0."""
    import flax.traverse_util as trav
    import jax
    import jax.numpy as jnp

    from wseg_tpu.config import cfg
    from wseg_tpu.models import get_model

    cfg.NET.MODEL = "CAM_CASA_WGAP_tf"
    cfg.NET.BACKBONE = "resnet38"
    cfg.NET.DTYPE = "float32"
    model = get_model(cfg.NET, num_classes=21)
    key = jax.random.PRNGKey(0)
    # only the parameter shapes are needed: trace init, do not run it
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key, "sg": key},
        jnp.zeros((1, size, size, 3), jnp.float32), train=False))
    flat = trav.flatten_dict(shapes["params"])
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in sorted(flat.items()):
        leaf, shape = path[-1], v.shape
        if leaf == "kernel":
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
            last = ("conv_branch2b2" if path[:-2] + ("conv_branch2b2",
                                                      "kernel") in flat
                    else "conv_branch2b1")
            if path[-2] == last:
                a = a * 0.1
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif leaf == "mean":
            a = 0.1 * rng.randn(*shape)
        elif leaf == "var":
            a = np.maximum(np.abs(1.0 + 0.1 * rng.randn(*shape)), 0.5)
        else:  # biases
            a = 0.05 * rng.randn(*shape)
        out[path] = a.astype(np.float32)
    return model, {"params": trav.unflatten_dict(out)}


def port_model_from_jax(variables, dtype: str = "float32"):
    """The port's flagship model carrying ``variables``' weights."""
    from wseg_tpu_torch.config import _default_cfg
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    net = _default_cfg().NET
    net.MODEL = "CAM_CASA_WGAP_tf"
    net.BACKBONE = "resnet38"
    net.DTYPE = dtype
    model = get_model(net, num_classes=21)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _random_leaf(rng, path, shape, flat, last_conv):
    """One numpy-seeded leaf: He-normal kernels (each residual branch's
    last conv scaled by 0.1: ``last_conv`` names it, or is a tuple of
    names of which a block's first present one is its last conv), BN
    affine near 1 and statistics with var > 0, small biases."""
    leaf = path[-1]
    if not isinstance(last_conv, str):
        last_conv = next((n for n in last_conv
                          if path[:-2] + (n, "kernel") in flat), None)
    if leaf == "kernel":
        a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        if path[-2] == last_conv:
            a = a * 0.1
    elif leaf == "scale":
        a = 1.0 + 0.1 * rng.randn(*shape)
    elif leaf == "mean":
        a = 0.1 * rng.randn(*shape)
    elif leaf == "var":
        a = np.maximum(np.abs(1.0 + 0.1 * rng.randn(*shape)), 0.5)
    else:  # biases
        a = 0.05 * rng.randn(*shape)
    return a.astype(np.float32)


def random_variables(shapes, seed: int = 0, last_conv: str = "conv3"):
    """``params`` and ``batch_stats`` of a JAX variables shape tree (as
    ``jax.eval_shape`` of ``init`` returns it), every leaf drawn from
    ``seed`` by ``_random_leaf``."""
    import flax.traverse_util as trav

    rng = np.random.RandomState(seed)
    out = {}
    for col in ("params", "batch_stats"):
        if col not in shapes:
            continue
        flat = trav.flatten_dict(shapes[col])
        out[col] = trav.unflatten_dict({
            path: _random_leaf(rng, path, v.shape, flat, last_conv)
            for path, v in sorted(flat.items())})
    return out


def jax_ae_model_and_random_variables(backbone: str, seed: int = 0,
                                      size: int = 65, sg_psi: float = 0.3):
    """The JAX SoftMaxAE model (``NET.MODEL ae``, float32) on
    ``backbone`` with every parameter and batch statistic drawn from
    ``seed`` (bottlenecks' conv3 scaled by 0.1)."""
    import jax
    import jax.numpy as jnp

    from wseg_tpu.config import cfg
    from wseg_tpu.models import get_model

    cfg.NET.MODEL = "ae"
    cfg.NET.BACKBONE = backbone
    cfg.NET.DTYPE = "float32"
    cfg.NET.SG_PSI = sg_psi
    model = get_model(cfg.NET, num_classes=21)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key, "sg": key},
        jnp.zeros((1, size, size, 3), jnp.float32), train=False))
    return model, random_variables(shapes, seed)


def port_ae_model_from_jax(variables, backbone: str, train: bool = False,
                           sg_psi: float = 0.3):
    """The port's ``ae`` model on ``backbone`` carrying ``variables``'
    weights and batch statistics (float32; ``train`` builds the trainer's
    model, in ``.train()``)."""
    return port_zoo_model_from_jax(variables, "ae", backbone, train=train,
                                   sg_psi=sg_psi)


# the last conv of each residual branch, per backbone (scaled by 0.1)
LAST_CONVS = {"resnet38": ("conv_branch2b2", "conv_branch2b1"),
              "resnet50": "conv3", "resnet101": "conv3", "vgg16": ()}


def labels_dim(name: str) -> int:
    """Label width of a registry key: C, or C - 1 for every key but the
    ``labels_with_bg`` one."""
    return 21 if name == "CAM_CASA_WGAP_v4" else 20


def jax_zoo_model_and_random_variables(name: str, backbone: str,
                                       seed: int = 0, size: int = 64,
                                       sg_psi: float = 0.3):
    """The JAX StageNet of registry key ``name`` on ``backbone``
    (float32, the default BG_SCORE, focal and PAMR settings, the plain
    ``lax`` PAMR) with every parameter and batch statistic drawn from
    ``seed``.  The shapes come from a train-path init (labels given), so
    PCM's refinement convs exist."""
    import jax
    import jax.numpy as jnp

    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.models import get_model

    net = jax_default_cfg().NET
    net.MODEL, net.BACKBONE, net.DTYPE = name, backbone, "float32"
    net.SG_PSI, net.PAMR_IMPL = sg_psi, "lax"
    model = get_model(net, num_classes=21)
    key = jax.random.PRNGKey(0)
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key, "sg": key}, img, img,
        jnp.zeros((1, labels_dim(name)), jnp.float32), train=False))
    return model, random_variables(shapes, seed, LAST_CONVS[backbone])


def port_zoo_model_from_jax(variables, name: str, backbone: str,
                            train: bool = False, sg_psi: float = 0.3):
    """The port's model of registry key ``name`` on ``backbone`` carrying
    ``variables``' weights and batch statistics (float32, loaded with
    ``strict=True``; ``train`` builds the trainer's model, in
    ``.train()``)."""
    from wseg_tpu_torch.config import _default_cfg
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    net = _default_cfg().NET
    net.MODEL, net.BACKBONE, net.DTYPE = name, backbone, "float32"
    net.SG_PSI = sg_psi
    model = get_model(net, num_classes=21, train=train)
    model.load_state_dict(state_dict_from_jax(variables, name), strict=True)
    return model


def no_port_dropout(model) -> int:
    """Set every dropout and channel dropout of the port's ``model`` to
    p = 0; returns how many there are."""
    from wseg_tpu_torch.models.backbones.common import Dropout, Dropout2d

    n = 0
    for m in model.modules():
        if isinstance(m, (Dropout, Dropout2d)):
            m.p = 0.0
            n += 1
    return n
