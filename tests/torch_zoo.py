"""Shared cases of the model-zoo parity tests (tests/test_torch_zoo*.py).

``check_spec`` holds one registry key on one backbone against the JAX
package, float32 on the CPU (its parts ``zoo_case``,
``check_round_trip``, ``check_test_mode`` and ``check_train_mode`` let
a module share one case between tests): the port's model carries the
JAX model's
numpy-seeded weights (``state_dict_from_jax``, strict), its saved
``.pth`` loads back into JAX through ``load_reference_checkpoint``
(strict) onto an all-zero tree and gives every leaf back bit for bit,
and the two forwards agree

* in test mode (JAX on the round-tripped tree): ``cls`` and ``masks``;
* in train mode with dropout off in both (JAX's ``flax.linen.Dropout``
  patched to the identity by the caller's ``no_jax_dropout`` fixture,
  the port's dropouts at p = 0; ``ae`` at ``SG_PSI`` 0) and the plain
  PAMR: ``cls``, ``cls_fg``, ``masks``, ``masks_dec``, ``mask_logits``
  and ``attn_map`` (None on both sides where the head has none).

Tolerance: max |ours - ref| <= 1e-4 * max |ref| per tensor.  The
classic CAM masks are each channel's ReLU'd map divided by its maximum
z_c, which multiplies the float32 rounding of a channel with a small
z_c by 1 / z_c; so they are compared as maps before that division:
|ours - ref| * (1e-5 + z_c) <= 1e-4 * max_c z_c, with z_c recorded from
the port's forward (the background, a constant, as it is).
"""

from __future__ import annotations

import numpy as np
import torch

REL = 1e-4


def check(ours, ref, name, rel=REL):
    ref = np.asarray(ref, np.float32)
    ours = np.asarray(ours, np.float32)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-6), (name, err)


class CamScale:
    """Records the per-channel maxima z (B, 1, 1, C-1) that the port's
    ``_cam_masks`` divides by, while patched in by ``monkeypatch``."""

    def __init__(self, monkeypatch):
        from wseg_tpu_torch.models.stage_net import StageNet

        self.z = None
        orig = StageNet._cam_masks

        def cam_masks(model, masks):
            self.z = torch.amax(masks, dim=(1, 2), keepdim=True)
            return orig(model, masks)

        monkeypatch.setattr(StageNet, "_cam_masks", cam_masks)

    def check_masks(self, ours, ref, name):
        """``check`` for CAM masks on the scale of the undivided maps."""
        if self.z is None:          # softmax masks: no division
            return check(ours, ref, name)
        z = self.z.numpy()
        scale = np.concatenate([np.ones_like(z[..., :1]), 1e-5 + z], -1)
        err = float((np.abs(np.asarray(ours) - np.asarray(ref)) * scale)
                    .max())
        assert np.asarray(ours).shape == np.asarray(ref).shape, name
        assert err <= REL * float(z.max()), (name, err)


def jax_module_variables(module, seed: int, *inputs) -> dict:
    """Numpy-seeded variables of a JAX module (shapes from tracing its
    ``init`` on ``inputs``, ``tests/torch_parity.random_variables``)."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import random_variables

    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(
        key, *jax.tree_util.tree_map(jnp.asarray, inputs)))
    return random_variables(shapes, seed, ())


def port_module_from_jax(module, variables: dict, model: str = ""):
    """``module`` (a port head module) carrying a JAX module's
    ``variables`` (strict), converted as a head named ``selfattn``."""
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    sd = state_dict_from_jax({"params": {"selfattn": variables["params"]}},
                             model)
    module.load_state_dict({k[len("selfattn."):]: t for k, t in sd.items()},
                           strict=True)
    return module


def train_batch(name: str, seed: int, size: int, b: int = 2):
    """uint8 images, 1-2 labelled classes each (the background first for
    ``labels_with_bg``), colour-jitter parameters."""
    from tests.torch_parity import labels_dim

    rng = np.random.RandomState(seed)
    image = (rng.rand(b, size, size, 3) * 255).astype(np.uint8)
    labels = np.zeros((b, 20), np.float32)
    for i in range(b):
        labels[i, rng.choice(20, size=rng.randint(1, 3), replace=False)] = 1
    if labels_dim(name) == 21:
        labels = np.concatenate([np.ones((b, 1), np.float32), labels], -1)
    jitter = np.array([[1.1, 0.9, 1.2, 0.0, 2, 0, 3, 1, 1.0],
                       [0.8, 1.25, 0.7, 0.0, 1, 3, 0, 2, 1.0]],
                      np.float32)[:b]
    return {"image": image, "labels": labels, "jitter": jitter}


def zoo_case(name: str, backbone: str, size: int, seed: int = 0) -> dict:
    """One registry key on one backbone: the JAX model and its
    numpy-seeded variables, and the port's train model (float32)
    carrying them (``state_dict_from_jax``, strict)."""
    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )

    psi = 0.0 if name == "ae" else 0.3
    jm, variables = jax_zoo_model_and_random_variables(
        name, backbone, seed=seed, size=size, sg_psi=psi)
    model = port_zoo_model_from_jax(variables, name, backbone, train=True,
                                    sg_psi=psi)
    return {"name": name, "backbone": backbone, "size": size, "seed": seed,
            "jm": jm, "variables": variables, "model": model}


def check_round_trip(case: dict, tmp_path) -> dict:
    """The port model's saved ``.pth`` loads into JAX through
    ``load_reference_checkpoint`` (strict) onto an all-zero tree and
    gives every leaf back bit for bit; returns the loaded tree."""
    import flax.traverse_util as trav
    import jax

    from wseg_tpu.utils.torch_convert import load_reference_checkpoint

    name, variables = case["name"], case["variables"]
    path = str(tmp_path / f"{name}.pth")
    torch.save(case["model"].state_dict(), path)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    loaded = load_reference_checkpoint(zeros, path, name, case["backbone"],
                                       strict=True)
    for col, tree in variables.items():
        back = trav.flatten_dict(loaded[col])
        flat = trav.flatten_dict(tree)
        assert set(back) == set(flat), col
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v, err_msg=str(k))
    return loaded


def check_test_mode(case: dict, cam=None, variables=None) -> None:
    """Test-mode ``cls`` and ``masks`` of the port against JAX's on
    ``variables`` (the case's by default); ``cam`` a ``CamScale`` for
    the classic CAM masks."""
    import jax.numpy as jnp

    size, seed, model = case["size"], case["seed"], case["model"]
    x = np.random.RandomState(seed + 1).randn(2, size, size, 3).astype(
        np.float32)
    want = case["jm"].apply(variables or case["variables"], jnp.asarray(x),
                            train=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    c = 21 if model.spec.cls_all_channels else 20
    assert got.cls.shape == (2, c) and got.masks.shape == (2, size, size, 21)
    check(got.cls.numpy(), want.cls, "test cls")
    if cam is None:
        check(got.masks.numpy(), want.masks, "test masks")
    else:
        cam.check_masks(got.masks.numpy(), want.masks, "test masks")
    # the seeded weights give non-trivial masks (not one flat class)
    assert float(np.asarray(want.masks).std()) > 1e-3


def check_train_mode(case: dict, cam=None) -> None:
    """Train-mode outputs of the port against JAX's, dropout off in both
    (the caller patches JAX's) and the plain PAMR."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import no_port_dropout
    from wseg_tpu.engine.train_loop import _normalise_batch_image
    from wseg_tpu_torch.engine.train_loop import normalise_batch_image

    name, model = case["name"], case["model"]
    batch = train_batch(name, case["seed"] + 2, case["size"])
    img, raw = _normalise_batch_image(jnp.asarray(batch["image"]),
                                      jnp.asarray(batch["jitter"]))
    key = jax.random.PRNGKey(1)
    want, _ = case["jm"].apply(case["variables"], img, raw,
                               jnp.asarray(batch["labels"]), train=True,
                               rngs={"dropout": key, "sg": key},
                               mutable=["batch_stats"])
    model.train()
    assert no_port_dropout(model) >= (
        1 if case["backbone"] == "resnet38" else 0)
    image, raw_t = normalise_batch_image(torch.from_numpy(batch["image"]),
                                         torch.from_numpy(batch["jitter"]))
    with torch.no_grad():
        got = model(image, raw_t, torch.from_numpy(batch["labels"]))
    for key in ("cls", "cls_fg", "masks", "masks_dec", "mask_logits",
                "attn_map"):
        g, w = getattr(got, key), getattr(want, key)
        assert (g is None) == (w is None), key
        if key == "masks" and cam is not None:
            cam.check_masks(g.numpy(), w, "train masks")
        elif g is not None:
            check(g.numpy(), w, f"train {key}")
    spec = model.spec
    assert (got.masks_dec is None) == (not spec.refine)
    assert (got.attn_map is None) == (not spec.loss_at)


def check_spec(name: str, backbone: str, size: int, tmp_path, monkeypatch,
               seed: int = 0) -> None:
    """The ``.pth`` round trip, test mode on the round-tripped tree and
    train mode of one registry key on one backbone."""
    cam = CamScale(monkeypatch)
    case = zoo_case(name, backbone, size, seed)
    loaded = check_round_trip(case, tmp_path)
    check_test_mode(case, cam, loaded)
    del loaded
    check_train_mode(case, cam)
