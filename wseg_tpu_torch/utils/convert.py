"""Weight conversion between the JAX package's parameters and the port.

The port's module names are the reference torch state_dict's, so

* ``state_dict_from_jax`` turns ``wseg_tpu`` variables (a nested dict
  of numpy arrays: ``params`` and, for the ``ae`` decoder's live
  BatchNorms, ``batch_stats``) into a port state_dict;
* ``port_name`` maps one parameter path of the JAX tree to its port
  name (``labels_from_jax`` uses it to carry the JAX optimizer's
  ``label_params`` groups over);
* ``quant_stats_from_jax`` turns the int8 static mode's
  ``quant_stats`` collection into the port's ``NET.QUANT_STATS``
  contents ({conv name: float32 (cin,) amax});
* a port state_dict saved with ``torch.save`` is a reference-layout
  ``.pth``: ``wseg_tpu.utils.torch_convert.load_reference_checkpoint``
  reads it unchanged, and ``load_checkpoint`` reads either kind here;
  ``load_pretrained_backbone`` copies the backbone tensors of a
  reference ``.pth`` (an ImageNet WRN38, torchvision's ResNet-50/101,
  the flat-named VGG16) by name.

Names: the JAX backbone's ``layer{i}_{j}`` / ``downsample_conv`` /
``downsample_bn`` are torchvision's ``layer{i}.{j}`` /
``downsample.0`` / ``downsample.1``; the ``ae`` decoder's modules map
as ``wseg_tpu/utils/torch_convert.py``'s ``_AE_HEAD_MAP``; CAM_MF's
per-level ``fc8_conv6`` ... ``fc8_conv3`` are the reference's ``fc8_6``
... ``fc8_3``; every other head module (``fc7``, ``fc8``,
``selfattn.{qkv,q,kv,sr,norm,proj}``, ``caatention``, ``attention``,
``f8_3``, ``f8_4``, ``f9``) keeps its name, as ``get_head_map``
expects.  Layouts: conv kernels HWIO -> OIHW; Dense (in, out) -> (out,
in); the channel-attention fc1/fc2 Dense -> (out, in, 1, 1) 1x1 conv
weights; BatchNorm and LayerNorm scale/bias -> weight/bias, BatchNorm
mean/var -> running_mean/running_var.
"""

from __future__ import annotations

from typing import Dict, Mapping

import re

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_DOWNSAMPLE = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}
# JAX module path of the ae decoder -> reference state_dict prefix
_AE_HEAD = {
    ("decoder", "aspp", "aspp1_conv"): "aspp.aspp1.atrous_conv",
    ("decoder", "aspp", "aspp2_conv"): "aspp.aspp2.atrous_conv",
    ("decoder", "aspp", "aspp3_conv"): "aspp.aspp3.atrous_conv",
    ("decoder", "aspp", "aspp4_conv"): "aspp.aspp4.atrous_conv",
    ("decoder", "aspp", "aspp1_bn"): "aspp.aspp1.bn",
    ("decoder", "aspp", "aspp2_bn"): "aspp.aspp2.bn",
    ("decoder", "aspp", "aspp3_bn"): "aspp.aspp3.bn",
    ("decoder", "aspp", "aspp4_bn"): "aspp.aspp4.bn",
    ("decoder", "aspp", "gap_conv"): "aspp.global_avg_pool.1",
    ("decoder", "aspp", "gap_bn"): "aspp.global_avg_pool.2",
    ("decoder", "aspp", "conv1"): "aspp.conv1",
    ("decoder", "aspp", "bn1"): "aspp.bn1",
    ("decoder", "fc8_skip_conv"): "fc8_skip.0",
    ("decoder", "fc8_skip_bn"): "fc8_skip.1",
    ("decoder", "fc8_x_conv"): "fc8_x.0",
    ("decoder", "fc8_x_bn"): "fc8_x.1",
    ("decoder", "shallow_mask", "fc_deep_conv"): "shallow_mask.fc_deep.0",
    ("decoder", "shallow_mask", "fc_deep_bn"): "shallow_mask.fc_deep.1",
    ("decoder", "shallow_mask", "fc_skip_conv"): "shallow_mask.fc_skip.0",
    ("decoder", "shallow_mask", "fc_skip_bn"): "shallow_mask.fc_skip.1",
    ("decoder", "shallow_mask", "fc_cls_conv"): "shallow_mask.fc_cls.0",
    ("decoder", "shallow_mask", "fc_cls_bn"): "shallow_mask.fc_cls.1",
    ("decoder", "last_conv1"): "last_conv.0",
    ("decoder", "last_bn1"): "last_conv.1",
    ("decoder", "last_conv2"): "last_conv.4",
    ("decoder", "last_bn2"): "last_conv.5",
    ("decoder", "last_conv3"): "last_conv.8",
}
# CAM_MF's level heads (reference models/CAM_MF.py:38-41)
_MF_HEAD = {(f"fc8_conv{i}",): f"fc8_{i}" for i in (3, 4, 5, 6)}
# Dense layers that the reference implements as 1x1 convs
_DENSE_AS_CONV1X1 = ("caatention",)


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def port_name(path) -> str:
    """Port state_dict name of one JAX parameter or batch-statistics
    path, e.g. ("backbone", "b3", "bn_branch2a", "mean") ->
    b3.bn_branch2a.running_mean, ("backbone", "layer2_0",
    "downsample_bn", "scale") -> layer2.0.downsample.1.weight,
    ("decoder", "last_bn1", "var") -> last_conv.1.running_var."""
    mods, leaf = tuple(path[:-1]), path[-1]
    if leaf not in _LEAF:
        raise ValueError(f"no port slot for parameter {'/'.join(path)}")
    if mods[:1] == ("backbone",):
        mods = mods[1:]
    if mods in _AE_HEAD:
        prefix = _AE_HEAD[mods]
    elif mods in _MF_HEAD:
        prefix = _MF_HEAD[mods]
    else:
        prefix = ".".join(
            _DOWNSAMPLE.get(m, re.sub(r"^(layer\d+)_(\d+)$", r"\1.\2", m))
            for m in mods)
    return prefix + "." + _LEAF[leaf]


def state_dict_from_jax(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """``wseg_tpu`` variables (``{"params": ..., ["batch_stats": ...]}``
    or the params tree itself) -> port state_dict of float32 CPU
    tensors; ``batch_stats`` fill the live BatchNorms' running
    statistics, and an ``AffineNorm`` (a decoder scale with statistics
    in neither collection) gets its identity statistics."""
    params = variables_np.get("params", variables_np)
    leaves = _flatten(params)
    leaves.update(_flatten(variables_np.get("batch_stats", {})))
    sd = {}
    for path, v in leaves.items():
        if path[-1] == "kernel":
            if v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            elif v.ndim == 2:
                v = v.T
                mods = path[1:-1] if path[0] == "backbone" else path[:-1]
                if mods[0] in _DENSE_AS_CONV1X1:
                    v = v[:, :, None, None]
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
        sd[port_name(path)] = torch.from_numpy(np.array(v, np.float32))
    for path, v in leaves.items():
        prefix = port_name(path)[:-len(".weight")]
        if (path[-1] == "scale" and path[0] == "decoder"
                and prefix + ".running_mean" not in sd):
            sd[prefix + ".running_mean"] = torch.zeros(v.shape)
            sd[prefix + ".running_var"] = torch.ones(v.shape)
    return sd


def quant_stats_from_jax(quant_stats_np: Mapping) -> Dict[str, torch.Tensor]:
    """``wseg_tpu``'s ``quant_stats`` collection (nested numpy arrays,
    ``{"quant_stats": ...}`` or the collection itself; one ``amax`` leaf
    per static ``QuantConv``) -> {port conv name: float32 (cin,) CPU
    tensor}, the names ``port_name`` gives the convs' kernels less
    ``.weight``, as ``models/backbones/common.load_quant_stats`` takes
    them."""
    stats = quant_stats_np.get("quant_stats", quant_stats_np)
    out = {}
    for path, v in _flatten(stats).items():
        if path[-1] != "amax":
            raise ValueError(f"unexpected quant_stats leaf {'/'.join(path)}")
        name = port_name(path[:-1] + ("kernel",))[:-len(".weight")]
        out[name] = torch.from_numpy(np.array(v, np.float32))
    return out


def labels_from_jax(labels_tree: Mapping) -> Dict[str, str]:
    """The JAX optimizer's label tree (``label_params``) -> {port
    state_dict name: label}."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (k,))
            else:
                out[port_name(prefix + (k,))] = v

    walk(labels_tree, ())
    return out


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A port or reference ``.pth`` -> state_dict in port naming
    (``module.`` prefixes and BN batch counters dropped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a port or reference checkpoint into ``model`` (strict)."""
    model.load_state_dict(read_state_dict(path), strict=True)


def load_pretrained_backbone(model: torch.nn.Module, path: str) -> int:
    """Copy the tensors of a reference ``.pth`` whose names and shapes
    match the backbone's into ``model`` (the reference loads its
    ImageNet weights with strict=False); returns how many were copied.
    The backbones carry the checkpoints' own names (WRN38's, torchvision
    ResNet's, the flat VGG16 ones), so the rest -- a classifier's
    ``fc.*``, BN batch counters -- is skipped."""
    sd = read_state_dict(path)
    own = model.state_dict()
    backbone = set(model._backbone.state_dict())
    loaded = 0
    with torch.no_grad():
        for name, w in sd.items():
            if name in backbone and tuple(own[name].shape) == tuple(w.shape):
                own[name].copy_(w)
                loaded += 1
    print(f"Loaded {loaded} backbone tensors from {path}; skipped "
          f"{len(sd) - loaded}")
    return loaded
