"""Weight conversion between the JAX package's parameters and the port.

The port's module names are the reference torch state_dict's, so

* ``state_dict_from_jax`` turns ``wseg_tpu`` variables (a nested dict
  of numpy arrays) into a port state_dict;
* ``port_name`` maps one parameter path of the JAX tree to its port
  name (``labels_from_jax`` uses it to carry the JAX optimizer's
  ``label_params`` groups over);
* a port state_dict saved with ``torch.save`` is a reference-layout
  ``.pth``: ``wseg_tpu.utils.torch_convert.load_reference_checkpoint``
  reads it unchanged, and ``load_checkpoint`` reads either kind here;
  ``load_pretrained_backbone`` copies the backbone tensors of a
  reference ``.pth`` (an ImageNet WRN38) by name.

Layouts: conv kernels HWIO -> OIHW; Dense (in, out) -> (out, in); the
channel-attention fc1/fc2 Dense -> (out, in, 1, 1) 1x1 conv weights;
FrozenBatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
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
    """Port state_dict name of one JAX parameter path, e.g.
    ("backbone", "b3", "bn_branch2a", "mean") ->
    b3.bn_branch2a.running_mean."""
    mods, leaf = list(path[:-1]), path[-1]
    if mods and mods[0] == "backbone":
        mods = mods[1:]
    is_bn = bool(mods) and (mods[-1].startswith("bn")
                            or leaf in ("mean", "var"))
    if leaf == "kernel":
        name = "weight"
    elif is_bn:
        name = _BN_LEAF[leaf]
    elif leaf == "bias":
        name = "bias"
    else:
        raise ValueError(f"no port slot for parameter {'/'.join(path)}")
    return ".".join(mods + [name])


def state_dict_from_jax(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """``wseg_tpu`` variables (``{"params": ...}`` or the params tree
    itself) -> port state_dict of float32 CPU tensors."""
    params = variables_np.get("params", variables_np)
    sd = {}
    for path, v in _flatten(params).items():
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
    return sd


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
    ImageNet weights with strict=False); returns how many were copied."""
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
