"""Port checkpoints in the reference torch layout: a port state_dict
saved as .pth is read by the JAX package's converter unchanged, and
converting back gives identical tensors."""

import os

import numpy as np
import torch


def test_port_state_dict_round_trips_through_jax_converter(tmp_path):
    import jax

    from wseg_tpu.utils.torch_convert import load_reference_checkpoint
    from wseg_tpu_torch.models.backbones.common import seeded_init_
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    from tests.torch_parity import (
        jax_model_and_random_variables,
        port_model_from_jax,
    )

    _, jvars = jax_model_and_random_variables(seed=0, size=32)
    model = port_model_from_jax(jvars)
    seeded_init_(model, torch.Generator().manual_seed(5))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    pth = os.path.join(str(tmp_path), "port.pth")
    torch.save(sd, pth)

    loaded = load_reference_checkpoint(
        {"params": jvars["params"]}, pth, "CAM_CASA_WGAP_tf", "resnet38",
        strict=True)
    back = state_dict_from_jax(jax.tree.map(np.asarray, loaded))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v.float().contiguous()), k


def test_read_state_dict_accepts_reference_wrappers(tmp_path):
    """``{"state_dict": ...}`` wrappers, DataParallel ``module.``
    prefixes and BN batch counters are what released .pth files hold."""
    from wseg_tpu_torch.models.backbones.common import FrozenBatchNorm
    from wseg_tpu_torch.utils.convert import load_checkpoint

    bn = FrozenBatchNorm(4)
    raw = {"module.weight": torch.arange(4.0),
           "module.bias": torch.ones(4),
           "module.running_mean": torch.full((4,), 2.0),
           "module.running_var": torch.full((4,), 3.0),
           "module.num_batches_tracked": torch.tensor(7)}
    pth = os.path.join(str(tmp_path), "ref.pth")
    torch.save({"state_dict": raw}, pth)
    load_checkpoint(bn, pth)
    assert torch.equal(bn.weight, torch.arange(4.0))
    assert torch.equal(bn.running_var, torch.full((4,), 3.0))
