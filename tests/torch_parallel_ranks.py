"""Rank workers of ``tests/test_torch_parallel.py``.

This module imports no JAX: spawned children re-import it (and the
test module's helpers would pull JAX in).  ``launch`` starts four
processes at once (``PROCESSES``): two ranks of a ``gloo`` group
(``file://`` rendezvous, so concurrent test workers never share a
port), one process without a group and a group of one, each with two
threads.  They wait for the spec's two parts that the test then
writes (``publish``), run its cases and save each case's results as
``<case>_<tag>.pt`` (``load`` reads one).  ``collect`` joins them.
A rank takes its rows of each global batch with
``parallel.dist.rank_rows``, as the loader's sampler does.
"""

from __future__ import annotations

import multiprocessing
import os
import time

import numpy as np
import torch

THREADS = 2
TIMEOUT_S = 600
CLS = 8             # the step batches' labelled class (mask channel)


def _no_dropout(model) -> None:
    from tests.torch_parity import no_port_dropout

    no_port_dropout(model)


def min_margin(masks_dec) -> float:
    """Smallest distance of a refined-mask value to its pseudo-GT
    threshold (``pseudo_gtmask``'s cut-offs)."""
    mx = masks_dec.amax(dim=(1, 2), keepdim=True)
    cut = torch.full((masks_dec.shape[-1],), 0.6)
    cut[0] = 0.7
    return float((masks_dec - torch.clamp(mx * cut, min=0.2)).abs().min())


def _net(cfg, model: str, backbone: str = "resnet38"):
    cfg.NET.MODEL, cfg.NET.BACKBONE, cfg.NET.DTYPE = model, backbone, \
        "float32"
    cfg.NET.WEIGHT_DECAY, cfg.NET.LR = 0.0005, 0.001


def _train_model(spec, model_name: str):
    """The trainer's model carrying the spec's weights, dropout off:
    PCM takes the flagship's backbone and seeded He-normal convs where
    its shapes differ (fc8 and the refinement convs, all bias-free)."""
    from wseg_tpu_torch.config import cfg, reset_cfg
    from wseg_tpu_torch.models import get_model

    reset_cfg()
    _net(cfg, model_name)
    model = get_model(cfg.NET, num_classes=21, train=True)
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(3)
    for k, v in sd.items():
        src = spec["state_dict"].get(k)
        if src is not None and src.shape == v.shape:
            v.copy_(src)
        else:   # PCM's fc8 (on wider features), f8_3, f8_4, f9
            v.copy_(torch.randn(v.shape, generator=gen)
                    * (2.0 / v[0].numel()) ** 0.5)
    if model_name.endswith("PCM"):
        # as tests/test_torch_zoo_train.py: the other classes' scores
        # negative, the labelled class and the background scaled
        w0 = sd["fc8.weight"].clone()
        sd["fc8.weight"][1:] = -w0[1:].abs()
        sd["fc8.weight"][CLS] = w0[CLS] * 3.0
        sd["fc8.weight"][0] = w0[3] * 3.0
    _no_dropout(model)
    return model, cfg


def case_steps(spec, model_name: str, seam: bool = False,
               margins: bool = True):
    """Two SGD steps of the train step (or the SEAM step) on this rank's
    rows of the spec's global batch.  Returns each parameter's update
    (after - before) and the float32 spacing of its largest start value,
    the metrics, the LR labels and (one process) the refined masks'
    margin to their thresholds before each step (``margins``); in a
    group, rank 1
    returns instead whether its parameters equal rank 0's bit for bit."""
    from wseg_tpu_torch.engine.seam import seam_train_step
    from wseg_tpu_torch.engine.train_loop import (
        normalise_batch_image,
        train_step,
    )
    from wseg_tpu_torch.optim import make_optimizer
    from wseg_tpu_torch.parallel import dist

    model, cfg = _train_model(spec, model_name)
    optimizer, labels = make_optimizer(cfg.NET, model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: dist.rank_rows(torch.from_numpy(v))
             for k, v in spec["batch"].items()}
    jitter = "jitter" in batch
    margin, metrics = [], []
    for _ in range(2):
        if dist.world_size() == 1 and margins:
            with torch.no_grad():
                image, raw = normalise_batch_image(batch["image"],
                                                   batch.get("jitter"))
                out = model(image, raw, batch["labels"])
            margin.append(min_margin(out.masks_dec))
        if seam:
            m = seam_train_step(model, optimizer, batch, 1.0, 1.0,
                                device_jitter=jitter)
        else:
            m = train_step(model, optimizer, batch, 1.0,
                           device_jitter=jitter)
        metrics.append({k: float(v) for k, v in m.items()})
    res = {"metrics": metrics, "labels": labels, "margins": margin}
    if dist.rank() > 0:
        same = True
        for p in model.parameters():
            t = p.detach().clone()
            torch.distributed.broadcast(t, src=0)
            same = same and torch.equal(t, p.detach())
        res["same_as_rank0"] = same
        return res
    if dist.world_size() > 1:
        for p in model.parameters():
            torch.distributed.broadcast(p.detach().clone(), src=0)
    with torch.no_grad():
        res["delta"] = {n: p - before[n]
                        for n, p in model.named_parameters()}
        res["ulp"] = {n: float(np.spacing(b.abs().max().numpy()))
                      for n, b in before.items()}
    return res


def case_decoder(spec):
    """The ``ae`` decoder (psi 0, dropout off) in train mode on this
    rank's rows of the taps: the logits, the gradients of sum(logits *
    G) (the parameters' averaged over the ranks and scaled back by the
    world size, the taps' as they are) and the running statistics."""
    from wseg_tpu_torch.models.heads.softmax_ae import SoftMaxAEDecoder
    from wseg_tpu_torch.parallel import dist

    port = SoftMaxAEDecoder(21, 2048, sg_psi=0.0)
    port.load_state_dict(spec["state_dict"], strict=True)
    port.train()
    _no_dropout(port)
    t3 = dist.rank_rows(torch.from_numpy(spec["c3"])).permute(
        0, 3, 1, 2).requires_grad_(True)
    t6 = dist.rank_rows(torch.from_numpy(spec["c6"])).permute(
        0, 3, 1, 2).requires_grad_(True)
    g = dist.rank_rows(torch.from_numpy(spec["g"]))
    y = port(t3, t6).permute(0, 2, 3, 1)
    (y * g).sum().backward()
    params = list(port.parameters())
    dist.all_reduce_grads(params)
    w = dist.world_size()
    return {"logits": y.detach(),
            "grads": {n: p.grad * w for n, p in port.named_parameters()},
            "g3": t3.grad.permute(0, 2, 3, 1), "g6": t6.grad.permute(
                0, 2, 3, 1),
            "buffers": {n: b.clone() for n, b in port.named_buffers()}}


def case_batchnorm(spec):
    """One live ``BatchNorm`` (affine) in train mode: two forwards on
    this rank's rows of two global batches (outputs and running
    statistics), and the gradient of sum(y * G) of the second with
    respect to its weight, bias (averaged over the ranks, scaled back by
    the world size) and input."""
    from wseg_tpu_torch.models.backbones.common import BatchNorm
    from wseg_tpu_torch.parallel import dist

    bn = BatchNorm(spec["weight"].shape[0]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["weight"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    ys = []
    for x in spec["xs"]:
        t = dist.rank_rows(torch.from_numpy(x)).permute(
            0, 3, 1, 2).requires_grad_(True)
        ys.append(bn(t).permute(0, 2, 3, 1))
    g = dist.rank_rows(torch.from_numpy(spec["g"]))
    (ys[-1] * g).sum().backward()
    dist.all_reduce_grads([bn.weight, bn.bias])
    w = dist.world_size()
    return {"ys": [y.detach() for y in ys],
            "running": (bn.running_mean.clone(), bn.running_var.clone()),
            "grads": (bn.weight.grad * w, bn.bias.grad * w),
            "gx": t.grad.permute(0, 2, 3, 1)}


def _argv(spec, world: int, *extra):
    out = spec["out"]
    return ["--dataset", "pascal_voc", "--cfg", spec["cfg_file"],
            "--exp", "e1", "--run", "r1",
            "--snapshot-dir", os.path.join(out, f"snap_w{world}"),
            "--logdir", os.path.join(out, f"logs_w{world}"),
            "--workers", "0", "--random-seed", "3", "--device", "cpu",
            *extra]


def case_validation(spec):
    """``DecTrainer.validation`` with checkpointing on the synthetic
    VOC; then, in a group, the refusal of a batch the world size does
    not divide."""
    from wseg_tpu_torch.config import cfg, cfg_from_file, reset_cfg
    from wseg_tpu_torch.engine.trainer import DecTrainer
    from wseg_tpu_torch.opts import get_arguments
    from wseg_tpu_torch.parallel import dist

    world = dist.world_size()
    reset_cfg()
    args = get_arguments(_argv(spec, world))
    cfg_from_file(args.cfg_file)
    trainer = DecTrainer(args)
    mean_ap = trainer.validation(0, checkpoint=True)
    out = {"map": mean_ap, "score": trainer.best_score,
           "checkpoints": list(trainer.checkpoint.checkpoints),
           "val_batches": [0 if b is None else len(b["name"])
                           for b in trainer.valloader]}
    del trainer
    if world > 1:
        reset_cfg()
        cfg_from_file(args.cfg_file)
        cfg.TRAIN.BATCH_SIZE = 3
        try:
            DecTrainer(args)
        except ValueError as e:
            out["refusal"] = str(e)
    return out


def case_infer_val(spec):
    """``wseg_tpu_torch.infer_val.main`` on the synthetic VOC's
    validation list, into ``iv_w<world>``."""
    from wseg_tpu_torch import infer_val
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.parallel import dist

    world = dist.world_size()
    reset_cfg()
    infer_val.main(_argv(spec, world, "--infer-list", spec["val_list"],
                         "--mask-output-dir",
                         os.path.join(spec["out"], f"iv_w{world}")))
    return {}


def _spec(out: str, part: str) -> dict:
    """``out/<part>.pt`` once ``publish`` has written it."""
    path = os.path.join(out, part + ".pt")
    deadline = time.monotonic() + TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def run(rank: int, world: int, out: str, group: bool) -> None:
    """One process: join a ``gloo`` group of ``world`` if ``group``, run
    the cases of the spec's two parts as ``publish`` writes them (the
    CLI and BatchNorm cases first, while the test still builds the
    models' part) and save each one's results as ``<case>_<tag>.pt``
    under ``out``.  A group of one runs the flagship steps only (tag
    ``group1``)."""
    torch.set_num_threads(THREADS)
    from wseg_tpu_torch.parallel import dist

    tag = f"w{world}_r{rank}" if world > 1 or not group else "group1"

    def save(case, res):
        torch.save(res, os.path.join(out, f"{case}_{tag}.pt"))

    if group:
        dist.init(rank, world, "gloo", init_method="file://" + os.path.join(
            out, f"rendezvous_{world}"))
    if tag != "group1":
        first = _spec(out, "spec_cli")
        save("validation", case_validation(first["cli"]))
        save("infer_val", case_infer_val(first["cli"]))
        save("batchnorm", case_batchnorm(first["batchnorm"]))
    spec = _spec(out, "spec_models")
    save("flagship", case_steps(spec["flagship"], "CAM_CASA_WGAP_tf",
                                margins=not group))
    if tag != "group1":
        save("pcm", case_steps(spec["flagship"], "CAM_CASA_WGAP_PCM",
                               margins=False))
        save("seam", case_steps(spec["flagship"], "CAM_CASA_WGAP_tf",
                                seam=True, margins=False))
        save("decoder", case_decoder(spec["decoder"]))
    dist.destroy()


# (rank, world, group): two ranks, one process without a group, and a
# group of one
PROCESSES = ((0, 2, True), (1, 2, True), (0, 1, False), (0, 1, True))


def launch(out: str):
    """Start the processes of ``PROCESSES``; they wait for ``publish``
    to write the spec's parts.  Returns the processes."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, w, out, g))
             for r, w, g in PROCESSES]
    for p in procs:
        p.start()
    return procs


def publish(part: dict, out: str, name: str) -> None:
    """Write the spec's part ``name`` (``spec_cli``: ``cli`` and
    ``batchnorm``; ``spec_models``: ``flagship`` and ``decoder``) that
    the processes wait for, whole, then renamed."""
    tmp = os.path.join(out, name + ".pt.tmp")
    torch.save(part, tmp)
    os.replace(tmp, os.path.join(out, name + ".pt"))


def stop(procs) -> None:
    """Kill the processes still running."""
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)


def collect(procs) -> None:
    """Join the processes (each within ``TIMEOUT_S``); a process that
    fails or hangs fails the run (and the others are stopped)."""
    try:
        for p in procs:
            p.join(TIMEOUT_S)
        codes = [p.exitcode for p in procs]
    finally:
        stop(procs)
    if codes != [0] * len(procs):
        raise RuntimeError(f"rank processes exited with {codes}")


def load(out: str, case: str, tag: str):
    """One process's results of ``case`` (tag ``w<world>_r<rank>`` or
    ``group1``)."""
    return torch.load(os.path.join(out, f"{case}_{tag}.pt"),
                      weights_only=False)


def png_arrays(root: str) -> dict:
    """{relative path: uint8 array} of every PNG under ``root``."""
    from PIL import Image

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                path = os.path.join(d, f)
                with Image.open(path) as im:
                    out[os.path.relpath(path, root)] = np.asarray(im)
    return out
