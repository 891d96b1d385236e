"""The port's data parallelism (``wseg_tpu_torch/parallel``) on the CPU:
two ``gloo`` ranks against one process on the global batch, and against
the JAX package's steps on a 2-way ``data`` mesh of ``tests/
conftest.py``'s 8 virtual CPU devices.

One module fixture starts three processes from the JAX-free
``tests/torch_parallel_ranks.py`` (two ranks and one process without a
group, two threads each) and, while they run, computes the JAX
references.  Each process runs every case on its rows of the same
global batches:

* the flagship (WRN38 + ``CAM_CASA_WGAP_tf``, float32, crop 64, global
  batch 2 with a live mask loss), PCM (WRN38, its refinement convs
  unreached by the loss) and SEAM (the flagship head) steps: two SGD
  steps each.  Two ranks against one process: every parameter within
  1e-5 of its tensor's largest update plus two float32 spacings of its
  values, the metrics within 1e-5 of the value or of 1.  The flagship
  against ``make_train_step`` with the batch sharded over
  ``make_mesh(n_data=2)``: ``tests/test_torch_train_step.py``'s
  tolerance (1e-3 of the largest update + 2 spacings) on that test's
  colour-jittered batch, which JAX's step takes normalised (the jitter
  applied eagerly, as that test does).  Dropout is off on both sides (JAX's
  ``flax.linen.Dropout`` patched to the identity, the port's at p = 0);
* one live ``BatchNorm`` and the ``ae`` decoder (psi 0) in train mode,
  global batch 4: outputs and running statistics within 1e-6, the
  gradients within ``tests/test_torch_ae.py``'s rel 5e-5 of each
  tensor's largest, against one process, against ``flax.linen.
  BatchNorm`` on the global batch and JAX's decoder step on the mesh
  (see ``test_ae_decoder_global_statistics``), and JAX's decoder step
  sharded over the mesh against the same step unsharded (GSPMD's
  statistics span the global batch);
* ``DecTrainer.validation`` on a synthetic VOC with a ragged last batch
  (rank 0 gets no row of it): mAP and checkpoint score within 1e-6 of
  one process's, and rank 0 alone writes the checkpoint; a batch the
  world size does not divide raises;
* ``infer_val`` (each rank serves every other image): the union of the
  ranks' PNGs bit-equal to one process's;
* a world of one (a group made) bit-equal to no group.

The checkpoints and PNGs are deleted after the module.
"""

import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as ranks

SIZE = 64
CLS = ranks.CLS      # the step batches' labelled class (mask channel)
BATCH_SEED = 17      # tests/test_torch_train_step.py's batch (jittered):
                     # a live mask loss, refined masks > 3e-4 from their
                     # pseudo-GT thresholds before each step
STEP_REL = 1e-5      # two ranks vs one process: of the largest update
JAX_REL = 1e-3       # vs JAX's step (tests/test_torch_train_step.py)
GRAD_REL = 5e-5      # decoder gradients (tests/test_torch_ae.py)
STAT_TOL = 1e-6      # BatchNorm outputs and running statistics


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _flagship_spec():
    """The JAX flagship model and its numpy-seeded variables, whose fc8
    makes the background and class ``CLS`` win somewhere (a live mask
    loss, as ``tests/test_torch_train_step.py``), and the spec of the
    step cases: the port's state_dict and a global batch of 2."""
    from tests.torch_parity import jax_model_and_random_variables
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    jm, variables = jax_model_and_random_variables(seed=5, size=SIZE)
    k = np.array(variables["params"]["fc8"]["kernel"])
    k0 = k.copy()
    k[..., CLS] *= 3.0
    k[..., 0] = k0[..., 3] * 3.0
    variables["params"]["fc8"]["kernel"] = k
    rng = np.random.RandomState(BATCH_SEED)
    image = (rng.rand(2, SIZE, SIZE, 3) * 255).astype(np.uint8)
    labels = np.zeros((2, 20), np.float32)
    labels[:, CLS - 1] = 1.0
    jitter = np.array([[1.1, 0.9, 1.2, 0.0, 2, 0, 3, 1, 1.0],
                       [0.8, 1.25, 0.7, 0.0, 1, 3, 0, 2, 1.0]], np.float32)
    return jm, variables, {"state_dict": state_dict_from_jax(variables),
                           "batch": {"image": image, "labels": labels,
                                     "jitter": jitter}}


def _decoder_spec():
    """The JAX ``ae`` decoder (psi 0) with seeded variables and taps of a
    global batch of 4 (resnet50's at a 65 crop)."""
    from tests.torch_parity import random_variables
    from wseg_tpu.models.heads.softmax_ae import SoftMaxAEDecoder
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    rng = np.random.RandomState(2)
    c3 = np.maximum(rng.randn(4, 17, 17, 256), 0).astype(np.float32)
    c6 = np.maximum(rng.randn(4, 5, 5, 2048), 0).astype(np.float32)
    g = rng.randn(4, 17, 17, 20).astype(np.float32)
    jm = SoftMaxAEDecoder(21, 0.0)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key, "sg": key}, jnp.asarray(c3),
        jnp.asarray(c6)))
    variables = random_variables(shapes, seed=6)
    # the JAX decoder's paths lack the model's "decoder" level
    sd = state_dict_from_jax({col: {"decoder": tree}
                              for col, tree in variables.items()})
    return jm, variables, {"state_dict": sd, "c3": c3, "c6": c6, "g": g}


def _batchnorm_spec():
    rng = np.random.RandomState(0)
    return {"xs": [(rng.randn(4, 3, 5, 8) * 2 + 1).astype(np.float32)
                   for _ in range(2)],
            "weight": (1 + 0.1 * rng.randn(8)).astype(np.float32),
            "bias": (0.1 * rng.randn(8)).astype(np.float32),
            "g": rng.randn(4, 3, 5, 8).astype(np.float32)}


def _cli_spec(out: str):
    """A synthetic VOC (2 training images, 5 validation ones: batches of
    2, 2 and 1) and a ResNet-50 ``bsl`` config at crop 48."""
    from tests.synthetic_voc import make_synthetic_voc

    root = make_synthetic_voc(os.path.join(out, "data"), n_train=2,
                              n_val=5)
    cfg_file = os.path.join(out, "cfg.yaml")
    with open(cfg_file, "w") as f:
        f.write(textwrap.dedent(f"""\
            DATASET:
              CROP_SIZE: 48
              ROOT: "{root}"
              FILENAME: "train_augvoc"
            TRAIN:
              BATCH_SIZE: 2
              NUM_EPOCHS: 0
              PRETRAIN: 0
            NET:
              BACKBONE: "resnet50"
              MODEL: "bsl"
              DTYPE: "float32"
              PRE_WEIGHTS_PATH: "{root}/no_such_weights.pth"
            TEST:
              METHOD: "multiscale"
              DATA_ROOT: "{root}"
              BATCH_SIZE: 2
              PAD_SIZE: [128, 128]
              PAD_ALIGN: 32
              SCALES: [1, 0.5]
              USE_GT_LABELS: False
              CRF_DTYPE: "float32"
            """))
    return {"out": out, "cfg_file": cfg_file,
            "val_list": os.path.join(root, "val_voc.txt")}


def _no_jax_dropout(mp):
    import flax.linen as fnn

    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)


def _jax_flagship_on_mesh(jm, variables, batch):
    """Two ``make_train_step`` steps with the state replicated and the
    batch sharded over a 2-way ``data`` mesh; the parameters after them
    and each step's metrics."""
    from wseg_tpu.config import _default_cfg as jax_default_cfg
    from wseg_tpu.engine.train_loop import (
        _normalise_batch_image,
        create_train_state,
        make_train_step,
    )
    from wseg_tpu.parallel import make_mesh
    from wseg_tpu.parallel.mesh import replicate, shard_batch
    from wseg_tpu.parallel.optim import make_optimizer

    net = jax_default_cfg().NET
    net.MODEL, net.BACKBONE, net.DTYPE = "CAM_CASA_WGAP_tf", "resnet38", \
        "float32"
    net.WEIGHT_DECAY, net.LR = 0.0005, 0.001
    tx, _ = make_optimizer(net, "resnet38", variables["params"])
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    state = replicate(mesh, create_train_state(jm, tx, None, None,
                                               variables=variables))
    step = make_train_step(jm, tx)
    # the colour jitter applied eagerly, as tests/test_torch_train_step.py
    # does: the step takes the normalised float32 batch (its
    # pre-normalised contract), since XLA's jitted jitter rounds
    # otherwise (ROADMAP C)
    image, _ = _normalise_batch_image(jnp.asarray(batch["image"]),
                                      jnp.asarray(batch["jitter"]))
    jb = shard_batch(mesh, {"image": np.asarray(image),
                            "labels": batch["labels"]})
    assert len(jb["image"].sharding.device_set) == 2
    metrics = []
    for _ in range(2):
        state, m = step(state, jb, jax.random.PRNGKey(0), 1.0)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state.params), metrics


def _jax_decoder(jm, variables, spec, mesh=None):
    """The JAX decoder's train-mode logits, gradients of sum(logits * G)
    (params, conv3, conv6) and batch statistics, with the taps sharded
    over ``mesh``'s ``data`` axis when one is given."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = jax.random.PRNGKey(0)
    args = [jnp.asarray(spec[k]) for k in ("c3", "c6", "g")]
    if mesh is not None:
        args = [jax.device_put(a, NamedSharding(mesh, P("data")))
                for a in args]

    def loss(params, a3, a6, g):
        y, upd = jm.apply({**variables, "params": params}, a3, a6,
                          train=True, rngs={"dropout": key, "sg": key},
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    grads, (y, upd) = jax.jit(jax.grad(loss, argnums=(0, 1, 2),
                                       has_aux=True))(
        variables["params"], *args)
    return jax.device_get((grads, y, upd["batch_stats"]))


def _jax_decoder_f64(jm, variables, spec):
    """``_jax_decoder`` in float64 (``jax_enable_x64`` on for the call
    only)."""
    def f64(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)

    jax.config.update("jax_enable_x64", True)
    try:
        return _jax_decoder(jm.clone(dtype=jnp.float64), f64(variables), {
            k: np.asarray(spec[k], np.float64) for k in ("c3", "c6", "g")})
    finally:
        jax.config.update("jax_enable_x64", False)


def _flax_batchnorm(spec):
    """``flax.linen.BatchNorm`` (momentum 0.9) on the global batches:
    outputs, running statistics, and the gradients of the second
    batch's sum(y * G)."""
    import flax.linen as fnn

    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(spec["xs"][0]))
    v = {"params": {"scale": jnp.asarray(spec["weight"]),
                    "bias": jnp.asarray(spec["bias"])},
         "batch_stats": v["batch_stats"]}
    ys = []
    for x in spec["xs"]:
        before = v
        y, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {**v, **upd}
        ys.append(np.asarray(y))

    def loss(params, x):
        y, _ = jm.apply({**before, "params": params}, x,
                        mutable=["batch_stats"])
        return jnp.sum(y * spec["g"])

    gp, gx = jax.grad(loss, argnums=(0, 1))(before["params"],
                                             jnp.asarray(spec["xs"][-1]))
    return ys, v["batch_stats"], gp, np.asarray(gx)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory of the processes' results, the spec and the JAX
    references; the directory (checkpoints, PNGs, ~0.4 GB result files)
    is removed afterwards, also when the processes fail."""
    from wseg_tpu.parallel import make_mesh
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    out = str(tmp_path_factory.mktemp("parallel"))
    try:
        procs = ranks.launch(out)     # they start while the spec is made
        try:
            spec = {"batchnorm": _batchnorm_spec(), "cli": _cli_spec(out)}
            ranks.publish(spec, out, "spec_cli")
            jm, variables, flagship = _flagship_spec()
            jdec, dvars, decoder = _decoder_spec()
            models = {"flagship": flagship, "decoder": decoder}
            ranks.publish(models, out, "spec_models")
            spec.update(models)
        except BaseException:
            ranks.stop(procs)
            raise
        try:
            mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
            with pytest.MonkeyPatch.context() as mp:
                _no_jax_dropout(mp)
                jax_params, jax_metrics = _jax_flagship_on_mesh(
                    jm, variables, flagship["batch"])
                refs = {"decoder": (
                            _jax_decoder(jdec, dvars, decoder),
                            _jax_decoder(jdec, dvars, decoder, mesh),
                            _jax_decoder_f64(jdec, dvars, decoder)),
                        "batchnorm": _flax_batchnorm(spec["batchnorm"])}
            after = state_dict_from_jax({"params": jax_params})
            before = flagship["state_dict"]
            refs["flagship"] = ({k: v - before[k] for k, v in after.items()},
                                jax_metrics)
        finally:
            ranks.collect(procs)
        yield {"spec": spec, "ref": refs, "out": out}
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _results(runs, case):
    """(rank 0's, rank 1's, one process's) results of ``case``."""
    return tuple(ranks.load(runs["out"], case, tag)
                 for tag in ("w2_r0", "w2_r1", "w1_r0"))


def _assert_close(got, want, atol, name):
    """max(|got - want| - atol) <= 0, elementwise."""
    excess = float(((got - want).abs() - atol).max())
    assert excess <= 0, (name, excess, atol)


def _check_steps(runs, case):
    """Two ranks' updates (rank 1's parameters bit-equal to rank 0's)
    and metrics against one process's: each update within ``STEP_REL``
    of its tensor's largest plus two float32 spacings of its start
    values, frozen tensors unmoved.  Returns (rank 0's, one process's)
    results."""
    from wseg_tpu_torch.optim import FROZEN

    r0, r1, one = _results(runs, case)
    assert r1["same_as_rank0"]
    for res in (r0, r1):
        for m2, m1 in zip(res["metrics"], one["metrics"]):
            assert set(m2) == set(m1)
            for k, v in m1.items():
                assert abs(m2[k] - v) <= 1e-5 * max(1.0, abs(v)), \
                    (k, m2[k], v)
    labels = one["labels"]
    moved = 0
    for name, d1 in one["delta"].items():
        d2 = r0["delta"][name]
        scale = float(d1.abs().max())
        if labels.get(name, FROZEN) == FROZEN:
            assert scale == 0.0 and float(d2.abs().max()) == 0.0, name
            continue
        assert scale > 0, name
        _assert_close(d2, d1, STEP_REL * scale + 2 * one["ulp"][name], name)
        moved += 1
    assert moved == sum(lab != FROZEN for lab in labels.values())
    return r0, one


def test_flagship_steps_match_one_process_and_jax_mesh(runs):
    r0, one = _check_steps(runs, "flagship")
    assert min(one["margins"]) > 3e-4, one["margins"]
    assert one["metrics"][0]["loss_mask"] > 0, "the mask loss must be live"

    jax_delta, jax_metrics = runs["ref"]["flagship"]
    for mj, m2 in zip(jax_metrics, r0["metrics"]):
        for k in ("loss_cls", "loss_mask", "loss"):
            assert abs(m2[k] - mj[k]) <= 1e-4 * max(1.0, abs(mj[k])), k
    # the rest of JAX's frozen BN leaves are the port's buffers
    assert set(r0["delta"]) <= set(jax_delta)
    for name in set(jax_delta) - set(r0["delta"]):
        assert name.endswith(("running_mean", "running_var")), name
        assert float(jax_delta[name].abs().max()) == 0.0, name
    for name, d in r0["delta"].items():
        scale = float(jax_delta[name].abs().max())
        _assert_close(d, jax_delta[name],
                      JAX_REL * scale + 2 * r0["ulp"][name], name)


def test_world_of_one_is_bit_equal_to_no_group(runs):
    """A process group of one (the all-reduces run, over one rank) steps
    bit for bit as no group."""
    one = ranks.load(runs["out"], "flagship", "w1_r0")
    group1 = ranks.load(runs["out"], "flagship", "group1")
    assert group1["metrics"] == one["metrics"]
    for name, d in one["delta"].items():
        assert torch.equal(group1["delta"][name], d), name


def test_pcm_steps_match_one_process(runs):
    """PCM's f8_3, f8_4 and f9 feed only the detached pseudo-GT: their
    gradient is zero, and weight decay with momentum moves them alike on
    both sides."""
    from wseg_tpu_torch.optim import FROZEN

    _, one = _check_steps(runs, "pcm")
    for name in ("f8_3.weight", "f8_4.weight", "f9.weight"):
        assert one["labels"][name] != FROZEN
        assert float(one["delta"][name].abs().max()) > 0, name


def test_seam_steps_match_one_process(runs):
    _, one = _check_steps(runs, "seam")
    assert one["metrics"][0]["loss_er"] > 0


def _cat(a, b):
    return torch.cat([a, b])


def test_global_batchnorm_matches_one_process_and_flax(runs):
    ys, stats, gp, gx = runs["ref"]["batchnorm"]
    *two, one = _results(runs, "batchnorm")
    for i, y in enumerate(ys):
        got = _cat(two[0]["ys"][i], two[1]["ys"][i]).numpy()
        np.testing.assert_allclose(got, one["ys"][i].numpy(), rtol=0,
                                   atol=STAT_TOL * 10)
        np.testing.assert_allclose(got, y, rtol=1e-5, atol=1e-5)
    for r in two:
        for ours, mine, key in zip(r["running"], one["running"],
                                   ("mean", "var")):
            np.testing.assert_allclose(ours.numpy(), mine.numpy(), rtol=0,
                                       atol=STAT_TOL)
            np.testing.assert_allclose(ours.numpy(), np.asarray(stats[key]),
                                       rtol=STAT_TOL, atol=STAT_TOL)
    for ours, want in zip(two[0]["grads"], (gp["scale"], gp["bias"])):
        err = float(np.abs(ours.numpy() - np.asarray(want)).max())
        assert err <= GRAD_REL * float(np.abs(want).max()), err
    gx2 = _cat(two[0]["gx"], two[1]["gx"]).numpy()
    assert float(np.abs(gx2 - gx).max()) <= GRAD_REL * float(
        np.abs(gx).max())


def _rel(ours, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(ours) - ref).max()) / max(
        float(np.abs(ref).max()), 1e-6)


def test_ae_decoder_global_statistics(runs):
    """JAX's decoder step sharded over the mesh against its unsharded
    step: GSPMD normalises with the global batch's statistics (rel
    2e-5, ``tests/test_torch_ae.py``'s; measured 2.3e-6 on the running
    means, where each shard's own statistics would differ by up to
    0.3).  Two ranks against one process (running statistics 1e-6,
    gradients rel 5e-5), and against JAX: logits and running statistics
    rel 2e-5 of the sharded float32 step; gradients rel 5e-5 of the
    same step in float64.  At this batch of 4 JAX's float32 gradients
    are off its float64 ones by up to 7.9e-2 of a tensor's largest
    (``last_conv.0``): Flax takes the variance as E[x^2] - E[x]^2 in
    float32, while the port's agree with float64 to 1.4e-6 (ROADMAP
    C)."""
    from wseg_tpu_torch.utils.convert import state_dict_from_jax

    *two, one = _results(runs, "decoder")
    (g_u, y_u, bs_u), (g_s, y_s, bs_s), (g_64, y_64, _) = \
        runs["ref"]["decoder"]
    # JAX: sharded == unsharded
    assert _rel(y_s, y_u) <= 2e-5
    for a, b in zip(jax.tree.leaves(g_s), jax.tree.leaves(g_u)):
        assert _rel(a, b) <= GRAD_REL
    for a, b in zip(jax.tree.leaves(bs_s), jax.tree.leaves(bs_u)):
        assert _rel(a, b) <= 2e-5
    # the port: two ranks == one process == JAX
    logits = _cat(two[0]["logits"], two[1]["logits"]).numpy()
    assert _rel(logits, one["logits"].numpy()) <= 2e-5
    assert _rel(logits, y_s) <= 2e-5 and _rel(logits, y_64) <= 2e-5
    want_g = state_dict_from_jax({"params": {"decoder": g_64[0]}})
    n = 0
    for name, g in two[0]["grads"].items():
        assert torch.equal(g, two[1]["grads"][name]), name
        assert _rel(g.numpy(), one["grads"][name].numpy()) <= GRAD_REL, name
        assert _rel(g.numpy(), want_g[name].numpy()) <= GRAD_REL, name
        n += 1
    assert n == 39
    for key, want in (("g3", g_64[1]), ("g6", g_64[2])):
        got = _cat(two[0][key], two[1][key]).numpy()
        assert _rel(got, one[key].numpy()) <= GRAD_REL, key
        assert _rel(got, want) <= GRAD_REL, key
    after = state_dict_from_jax({"decoder": bs_s})
    assert len(after) == 14          # 7 live BNs x (mean, var)
    start = runs["spec"]["decoder"]["state_dict"]
    for name, w in after.items():
        for r in two:
            assert not torch.equal(r["buffers"][name], start[name]), name
            np.testing.assert_allclose(r["buffers"][name].numpy(),
                                       one["buffers"][name].numpy(),
                                       rtol=0, atol=STAT_TOL, err_msg=name)
            assert _rel(r["buffers"][name].numpy(), w.numpy()) <= 2e-5, \
                name


def test_validation_matches_one_process(runs):
    *two, one = _results(runs, "validation")
    assert one["val_batches"] == [2, 2, 1]
    assert two[0]["val_batches"] == [1, 1, 0]
    assert two[1]["val_batches"] == [1, 1, 1]
    for r in two:
        assert abs(r["map"] - one["map"]) <= 1e-6
        assert abs(r["score"] - one["score"]) <= 1e-6
    # rank 0 alone writes the checkpoint
    assert len(one["checkpoints"]) == 1 and len(two[0]["checkpoints"]) == 1
    assert two[1]["checkpoints"] == []
    snap = os.path.join(runs["out"], "snap_w2", "pascal_voc", "e1", "r1")
    assert sorted(os.listdir(snap)) == sorted(
        f"{kind}_enc_{two[0]['checkpoints'][0]}.pth"
        for kind in ("model", "opt"))


def test_indivisible_batch_is_refused(runs):
    from wseg_tpu_torch.engine.trainer import batch_divisor_error

    for r in _results(runs, "validation")[:2]:
        msg = r["refusal"]
        assert msg == batch_divisor_error(3, 2)
        assert "world size 2" in msg and "(1, 3)" in msg


def test_infer_val_ranks_write_one_process_pngs(runs):
    out = runs["out"]
    n = 0
    for suffix in ("0", "1"):
        two = ranks.png_arrays(os.path.join(out, f"iv_w2_{suffix}"))
        one = ranks.png_arrays(os.path.join(out, f"iv_w1_{suffix}"))
        assert one and sorted(two) == sorted(one)
        for name, a in one.items():
            assert np.array_equal(two[name], a), name
            n += 1
    assert n == 2 * 5 * 3    # thresholds x images x (no_crf, crf, vis)


@pytest.mark.parametrize("n,b,w,shuffle", [
    (10, 4, 2, True), (12, 4, 4, True), (9, 3, 3, True), (8, 8, 2, False),
    (5, 2, 2, False), (7, 4, 2, False), (3, 4, 4, False)])
def test_sampler_ranks_concatenate_to_one_process(n, b, w, shuffle):
    """Shuffled (training, last partial batch dropped) or in order
    (validation, all of it): every rank yields as many batches, and the
    ranks' rows concatenated in rank order are one process's batch,
    for N not divisible by B too."""
    from wseg_tpu_torch.data.loader import GlobalBatchSampler

    def sampler(r, world):
        return GlobalBatchSampler(n, b, shuffle=shuffle, drop_last=shuffle,
                                  generator=torch.Generator().manual_seed(7),
                                  rank=r, world=world)

    solo = list(sampler(0, 1))
    assert len(solo) == len(sampler(0, 1))
    parts = [list(sampler(r, w)) for r in range(w)]
    assert [len(p) for p in parts] == [len(solo)] * w
    assert all(len(sampler(r, w)) == len(solo) for r in range(w))
    for j, batch in enumerate(solo):
        assert sum((p[j] for p in parts), []) == batch
    flat = [i for batch in solo for i in batch]
    if shuffle:
        assert all(len(batch) == b for batch in solo)
        assert len(solo) == n // b and len(set(flat)) == len(flat)
    else:
        assert flat == list(range(n))


def test_loader_seeds_each_rank_apart(tmp_path, monkeypatch):
    """Rank r's augmentation rng and worker generator are seeded with
    seed + r; its sampler draws the global permutation (seed)."""
    import types

    from tests.synthetic_voc import make_synthetic_voc
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.data import loader as loader_mod
    from wseg_tpu_torch.parallel import dist

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=8, n_val=1)
    cfg.DATASET.ROOT = root
    cfg.DATASET.CROP_SIZE = 32
    cfg.TRAIN.BATCH_SIZE = 4
    args = types.SimpleNamespace(random_seed=3, workers=0, device="cpu")
    got = {}
    for r in (0, 1):
        monkeypatch.setattr(dist, "rank", lambda r=r: r)
        monkeypatch.setattr(dist, "world_size", lambda: 2)
        dl = loader_mod.get_dataloader(args, cfg, "train_augvoc")
        want = np.random.RandomState(3 + r).get_state()[1]
        assert np.array_equal(dl.dataset.rng.get_state()[1], want)
        assert dl.batch_sampler.rank == r and dl.batch_sampler.world == 2
        got[r] = [b["name"] for b in dl]
    assert [len(v) for v in got.values()] == [2, 2]
    assert all(len(names) == 2 for v in got.values() for names in v)
    assert not set(got[0][0]) & set(got[1][0])


def test_rank_rows_split_ragged_batches():
    from wseg_tpu_torch.parallel.dist import rank_rows

    x = torch.arange(5)
    assert [rank_rows(x, r, 2).tolist() for r in range(2)] == [
        [0, 1], [2, 3, 4]]
    assert [rank_rows([7], r, 2) for r in range(2)] == [[], [7]]
    assert rank_rows(x).tolist() == x.tolist()      # no group: all rows


def test_get_device_maps_local_rank_and_refuses_missing_cards(monkeypatch):
    """Under torchrun ``--device cuda`` is ``cuda:$LOCAL_RANK`` (made the
    current device); a LOCAL_RANK past the cards, or one explicit card
    for several processes, raises instead of falling back."""
    import types

    from wseg_tpu_torch.opts import get_device

    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    args = types.SimpleNamespace(device="cuda")
    monkeypatch.setenv("WORLD_SIZE", "3")
    for r in (0, 1):
        monkeypatch.setenv("RANK", str(r))
        monkeypatch.setenv("LOCAL_RANK", str(r))
        assert get_device(args) == torch.device("cuda", r)
    assert current == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2"):
        get_device(args)
    with pytest.raises(ValueError, match="--device cuda:0 under torchrun"):
        get_device(types.SimpleNamespace(device="cuda:0"))
    monkeypatch.delenv("WORLD_SIZE")
    assert get_device(types.SimpleNamespace(device="cpu")) == \
        torch.device("cpu")
    assert len(current) == 2
