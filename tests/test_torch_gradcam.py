"""The port's Grad-CAM suite, writers and CAM entry points against the
JAX package (float32, CPU, the same numpy-seeded weights and images).

* Each of the ten CAM methods on ``bsl`` (VGG16, 48x48, an input whose
  ReLU inputs all keep clear of 0, see ``IMG_SEED``): the port's map
  against ``wseg_tpu.gradcam``'s within 1e-4 (maps lie in [0, 1]);
  guided backprop's raw input gradient within 1e-4 of its largest
  value.  EigenCAM and EigenGradCAM project on the first right-singular
  vector, whose sign each LAPACK build picks: their maps are held to
  JAX's map or to JAX's map with the vector negated.  Also GradCAM with
  ``eigen_smooth``, ``aug_smooth``, and several taps (``ae``, whose
  head reads conv3 and conv6).
* ``StageNet.backbone_taps`` and ``forward(..., taps=)`` against JAX's
  on the classic CAM, ``ae``, nGWP softmax and multi-level paths.
* FullGrad's bias sites: their number, and the multiset of (NHWC
  output shape, bias sum), equal JAX's on four heads and backbones.
* The guided ReLU: its gradient against JAX's ``custom_vjp``; the ReLUs
  it replaces are exactly those ``wseg_tpu`` routes through its
  ``relu`` (as many calls, per model); with the mode off ``relu`` adds
  no ``autograd.Function`` node.
* ``ResultWriter.save`` (threshold, CRF hook, heatmap, scoremap) and
  ``PAMRWriter``: the same files as JAX's; the ``hot`` and ``jet``
  tables equal matplotlib's colormaps.
* ``python -m wseg_tpu_torch.infer_cam --device cpu`` and ``cam`` against
  the root ``infer_cam.py`` and ``cam.py`` on one checkpoint (a JAX
  msgpack and a port ``.pth`` of the same weights).
"""

import contextlib
import importlib.util
import os
import re
import shutil
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 48
MAP_TOL = 1e-4
# the methods' input: every biased conv output (a ReLU input) of the
# bsl model keeps > 5e-6 from 0 on it (checked), ~10x the float32
# noise of those activations; a ReLU input within that noise of 0
# flips its mask between the packages and moves a backpropagated
# gradient by far more than MAP_TOL (seen: 0.7% of FullGrad's input
# gradient from one of 36,864 fc6 outputs at 6e-7)
IMG_SEED = 14
EIGEN = ("eigencam", "eigengradcam")


@pytest.fixture(autouse=True)
def _reset_cfgs():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


@pytest.fixture(scope="module")
def bsl():
    """(JAX model, variables, port serving model) of ``bsl`` on VGG16."""
    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )

    jm, variables = jax_zoo_model_and_random_variables("bsl", "vgg16",
                                                       size=SIZE)
    return jm, variables, port_zoo_model_from_jax(variables, "bsl", "vgg16")


def _image(seed=0, b=1, size=SIZE):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(
        np.float32)


@contextlib.contextmanager
def _negated_svd():
    """``wseg_tpu``'s SVD projection with the other sign of the vector."""
    from wseg_tpu.gradcam import cam_methods

    orig = cam_methods._svd_projection
    cam_methods._svd_projection = lambda a: -orig(a)
    try:
        yield
    finally:
        cam_methods._svd_projection = orig


def _jax_map(jm, variables, method, x, target, eigen=False, **kw):
    from wseg_tpu.gradcam import get_cam_method as jax_method

    return np.asarray(jax_method(method)(jm, variables, **kw)(
        x, target, eigen_smooth=eigen))


def _relu_margin(model, x) -> float:
    """Smallest |output| of the model's biased convs on ``x``."""
    mins = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: mins.append(float(out.abs().min())))
        for m in model.modules()
        if isinstance(m, torch.nn.Conv2d) and m.bias is not None]
    try:
        with torch.no_grad():
            model(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return min(mins)


def _check_up_to_sign(ours, jm, variables, method, x, target, **kw):
    want = _jax_map(jm, variables, method, x, target, **kw)
    err = float(np.abs(ours - want).max())
    if err > MAP_TOL:
        with _negated_svd():
            want = _jax_map(jm, variables, method, x, target, **kw)
        err = float(np.abs(ours - want).max())
    assert err <= MAP_TOL, (method, err)


@pytest.mark.parametrize("method", [
    "gradcam", "gradcam++", "xgradcam", "layercam", "eigencam",
    "eigengradcam", "scorecam", "ablationcam", "fullgrad",
    "guidedbackprop"])
def test_cam_method_matches_jax(method, bsl):
    from wseg_tpu_torch.gradcam import get_cam_method

    jm, variables, model = bsl
    x = _image(IMG_SEED)
    assert _relu_margin(model, x) > 5e-6
    ours = get_cam_method(method)(model)(x, 3)
    if method in EIGEN:
        assert ours.shape == (1, SIZE, SIZE)
        _check_up_to_sign(ours, jm, variables, method, x, 3)
        return
    want = _jax_map(jm, variables, method, x, 3)
    assert ours.shape == want.shape
    scale = float(np.abs(want).max()) if method == "guidedbackprop" else 1.0
    err = float(np.abs(ours - want).max())
    assert err <= MAP_TOL * scale, (method, err, scale)
    if method != "guidedbackprop":
        assert ours.min() >= 0.0 and ours.max() <= 1.0 + 1e-6


def test_gradcam_eigen_smooth_and_aug_smooth_match_jax(bsl):
    from wseg_tpu.gradcam import aug_smooth as jax_aug_smooth
    from wseg_tpu.gradcam import get_cam_method as jax_method
    from wseg_tpu_torch.gradcam import GradCAM, aug_smooth

    jm, variables, model = bsl
    x = _image(2)
    ours = GradCAM(model)(x, 5, eigen_smooth=True)
    _check_up_to_sign(ours, jm, variables, "gradcam", x, 5, eigen=True)
    ours = aug_smooth(GradCAM(model), x, 5)
    want = jax_aug_smooth(jax_method("gradcam")(jm, variables), x, 5)
    assert float(np.abs(ours - want).max()) <= MAP_TOL


def test_multi_tap_gradcam_matches_jax():
    """``ae`` reads conv3 and conv6: the two taps' mean map differs from
    the conv6 map, on both sides alike."""
    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )
    from wseg_tpu.gradcam import GradCAM as JaxGradCAM
    from wseg_tpu_torch.gradcam import GradCAM

    jm, variables = jax_zoo_model_and_random_variables("ae", "vgg16",
                                                       size=SIZE)
    model = port_zoo_model_from_jax(variables, "ae", "vgg16")
    x = _image(3)
    taps = ("conv3", "conv6")
    ours = GradCAM(model, tap=taps)(x, 2)
    want = np.asarray(JaxGradCAM(jm, variables, tap=taps)(x, 2))
    assert float(np.abs(ours - want).max()) <= MAP_TOL
    single = GradCAM(model, tap="conv6")(x, 2)
    assert float(np.abs(ours - single).max()) > 1e-2


@pytest.mark.parametrize("name,backbone", [
    ("bsl", "vgg16"), ("ae", "vgg16"), ("CAM_CASA_WGAP_tf", "resnet50"),
    ("CAM_MF", "resnet38")])
def test_forward_with_taps_matches_jax(name, backbone):
    """``backbone_taps`` and ``forward(..., taps=)`` on each scoring path
    (classic CAM, ``ae``'s decoder, nGWP softmax, multi-level): the taps
    equal JAX's; all of them given back (the backbone skipped) reproduce
    the forward; conv6 replaced (half of it; the backbone run for the
    other taps) gives JAX's ``cls`` and masks (rel 1e-4)."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )
    from tests.torch_zoo import check

    size = 32
    jm, variables = jax_zoo_model_and_random_variables(name, backbone,
                                                       size=size)
    model = port_zoo_model_from_jax(variables, name, backbone)
    x = _image(7, size=size)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    jtaps = jax.jit(lambda v, i: jm.apply(v, i, method="backbone_taps"))(
        variables, xj)
    with torch.no_grad():
        taps = model.backbone_taps(xt)
        assert set(taps) == set(jtaps)
        for k, v in jtaps.items():
            check(taps[k], v, k)
        plain = model(xt)
        again = model(xt, taps=taps)
        assert torch.equal(again.cls, plain.cls)
        half = model(xt, taps={"conv6": 0.5 * taps["conv6"]})
    want = jax.jit(lambda v, i, t: jm.apply(v, i, taps={"conv6": t},
                                            train=False))(
        variables, xj, 0.5 * jtaps["conv6"])
    check(half.cls, want.cls, "cls")
    check(half.masks, want.masks, "masks")
    assert float((half.cls - plain.cls).abs().max()) > 1e-3


@pytest.mark.parametrize("name,backbone", [
    ("bsl", "vgg16"), ("ae", "vgg16"), ("CAM_CASA_WGAP_tf", "resnet38"),
    ("CAM_CASA_WGAP_tf_v2", "resnet50")])
def test_fullgrad_sites_match_jax(name, backbone):
    import jax.numpy as jnp

    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )
    from wseg_tpu.gradcam.fullgrad import FullGrad as JaxFullGrad
    from wseg_tpu_torch.gradcam.fullgrad import FullGrad

    jm, variables = jax_zoo_model_and_random_variables(name, backbone,
                                                       size=SIZE)
    sites = JaxFullGrad(jm, variables)._discover_sites(
        jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    want = sorted((tuple(shape), round(float(np.sum(b)), 3))
                  for shape, b in sites.values())
    model = port_zoo_model_from_jax(variables, name, backbone)
    _, found = FullGrad(model).site_gradients(
        torch.from_numpy(_image(4)), 1)
    got = sorted(((g.shape[0], g.shape[2], g.shape[3], g.shape[1]),
                  round(float(m.bias.sum()), 3)) for m, g in found)
    assert len(got) == len(want) > 0
    assert got == want


def test_guided_relu_gradient_matches_jax():
    import jax
    import jax.numpy as jnp

    from wseg_tpu.ops.activations import _guided_relu
    from wseg_tpu_torch.ops.activations import guided_mode, relu

    rng = np.random.RandomState(5)
    x = rng.randn(4, 7, 6, 3).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(_guided_relu, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    with guided_mode():
        y = relu(xt)
    assert type(y.grad_fn).__name__ == "GuidedReLUBackward"
    np.testing.assert_array_equal(y.detach().numpy(), np.maximum(x, 0))
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    # the mode off: F.relu itself, no custom autograd node
    y = relu(torch.from_numpy(x).requires_grad_(True))
    assert type(y.grad_fn).__name__ == "ReluBackward0"


@pytest.mark.parametrize("name,backbone,train", [
    ("bsl", "vgg16", False), ("ae", "resnet50", False),
    ("CAM_CASA_WGAP_tf", "resnet38", False), ("CAM_MF", "resnet38", False),
    ("CAM_CASA_WGAP_PCM", "resnet38", True)])
def test_guided_relus_are_jaxs(name, backbone, train, monkeypatch):
    """Inside the guided mode the port calls the guided ReLU as often as
    ``wseg_tpu`` calls its own (a trace of the same forward); outside it,
    never."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )
    from wseg_tpu.ops import activations as jax_act
    from wseg_tpu_torch.ops.activations import GuidedReLU, guided_mode

    size = 32
    jm, variables = jax_zoo_model_and_random_variables(name, backbone,
                                                       size=size)
    x = _image(6, size=size)
    labels = np.zeros((1, 20), np.float32)
    labels[0, 4] = 1.0
    raw = np.clip(x * 0.2 + 0.5, 0, 1)
    args = (x, raw, labels) if train else (x,)

    n_jax = []
    orig = jax_act._guided_relu
    monkeypatch.setattr(jax_act, "_guided_relu",
                        lambda v: n_jax.append(1) or orig(v))
    with jax_act.guided_mode():
        jax.eval_shape(lambda *a: jm.apply(variables, *a, train=False),
                       *[jnp.asarray(a) for a in args])

    n_port = []
    fwd = GuidedReLU.forward
    monkeypatch.setattr(GuidedReLU, "forward", staticmethod(
        lambda ctx, v: n_port.append(1) or fwd(ctx, v)))
    model = port_zoo_model_from_jax(variables, name, backbone)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        model(*targs)
        assert not n_port
        with guided_mode():
            model(*targs)
    assert len(n_port) == len(n_jax) > 0


def _writer_inputs(seed=7, h=30, w=40, c=21):
    rng = np.random.RandomState(seed)
    scores = rng.rand(h, w, c).astype(np.float32)
    scores[..., 5:] *= 0.5
    image01 = rng.rand(h, w, 3).astype(np.float32)
    gt = rng.randint(0, c, size=(h, w)).astype(np.int32)
    return scores, image01, gt


def _crf(img255, scores):
    """A stand-in CRF: any deterministic (H, W, C) map of the inputs."""
    return scores * (0.5 + img255[..., :1].astype(np.float32) / 510.0)


def _read_tree(root):
    from PIL import Image

    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            key = os.path.relpath(p, root)
            out[key] = (np.load(p) if f.endswith(".npy")
                        else np.asarray(Image.open(p)))
    return out


def test_result_writer_save_matches_jax(tmp_path):
    from wseg_tpu.engine.writers import ResultWriter as JaxWriter
    from wseg_tpu_torch.engine.writers import ResultWriter

    scores, image01, gt = _writer_inputs()
    kw = dict(prospect_thresh=0.3, heatmap=True, scoremap=True,
              use_crf=True, crf_fn=_crf)
    JaxWriter(None, str(tmp_path / "jax"), **kw).save(
        "a/im01.jpg", image01, scores, gt)
    ResultWriter(str(tmp_path / "port"), **kw).save(
        "a/im01.jpg", image01, scores, gt)
    JaxWriter(None, str(tmp_path / "jax"), prospect_thresh=0.0).save(
        "im02.png", image01, scores)
    ResultWriter(str(tmp_path / "port"), prospect_thresh=0.0).save(
        "im02.png", image01, scores)
    want, got = _read_tree(tmp_path / "jax"), _read_tree(tmp_path / "port")
    assert sorted(got) == sorted(want) == sorted([
        "no_crf/im01.png", "crf/im01.png", "vis/im01.png",
        "heatmap/im01.png", "scoremap/im01.npy", "no_crf/im02.png"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_pamr_writer_matches_jax(tmp_path):
    from wseg_tpu.engine.writers import PAMRWriter as JaxPAMRWriter
    from wseg_tpu_torch.engine.writers import PAMRWriter

    scores, image01, gt = _writer_inputs(8)
    snaps = [scores, scores ** 2, np.zeros_like(scores)]
    JaxPAMRWriter(str(tmp_path / "jax")).save_image(
        "x/im03.jpg", image01, snaps, gt)
    PAMRWriter(str(tmp_path / "port")).save_image(
        "x/im03.jpg", image01, snaps, gt)
    want, got = _read_tree(tmp_path / "jax"), _read_tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(want) == 4
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["hot", "jet"])
def test_colormap_tables_match_matplotlib(name):
    cm = pytest.importorskip("matplotlib.cm")
    from wseg_tpu_torch.engine.writers import colormap

    rng = np.random.RandomState(9)
    for dtype in (np.float32, np.float64):
        x = np.concatenate([rng.rand(20000), np.linspace(0, 1, 1001),
                            [-0.5, 1.5, np.nan]]).astype(dtype)
        np.testing.assert_array_equal(colormap(name, x),
                                      getattr(cm, name)(x)[..., :3])


def _load_root_cli(name):
    spec = importlib.util.spec_from_file_location(
        "root_" + name[:-3], os.path.join(REPO, name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cli_setup(tmp_path, n_val=2):
    """A synthetic VOC, a config of ``bsl`` on VGG16 and one checkpoint
    as a JAX msgpack and a port ``.pth`` under the run's snapshot
    directory; returns (root, cfg file, common argv)."""
    import flax.serialization

    from tests.synthetic_voc import make_synthetic_voc
    from tests.torch_parity import (
        jax_zoo_model_and_random_variables,
        port_zoo_model_from_jax,
    )

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0,
                              n_val=n_val)
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(textwrap.dedent(f"""\
        NET:
          BACKBONE: "vgg16"
          MODEL: "bsl"
          DTYPE: "float32"
        TEST:
          DATA_ROOT: "{root}"
        """))
    suffix = "e001Xs0.500"
    run_dir = tmp_path / "snap" / "pascal_voc" / "e" / "r"
    run_dir.mkdir(parents=True)
    _, variables = jax_zoo_model_and_random_variables("bsl", "vgg16",
                                                      seed=4, size=SIZE)
    (run_dir / f"model_enc_{suffix}.msgpack").write_bytes(
        flax.serialization.to_bytes(variables["params"]))
    torch.save(port_zoo_model_from_jax(variables, "bsl", "vgg16")
               .state_dict(), str(run_dir / f"model_enc_{suffix}.pth"))
    argv = ["--dataset", "pascal_voc", "--cfg", str(cfg_file),
            "--exp", "e", "--run", "r", "--resume", suffix,
            "--snapshot-dir", str(tmp_path / "snap"),
            "--logdir", str(tmp_path / "logs")]
    return root, argv


@pytest.mark.parametrize("method", ["gradcam", "guidedbackprop"])
def test_infer_cam_cli_matches_jax(method, tmp_path, capsys):
    """The same PNGs from both CLIs (every pixel: the labels' maps agree
    to 1e-4 and the argmax margins are wider), two images at their own
    500x375-like sizes, padded to a multiple of 64."""
    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch import infer_cam
    from wseg_tpu_torch.config import reset_cfg

    root, argv = _cli_setup(tmp_path)

    def cli_argv(out):
        return argv + ["--infer-list", os.path.join(root, "val_voc.txt"),
                       "--mask-output-dir", str(tmp_path / out),
                       "--method", method]

    reset_jax_cfg()
    _load_root_cli("infer_cam.py").main(cli_argv("jax"))
    reset_cfg()
    infer_cam.main(cli_argv("port") + ["--device", "cpu"])
    want, got = _read_tree(tmp_path / "jax"), _read_tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([k for k in want if k.startswith("no_crf")]) == 2
    for k, v in want.items():
        assert (got[k] == v).mean() >= 0.999, k
    assert "Loaded snapshot" in capsys.readouterr().out
    shutil.rmtree(tmp_path / "snap")    # the two checkpoints, ~0.2 GB


def test_cam_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Both demos pick the same argmax class and write the three JPEGs;
    the decoded images agree to within JPEG rounding."""
    from PIL import Image

    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch import cam
    from wseg_tpu_torch.config import reset_cfg

    root, argv = _cli_setup(tmp_path, n_val=1)
    img = os.path.join(root, "JPEGImages", "im0000.jpg")
    out = {}
    for tag in ("jax", "port"):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        if tag == "jax":
            reset_jax_cfg()
            _load_root_cli("cam.py").main(argv + ["--image-path", img])
        else:
            reset_cfg()
            cam.main(argv + ["--image-path", img, "--device", "cpu"])
        text = capsys.readouterr().out
        out[tag] = (re.findall(r"Predicted target category: (\d+)", text),
                    {f: np.asarray(Image.open(d / f), np.float32)
                     for f in os.listdir(d)})
    (t_jax, f_jax), (t_port, f_port) = out["jax"], out["port"]
    assert t_jax == t_port and len(t_jax) == 1
    assert sorted(f_jax) == sorted(f_port) == [
        "gradcam_cam.jpg", "gradcam_cam_gb.jpg", "gradcam_gb.jpg"]
    for f, v in f_jax.items():
        assert float(np.abs(f_port[f] - v).mean()) <= 0.5, f
    shutil.rmtree(tmp_path / "snap")
