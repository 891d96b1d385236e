"""The port's host tools against the JAX package's: ``python -m
wseg_tpu_torch.eval_seg`` against the root ``eval_seg.py`` and
``python -m wseg_tpu_torch.convert_sbd`` against ``tools/convert_sbd.py``,
the ``ae`` journey through the port's entry points on the CPU:
``train`` -> ``infer_val`` -> ``eval_seg`` on ``configs/voc_resnet50.yaml``
with a small crop, and the VGG16 ``ae`` model served and scored by both
packages' CLIs from one checkpoint."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from tests.synthetic_voc import make_synthetic_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _root_module(rel_path, name):
    """A root script of the repository (``eval_seg.py``,
    ``tools/convert_sbd.py``) as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel_path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _argv(tmp_path, *extra):
    return ["--dataset", "pascal_voc",
            "--cfg", os.path.join(REPO, "configs", "voc_resnet50.yaml"),
            "--exp", "ae", "--run", "r0",
            "--snapshot-dir", str(tmp_path / "snap"),
            "--logdir", str(tmp_path / "logs"), "--workers", "0",
            "--random-seed", "3", "--device", "cpu", *extra]


def _sets(root):
    """``voc_resnet50.yaml`` cut to a CPU run: crop 64, batch 2, one
    epoch with the mask loss on, float32, a 128x128 canvas at two
    scales."""
    return ["--set", "DATASET.ROOT", root, "TEST.DATA_ROOT", root,
            "DATASET.CROP_SIZE", "64", "TRAIN.BATCH_SIZE", "2",
            "TRAIN.NUM_EPOCHS", "0", "TRAIN.PRETRAIN", "0",
            "NET.DTYPE", "float32",
            "NET.PRE_WEIGHTS_PATH", os.path.join(root, "none.pth"),
            "TEST.BATCH_SIZE", "2", "TEST.PAD_SIZE", "[128, 128]",
            "TEST.PAD_ALIGN", "32", "TEST.SCALES", "[1, 0.5]",
            "TEST.USE_GT_LABELS", "False", "TEST.CRF_DTYPE", "float32"]


def _eval_lines(out: str):
    """The table and mIoU lines of an eval_seg run (its first line prints
    the argparse namespace, which names the module)."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("# of"))
    return lines[start:]


def test_ae_journey_train_infer_eval_on_the_cpu(tmp_path, capsys):
    """train -> infer_val -> eval_seg through the port's entry points on
    the ``ae`` ResNet-50 config; the port's eval_seg prints the same table
    and mIoU as the root eval_seg.py on the same PNGs, and writes the same
    score log.  The trained checkpoint carries the decoder's running
    statistics, moved from their init, and ``--resume`` reads them
    back."""
    from wseg_tpu_torch import eval_seg, infer_val, train
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.utils.checkpoints import model_file

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=4, n_val=2)
    trainer = train.main(_argv(tmp_path) + _sets(root))
    out = capsys.readouterr().out
    assert "Epoch[0] Loss [0000]" in out and "Saved checkpoint" in out
    suffix = trainer.checkpoint.checkpoints[-1]
    snap = trainer.args.snapshot_dir
    saved = torch.load(model_file(snap, suffix), weights_only=True)
    assert saved["fc8_skip.1.running_var"].dtype == torch.float32
    assert not torch.equal(saved["fc8_skip.1.running_var"],
                           torch.ones(48))
    assert torch.equal(saved["aspp.bn1.running_var"], torch.ones(256))
    # --resume reads the running statistics back into the trainer's model
    from wseg_tpu_torch.config import cfg_from_file, cfg_from_list
    from wseg_tpu_torch.engine.trainer import DecTrainer
    from wseg_tpu_torch.opts import get_arguments

    reset_cfg()
    args = get_arguments(_argv(tmp_path, "--resume", suffix) + _sets(root))
    cfg_from_file(args.cfg_file)
    cfg_from_list(args.set_cfgs)
    resumed = DecTrainer(args).model.state_dict()
    for name in ("fc8_skip.1.running_var", "last_conv.5.running_mean",
                 "shallow_mask.fc_skip.1.running_var"):
        assert torch.equal(resumed[name], saved[name]), name

    reset_cfg()
    infer_val.main(_argv(tmp_path, "--resume", suffix, "--infer-list",
                         os.path.join(root, "val_voc.txt"),
                         "--mask-output-dir", str(tmp_path / "masks"))
                   + _sets(root))
    assert f"Loaded snapshot {model_file(snap, suffix)}" in \
        capsys.readouterr().out
    masks = str(tmp_path / "masks_0" / "crf")
    assert len(os.listdir(masks)) == 2

    def eval_argv(log):
        return ["--data", root, "--filelist",
                os.path.join(root, "val_voc.txt"), "--masks", masks,
                "--log-scores", str(tmp_path / log)]

    stats = eval_seg.main(eval_argv("port.log"))
    port_out = capsys.readouterr().out
    root_eval = _root_module("eval_seg.py", "root_eval_seg")
    args = root_eval.parser.parse_args(eval_argv("jax.log"))
    want = root_eval.summarise_stats(root_eval.evaluate_all(args))
    jax_out = capsys.readouterr().out
    assert _eval_lines(port_out) == _eval_lines(jax_out)
    assert "# of images: 2" in port_out
    assert np.isfinite(stats["miou"]) and stats["miou"] == want["miou"]
    assert (tmp_path / "port.log").read_text() == \
        (tmp_path / "jax.log").read_text()


def test_eval_seg_oracle_matches_root():
    root_eval = _root_module("eval_seg.py", "root_eval_seg")
    from wseg_tpu_torch.eval_seg import oracle_lower

    rng = np.random.RandomState(0)
    mask = np.zeros((75, 100), np.uint8)
    for cls in (3, 7, 15):
        y, x = rng.randint(0, 50), rng.randint(0, 70)
        mask[y:y + rng.randint(5, 25), x:x + rng.randint(5, 30)] = cls
    mask[:3] = 255
    for h, w in ((10, 13), (32, 41)):
        want = root_eval.oracle_lower(mask, h, w)
        np.testing.assert_array_equal(oracle_lower(mask, h, w), want)
        assert set(np.unique(want)) <= {0, 3, 7, 15}


def test_eval_seg_oracle_without_opencv_raises(monkeypatch):
    from wseg_tpu_torch.eval_seg import oracle_lower

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        oracle_lower(np.ones((8, 8), np.uint8), 4, 4)


def test_convert_sbd_writes_the_same_pngs(tmp_path):
    """SBD-style ``.mat`` files (a ``GTcls`` struct with its
    ``Segmentation``) written by ``scipy.io.savemat``, through both
    converters: the same palette PNGs, pixel for pixel."""
    import scipy.io
    from PIL import Image

    from wseg_tpu_torch import convert_sbd

    src = tmp_path / "cls"
    src.mkdir()
    rng = np.random.RandomState(1)
    for i in range(3):
        seg = rng.randint(0, 21, size=(40 + i, 50)).astype(np.uint8)
        scipy.io.savemat(str(src / f"2008_{i:06d}.mat"), {"GTcls": {
            "Segmentation": seg,
            "CategoriesPresent": np.unique(seg)[1:].astype(np.uint8)}})
    convert_sbd.main(["--sbd-root", str(src), "--out",
                      str(tmp_path / "port")])
    root_tool = _root_module(os.path.join("tools", "convert_sbd.py"),
                             "root_convert_sbd")
    root_tool.main(["--sbd-root", str(src), "--out", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 3 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a = Image.open(tmp_path / "port" / name)
        b = Image.open(tmp_path / "jax" / name)
        assert a.mode == b.mode == "P" and a.getpalette() == b.getpalette()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        mat = scipy.io.loadmat(str(src / name.replace(".png", ".mat")))
        np.testing.assert_array_equal(
            np.asarray(a), mat["GTcls"][0]["Segmentation"][0])


def test_ae_infer_val_and_eval_seg_match_jax(tmp_path, capsys):
    """The VGG16 ``ae`` model (its config's ``BG_POW`` 1) served by both
    packages' ``infer_val`` from one port-saved checkpoint: the same
    indexed PNGs (>= 99% of pixels per map, as the flagship's
    tests/test_torch_infer_val.py: the CRF's tap weights round
    differently); each package's ``eval_seg`` then scores its own PNGs,
    and the mIoU lines agree to the PNGs' agreement (equal where the
    maps are)."""
    import textwrap

    from PIL import Image

    from tests.torch_parity import (
        jax_ae_model_and_random_variables,
        port_ae_model_from_jax,
    )
    from wseg_tpu.config import reset_cfg as reset_jax_cfg
    from wseg_tpu_torch import eval_seg, infer_val
    from wseg_tpu_torch.config import reset_cfg

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=0, n_val=3)
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(textwrap.dedent(f"""\
        NET:
          BACKBONE: "vgg16"
          MODEL: "ae"
          DTYPE: "float32"
        TEST:
          METHOD: "multiscale"
          DATA_ROOT: "{root}"
          FLIP: True
          BATCH_SIZE: 4
          PAD_SIZE: [128, 128]
          PAD_ALIGN: 32
          SCALES: [1, 0.75]
          USE_GT_LABELS: False
          BG_POW: 1
          CRF_DTYPE: "float32"
        """))
    _, variables = jax_ae_model_and_random_variables("vgg16", seed=2,
                                                     size=33)
    ckpt = str(tmp_path / "port.pth")
    torch.save(port_ae_model_from_jax(variables, "vgg16").state_dict(), ckpt)
    reset_jax_cfg()

    def argv(out):
        return ["--cfg", str(cfg_file), "--resume", ckpt,
                "--snapshot-dir", str(tmp_path / "snap"),
                "--logdir", str(tmp_path / "logs"), "--workers", "2",
                "--infer-list", os.path.join(root, "val_voc.txt"),
                "--mask-output-dir", str(tmp_path / out)]

    _root_module("infer_val.py", "root_infer_val").main(argv("jax"))
    reset_cfg()
    infer_val.main(argv("port") + ["--device", "cpu"])
    agree = []
    for sub in ("no_crf", "crf"):
        jdir, pdir = tmp_path / "jax_0" / sub, tmp_path / "port_0" / sub
        names = sorted(os.listdir(jdir))
        assert len(names) == 3 and sorted(os.listdir(pdir)) == names
        for name in names:
            a = np.asarray(Image.open(pdir / name))
            b = np.asarray(Image.open(jdir / name))
            assert a.shape == b.shape == (60, 80)
            agree.append(float((a == b).mean()))
    assert min(agree) >= 0.99, agree
    capsys.readouterr()

    def scores(module, masks, log):
        argv = ["--data", root, "--filelist",
                os.path.join(root, "val_voc.txt"), "--masks", masks,
                "--log-scores", str(tmp_path / log)]
        if module is eval_seg:
            return eval_seg.main(argv)
        return module.summarise_stats(module.evaluate_all(
            module.parser.parse_args(argv)))

    got = scores(eval_seg, str(tmp_path / "port_0" / "crf"), "port.log")
    want = scores(_root_module("eval_seg.py", "root_eval_seg"),
                  str(tmp_path / "jax_0" / "crf"), "jax.log")
    if min(agree) == 1.0:
        assert got["miou"] == want["miou"]
    else:
        assert abs(got["miou"] - want["miou"]) <= 100 * (1 - min(agree))
    assert np.isfinite(got["miou"]) and "mIoU:" in capsys.readouterr().out
