"""``python -m wseg_tpu_torch.train --device cpu`` on a synthetic VOC:
one short epoch (crop 64, batch 2) + validation writes a checkpoint,
and the port's ``infer_val --device cpu --resume <suffix>`` loads it
from the same snapshot directory and serves the validation images."""

import os
import textwrap

import numpy as np
import pytest
import torch

from tests.synthetic_voc import make_synthetic_voc


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    from wseg_tpu_torch.config import reset_cfg
    reset_cfg()
    yield
    reset_cfg()


def _write_cfg(tmp_path, root):
    p = tmp_path / "cfg.yaml"
    p.write_text(textwrap.dedent(f"""\
        DATASET:
          CROP_SIZE: 64
          ROOT: "{root}"
          FILENAME: "train_augvoc"
        TRAIN:
          BATCH_SIZE: 2
          NUM_EPOCHS: 0
          PRETRAIN: 0
        NET:
          BACKBONE: "resnet38"
          MODEL: "CAM_CASA_WGAP_tf"
          DTYPE: "float32"
          PRE_WEIGHTS_PATH: "{root}/no_such_weights.pth"
          LR: 0.001
          WEIGHT_DECAY: 0.0005
        TEST:
          METHOD: "multiscale"
          DATA_ROOT: "{root}"
          BATCH_SIZE: 2
          PAD_SIZE: [128, 128]
          PAD_ALIGN: 32
          SCALES: [1, 0.5]
          CRF_DTYPE: "float32"
        """))
    return str(p)


def _argv(tmp_path, cfg_file, *extra):
    return ["--dataset", "pascal_voc", "--cfg", cfg_file, "--exp", "e1",
            "--run", "r1", "--snapshot-dir", str(tmp_path / "snap"),
            "--logdir", str(tmp_path / "logs"), "--workers", "0",
            "--random-seed", "3", *extra]


def test_train_cli_writes_a_checkpoint_that_infer_val_serves(tmp_path,
                                                             capsys):
    from PIL import Image

    from wseg_tpu_torch import infer_val, train
    from wseg_tpu_torch.config import reset_cfg
    from wseg_tpu_torch.optim import FROZEN
    from wseg_tpu_torch.utils.checkpoints import model_file, parse_suffix

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=4, n_val=2)
    cfg_file = _write_cfg(tmp_path, root)
    trainer = train.main(_argv(tmp_path, cfg_file, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "Epoch[0] Loss [0000]" in out and "mAP:" in out
    assert "Saved checkpoint" in out

    snap = tmp_path / "snap" / "pascal_voc" / "e1" / "r1"
    suffix = out.split("Saved checkpoint")[-1].split()[0]
    assert parse_suffix(suffix)[0] == 0
    saved = torch.load(model_file(str(snap), suffix), weights_only=True)
    assert (snap / f"opt_enc_{suffix}.pth").is_file()
    # the file holds the trainer's parameters; only frozen ones are fixed
    state = trainer.model.state_dict()
    for name, lab in trainer.param_labels.items():
        assert torch.equal(saved[name], state[name].cpu())
    assert all(p.requires_grad == (trainer.param_labels[n] != FROZEN)
               for n, p in trainer.model.named_parameters())
    assert all(torch.isfinite(v).all() for v in saved.values()
               if v.is_floating_point())

    # --resume of the suffix reloads model and optimizer and goes on
    reset_cfg()
    again = train.main(_argv(tmp_path, cfg_file, "--device", "cpu",
                             "--resume", suffix))
    assert f"Resumed from {suffix} (epoch 0)" in capsys.readouterr().out
    assert again.checkpoint.checkpoints[0] == suffix
    assert again.best_score >= parse_suffix(suffix)[1]
    assert again.optimizer.state_dict()["state"]

    reset_cfg()
    infer_val.main(_argv(tmp_path, cfg_file, "--device", "cpu", "--resume",
                         suffix, "--infer-list",
                         os.path.join(root, "val_voc.txt"),
                         "--mask-output-dir", str(tmp_path / "masks")))
    assert f"Loaded snapshot {model_file(str(snap), suffix)}" in \
        capsys.readouterr().out
    pngs = sorted(os.listdir(tmp_path / "masks_0" / "crf"))
    assert len(pngs) == 2
    m = np.asarray(Image.open(tmp_path / "masks_0" / "crf" / pngs[0]))
    assert m.shape == (60, 80) and int(m.max()) <= 20


def test_train_cli_without_a_card_raises(tmp_path):
    """No --device means cuda; without a card the entry point stops
    instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from wseg_tpu_torch import train

    root = make_synthetic_voc(str(tmp_path / "data"), n_train=2, n_val=1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(_argv(tmp_path, _write_cfg(tmp_path, root)))
