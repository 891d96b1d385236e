"""The flagship setup shared by ``chip_smoke.py``, ``profile_slice`` and
``profile_train``: the configuration (``configs/voc_resnet38.yaml``;
and the ``ae`` configurations ``configs/voc_{resnet50,resnet101,
vgg16}.yaml``, each with ``--set`` overrides for machines without
pyyaml),
a seeded random-weight WRN38 + CAM_CASA_WGAP_tf on the card behind a
``MultiScaleServer`` with the device postprocess, synthetic VOC-sized
images, seeded synthetic training batches, a synthetic VOC directory
on disk, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CFG = os.path.join(REPO, "configs", "voc_resnet38.yaml")
THRESHS = (0.0, 0.1)
# ``--set`` overrides equal to configs/voc_resnet38.yaml, for machines
# without pyyaml (tests/test_torch_serving.py checks the equality)
FLAGSHIP_SET = [
    "NUM_GPUS", "1",
    "DATASET.CROP_SIZE", "384", "DATASET.SCALE_FROM", "0.9",
    "DATASET.SCALE_TO", "1.0", "DATASET.ROOT", "./data",
    "DATASET.NAME", "sbd", "DATASET.FILENAME", "train_augvoc",
    "TRAIN.BATCH_SIZE", "8", "TRAIN.NUM_EPOCHS", "25",
    "TRAIN.NUM_WORKERS", "8", "TRAIN.PRETRAIN", "5",
    "NET.BACKBONE", "resnet38", "NET.MODEL", "CAM_CASA_WGAP_tf",
    "NET.PRE_WEIGHTS_PATH",
    "./weights/ilsvrc-cls_rna-a1_cls1000_ep-0001.pth",
    "NET.LR", "0.001", "NET.OPT", "SGD", "NET.LOSS", "SoftMargin",
    "NET.WEIGHT_DECAY", "0.0005", "NET.PAMR_ITER", "10",
    "NET.FOCAL_LAMBDA", "0.01", "NET.FOCAL_P", "3", "NET.SG_PSI", "0.3",
    "TEST.METHOD", "multiscale", "TEST.DATA_ROOT", "./data",
    "TEST.FLIP", "True", "TEST.BATCH_SIZE", "8",
    "TEST.PAD_SIZE", "[1024, 1024]", "TEST.SCALES", "[1, 0.5, 1.5, 2.0]",
    "TEST.FP_CUT_SCORE", "0.1", "TEST.BG_POW", "3",
    "TEST.USE_GT_LABELS", "True",
]



def _ae_set(backbone: str, batch: int, epochs: int, weights: str, lr: str,
            extra_test=()):
    """``--set`` overrides equal to one of the SoftMaxAE configs."""
    return [
        "NUM_GPUS", "1",
        "DATASET.CROP_SIZE", "321", "DATASET.SCALE_FROM", "0.9",
        "DATASET.SCALE_TO", "1.0", "DATASET.ROOT", "./data",
        "DATASET.NAME", "sbd", "DATASET.FILENAME", "train_augvoc",
        "TRAIN.BATCH_SIZE", str(batch), "TRAIN.NUM_EPOCHS", str(epochs),
        "TRAIN.NUM_WORKERS", "8", "TRAIN.PRETRAIN", "5",
        "NET.BACKBONE", backbone, "NET.MODEL", "ae",
        "NET.PRE_WEIGHTS_PATH", weights, "NET.LR", lr, "NET.OPT", "SGD",
        "NET.LOSS", "SoftMargin", "NET.WEIGHT_DECAY", "0.0005",
        "TEST.METHOD", "multiscale", "TEST.DATA_ROOT", "./data",
        "TEST.FLIP", "True", "TEST.BATCH_SIZE", "8",
        "TEST.PAD_SIZE", "[768, 768]", "TEST.SCALES", "[1, 0.75, 1.25, 1.5]",
        "TEST.FP_CUT_SCORE", "0.3", *extra_test,
        "TEST.USE_GT_LABELS", "True",
    ]


# configs/<name> -> its ``--set`` overrides (tests/test_torch_serving.py
# and tests/test_torch_ae.py check each against its YAML)
CONFIG_SETS = {
    "voc_resnet38.yaml": FLAGSHIP_SET,
    "voc_resnet50.yaml": _ae_set(
        "resnet50", 16, 20, "./weights/resnet50-19c8e357.pth", "0.0005"),
    "voc_resnet101.yaml": _ae_set(
        "resnet101", 16, 20, "./weights/resnet101-5d3b4d8f.pth", "0.0005"),
    "voc_vgg16.yaml": _ae_set("vgg16", 8, 32, "./weights/vgg16_20M.pth",
                              "0.001", ("TEST.BG_POW", "1")),
}


def load_cfg(name: str) -> str:
    """Merge ``configs/<name>`` into the port's cfg (or, without pyyaml,
    its ``CONFIG_SETS`` list); returns where the settings came from."""
    from wseg_tpu_torch.config import cfg_from_file, cfg_from_list

    if importlib.util.find_spec("yaml") is not None:
        cfg_from_file(os.path.join(REPO, "configs", name))
        return f"configs/{name}"
    cfg_from_list(CONFIG_SETS[name])
    return f"--set overrides equal to configs/{name} (no pyyaml)"


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build_flagship_server(device="cuda", seed: int = 0):
    """Seeded random-weight model of the loaded config (its
    ``NET.MODEL`` on its backbone) on ``device``, wrapped in a
    ``MultiScaleServer`` (``MultiCropServer`` under ``TEST.METHOD
    multicrop``) with the device postprocess of ``TEST.CRF_MODE`` (as
    ``infer_val`` builds it).  Reads the port's global cfg."""
    from wseg_tpu_torch.config import cfg
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving import MultiScaleServer
    from wseg_tpu_torch.engine.serving_crop import MultiCropServer
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import (
        seeded_init_,
        stabilize_scratch_init,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model = get_model(cfg.NET, num_classes=int(cfg.TEST.NUM_CLASSES))
    seeded_init_(model, torch.Generator(device=device).manual_seed(seed))
    stabilize_scratch_init(model, 0.1)
    multiscale = str(cfg.TEST.METHOD) == "multiscale"
    pp = make_device_postprocess(
        THRESHS, THRESHS, crf_iters=10,
        # the multicrop merge applies no BG_POW
        bg_pow=float(cfg.TEST.BG_POW) if multiscale else 1.0,
        crf_dtype=str(cfg.TEST.CRF_DTYPE),
        crf_stride=int(cfg.TEST.CRF_STRIDE),
        crf_tap_div=float(cfg.TEST.CRF_TAP_DIV),
        crf_full_stride=int(cfg.TEST.CRF_FULL_STRIDE),
        crf_refine_iters=int(cfg.TEST.CRF_REFINE_ITERS),
        crf_mode=str(cfg.TEST.CRF_MODE))
    return (MultiScaleServer if multiscale else MultiCropServer)(
        model, cfg.TEST, max_batch=int(cfg.TEST.BATCH_SIZE), postprocess=pp)


def synthetic_images(sizes, seed: int = 0):
    """Smooth random photos (blocky colour fields plus noise) of the
    given (width, height) sizes, with 1-3 random GT classes each."""
    rng = np.random.RandomState(seed)
    out = []
    for (w, h) in sizes:
        low = rng.rand(h // 25 + 1, w // 25 + 1, 3) * 255.0
        img = np.repeat(np.repeat(low, 25, 0), 25, 1)[:h, :w]
        img = np.clip(img + rng.randn(h, w, 3) * 8.0, 0, 255)
        labels = np.zeros(20, np.float32)
        labels[rng.choice(20, size=rng.randint(1, 4), replace=False)] = 1
        out.append((img.astype(np.uint8), labels))
    return out


def synthetic_train_batch(rng: np.random.RandomState, batch: int,
                          crop: int):
    """One training batch as the loader delivers it under
    ``DATASET.DEVICE_JITTER``: uint8 crops (blocky colour fields plus
    noise), 1-3 labels per image, jitter parameters; on the card."""
    from wseg_tpu_torch.ops.jitter import sample_colour_jitter

    images, labels, jitter = [], [], []
    for _ in range(batch):
        low = rng.rand(crop // 32 + 1, crop // 32 + 1, 3) * 255.0
        img = np.repeat(np.repeat(low, 32, 0), 32, 1)[:crop, :crop]
        img = np.clip(img + rng.randn(crop, crop, 3) * 8.0, 0, 255)
        images.append(img.astype(np.uint8))
        lab = np.zeros(20, np.float32)
        lab[rng.choice(20, size=rng.randint(1, 4), replace=False)] = 1
        labels.append(lab)
        jitter.append(sample_colour_jitter(rng, p=1.0))
    return {"image": torch.from_numpy(np.stack(images)).cuda(),
            "labels": torch.from_numpy(np.stack(labels)).cuda(),
            "jitter": torch.from_numpy(np.stack(jitter)).cuda()}


def write_synthetic_voc(root: str, n_train: int, n_val: int) -> str:
    """JPEGImages/, SegmentationClass/ and the ``train_augvoc.txt`` /
    ``val_voc.txt`` filelists under ``root``: 500x375 images, each a
    noisy background with 1-2 rectangles whose GT mask carries their
    class."""
    from PIL import Image

    from wseg_tpu_torch.data.pascal_voc import get_palette

    rng = np.random.RandomState(0)
    for sub in ("JPEGImages", "SegmentationClass"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    palette = get_palette()
    w, h = 500, 375
    lines = []
    for i in range(n_train + n_val):
        img = np.clip(rng.randn(h, w, 3) * 20 + 128, 0, 255).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        for _ in range(rng.randint(1, 3)):
            cls = rng.randint(1, 21)
            x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
            x1 = x0 + rng.randint(w // 4, w // 2)
            y1 = y0 + rng.randint(h // 4, h // 2)
            img[y0:y1, x0:x1] = palette[3 * cls:3 * cls + 3]
            mask[y0:y1, x0:x1] = cls
        name = f"syn{i:04d}"
        Image.fromarray(img).save(os.path.join(root, "JPEGImages",
                                               name + ".jpg"))
        m = Image.fromarray(mask, mode="P")
        m.putpalette(palette)
        m.save(os.path.join(root, "SegmentationClass", name + ".png"))
        lines.append(f"/JPEGImages/{name}.jpg /SegmentationClass/{name}.png\n")
    with open(os.path.join(root, "train_augvoc.txt"), "w") as f:
        f.writelines(lines[:n_train])
    with open(os.path.join(root, "val_voc.txt"), "w") as f:
        f.writelines(lines[n_train:])
    return root
