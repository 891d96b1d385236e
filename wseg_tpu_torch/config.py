"""Layered configuration with the reference YAML schema.

code defaults <- YAML file <- ``--set KEY VALUE ...`` overrides, with
strict unknown-key rejection and ``literal_eval`` type coercion, so the
shipped ``configs/*.yaml`` run unchanged.  Same schema, defaults and
merge semantics as ``wseg_tpu/config.py``; ``yaml`` is imported only
when a file is merged.
"""

from __future__ import annotations

import copy
from ast import literal_eval


class AttrDict(dict):
    """dict with attribute access; nested dicts become AttrDicts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, AttrDict):
                self[k] = AttrDict(v)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def clone(self) -> "AttrDict":
        out = AttrDict()
        for k, v in self.items():
            out[k] = (v.clone() if isinstance(v, AttrDict)
                      else copy.deepcopy(v))
        return out


def _default_cfg() -> AttrDict:
    """Defaults key-for-key as ``wseg_tpu/config.py`` (whose comments
    document the device extensions)."""
    c = AttrDict()
    c.NUM_GPUS = 1

    c.TRAIN = AttrDict()
    c.TRAIN.BATCH_SIZE = 20
    c.TRAIN.NUM_EPOCHS = 15
    c.TRAIN.NUM_WORKERS = 4
    c.TRAIN.MASK_LOSS = 0.0
    c.TRAIN.PRETRAIN = 5

    c.TEST = AttrDict()
    c.TEST.METHOD = "multiscale"
    c.TEST.DATA_ROOT = "/data/your_directory"
    c.TEST.SCALES = [1, 0.5, 1.5, 2.0]
    c.TEST.FLIP = False
    c.TEST.PAD_SIZE = [1024, 1024]
    c.TEST.CROP_SIZE = [448, 448]
    c.TEST.CROP_GRID_SIZE = [2, 2]
    c.TEST.BATCH_SIZE = 4
    c.TEST.BG_POW = 3
    c.TEST.NUM_CLASSES = 21
    c.TEST.USE_GT_LABELS = False
    c.TEST.FP_CUT_SCORE = 0.1
    c.TEST.PAD_PER_SCALE = True
    c.TEST.DEVICE_MERGE = True
    c.TEST.PAD_ALIGN = 64
    c.TEST.UINT8_TRANSFER = True
    c.TEST.DEVICE_VIEWS = True
    c.TEST.CRF_MODE = "fast"
    c.TEST.CRF_DTYPE = "bfloat16"
    c.TEST.CRF_STRIDE = 2
    c.TEST.CRF_FULL_STRIDE = 2
    c.TEST.CRF_REFINE_ITERS = 1
    c.TEST.CRF_TAP_DIV = 2.0

    c.DATASET = AttrDict()
    c.DATASET.CROP_SIZE = 321
    c.DATASET.SCALE_FROM = 0.9
    c.DATASET.SCALE_TO = 1.0
    c.DATASET.PATH = "data/images"
    c.DATASET.ROOT = ""
    c.DATASET.NAME = ""
    c.DATASET.FILENAME = ""
    c.DATASET.DEVICE_JITTER = True

    c.NET = AttrDict()
    c.NET.MODEL = "vgg16"
    c.NET.BACKBONE = "resnet50"
    c.NET.PRE_WEIGHTS_PATH = ""
    c.NET.OPT = "SGD"
    c.NET.LR = 0.001
    c.NET.GRAD_CLIP = 0.0
    c.NET.BETA1 = 0.5
    c.NET.MOMENTUM = 0.9
    c.NET.WEIGHT_DECAY = 1e-5
    c.NET.LOSS = "SoftMargin"
    c.NET.MASK_LOSS_BCE = 1.0
    c.NET.BG_SCORE = 0.1
    c.NET.FOCAL_P = 3
    c.NET.FOCAL_LAMBDA = 0.01
    c.NET.PAMR_KERNEL = [1, 2, 4, 8, 12, 24]
    c.NET.PAMR_ITER = 10
    c.NET.SG_PSI = 0.3
    c.NET.DTYPE = "bfloat16"
    c.NET.QUANT_ACT = "dynamic"
    c.NET.QUANT_STATS = ""
    c.NET.PAMR_IMPL = "auto"

    c.MASKS = AttrDict()
    c.MASKS.CRF = AttrDict()
    c.MASKS.CRF.ALPHA_LOW = 4
    c.MASKS.CRF.ALPHA_HIGH = 32

    c.CUDA = False
    c.DEBUG = False
    c.PYTORCH_VERSION_LESS_THAN_040 = False
    return c


cfg = _default_cfg()


def reset_cfg() -> None:
    """Restore code defaults in place."""
    cfg.clear()
    cfg.update(_default_cfg())


def _decode_value(v):
    if isinstance(v, dict):
        return AttrDict(v)
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(value_new, value_old, full_key):
    if type(value_new) is type(value_old):
        return value_new
    if isinstance(value_old, str):
        return str(value_new)
    if isinstance(value_new, tuple) and isinstance(value_old, list):
        return list(value_new)
    if isinstance(value_new, list) and isinstance(value_old, tuple):
        return tuple(value_new)
    if isinstance(value_old, float) and isinstance(value_new, int):
        return float(value_new)
    if isinstance(value_old, (bool,)) and isinstance(value_new, int):
        return bool(value_new)
    raise ValueError(
        "Type mismatch ({} vs. {}) for config key: {}".format(
            type(value_old), type(value_new), full_key))


def _merge_into(a: AttrDict, b: AttrDict, stack=None) -> None:
    for k, v_raw in a.items():
        full_key = ".".join((stack or []) + [k])
        if k not in b:
            raise KeyError("Non-existent config key: {}".format(full_key))
        v = _decode_value(copy.deepcopy(v_raw))
        if isinstance(v, AttrDict):
            _merge_into(v, b[k], (stack or []) + [k])
        else:
            b[k] = _coerce(v, b[k], full_key)


def merge_cfg_from_file(cfg_filename: str) -> None:
    import yaml

    with open(cfg_filename, "r") as f:
        yaml_cfg = AttrDict(yaml.safe_load(f))
    _merge_into(yaml_cfg, cfg)


def merge_cfg_from_list(cfg_list) -> None:
    """Merge ``--set K V K V ...`` pairs into the global config."""
    if len(cfg_list) % 2 != 0:
        raise ValueError("--set expects KEY VALUE pairs")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        d = cfg
        key_list = full_key.split(".")
        for subkey in key_list[:-1]:
            if subkey not in d:
                raise KeyError("Non-existent key: {}".format(full_key))
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d:
            raise KeyError("Non-existent key: {}".format(full_key))
        d[subkey] = _coerce(_decode_value(v), d[subkey], full_key)


cfg_from_file = merge_cfg_from_file
cfg_from_list = merge_cfg_from_list
