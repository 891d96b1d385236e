"""CLI argument parsing: the same flags as ``wseg_tpu/opts.py``, plus
``--device`` (default ``cuda``): every entry point of the port runs on
that device and never picks another one itself."""

from __future__ import annotations

import argparse
import os
from typing import Sequence


def str2bool(value) -> bool:
    """Parse explicit booleans so ``--isattention False`` works."""
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("1", "true", "t", "yes", "y", "on"):
        return True
    if v in ("0", "false", "f", "no", "n", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"Expected a boolean, got {value!r}")


def add_global_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("--start_epoch", type=int, default=0, metavar="N")
    parser.add_argument("--dataset", type=str, default="pascal_voc",
                        help="Dataset name (pascal_voc)")
    parser.add_argument("--exp", type=str, default="main",
                        help="ID of the experiment (multiple runs)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Snapshot to load")
    parser.add_argument("--run", type=str, default="run0",
                        help="ID of the run")
    parser.add_argument("--workers", type=int, default=8, metavar="N")
    parser.add_argument("--snapshot-dir", type=str, default="./snapshots")
    parser.add_argument("--logdir", type=str, default="./logs")
    parser.add_argument("--infer-list", type=str,
                        default="./data/val_voc.txt")
    parser.add_argument("--mask-output-dir", type=str, default="results/")
    parser.add_argument("--cfg", dest="cfg_file", required=True,
                        help="Config file")
    parser.add_argument("--set", dest="set_cfgs", default=[], nargs="+",
                        help="Set config keys: KEY VALUE pairs")
    parser.add_argument("--random-seed", type=int, default=64)
    parser.add_argument("--isattention", type=str2bool, default=False,
                        nargs="?", const=True,
                        help="Use the attention loss")
    parser.add_argument("--profile-dir", type=str, default="",
                        help="Profiler trace directory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:N, cpu)")


def maybe_create_dir(path: str):
    os.makedirs(path, exist_ok=True)


def check_global_arguments(args):
    args.fixed_batch_path = os.path.join(
        args.logdir, args.dataset, args.exp, "fixed_batch.npz")
    args.logdir = os.path.join(args.logdir, args.dataset, args.exp,
                               args.run)
    maybe_create_dir(args.logdir)
    args.snapshot_dir = os.path.join(args.snapshot_dir, args.dataset,
                                     args.exp, args.run)
    maybe_create_dir(args.snapshot_dir)


def get_device(args):
    """The ``--device`` of ``args`` as a torch.device; raises if it is a
    CUDA device and no card is present (no fallback to the CPU)."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU")
    return device


def get_arguments(args_in: Sequence[str]):
    parser = argparse.ArgumentParser(description="Model training/evaluation")
    add_global_arguments(parser)
    args = parser.parse_args(args_in)
    check_global_arguments(args)
    return args
