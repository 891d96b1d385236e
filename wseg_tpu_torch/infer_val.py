"""Multi-scale mask inference with the port (same flags as the root
``infer_val.py``).

    python -m wseg_tpu_torch.infer_val --cfg configs/voc_resnet38.yaml \
        --infer-list data/val_voc.txt --resume snapshot.pth \
        --mask-output-dir results/ [--device cuda]

Loads a port or reference ``.pth`` snapshot (a path, or a suffix
``eNNNXsS.SSS`` that the port's trainer wrote under
``--snapshot-dir``), serves every image of the filelist through
``MultiScaleServer`` (device views, merge and writer math with the dense
CRF of ``TEST.CRF_MODE``: ``fast``, or ``exact`` for the permutohedral
mean field, e.g. ``--set TEST.CRF_MODE exact``) on ``--device`` and
writes indexed PNGs per threshold to
``<mask-output-dir>_<thresh>/{no_crf,crf,vis}``.
"""

from __future__ import annotations

import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from wseg_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
from wseg_tpu_torch.opts import get_arguments, get_device

# (prospect_thresh, crf) per writer; the first TEST_ID entries are active
TEST_ID = [0, 1]
PROSPECT_THRESHS = [0.0, 0.1, 0.3, 0.5, 0.7]
CRFS = [True, True, False, False, False]


def _find_snapshot(resume: str, snapshot_dir: str) -> str:
    from wseg_tpu_torch.utils.checkpoints import model_file

    for cand in (resume, os.path.join(snapshot_dir, resume),
                 os.path.join(snapshot_dir, resume + ".pth"),
                 model_file(snapshot_dir, resume)):
        if cand and os.path.isfile(cand):
            return cand
    return ""


def load_serving_model(args, device):
    """``cfg.NET``'s serving model on ``device`` carrying ``--resume``'s
    weights (a ``.pth`` path or a suffix under ``--snapshot-dir``), or
    seeded random weights when there is none."""
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import (
        seeded_init_,
        stabilize_scratch_init,
    )
    from wseg_tpu_torch.utils.convert import load_checkpoint

    # float32 products stay float32 (the view resampling and merge
    # matmuls round to uint8 / argmax downstream; the CAM engines'
    # gradients are held to the JAX package's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model(cfg.NET, num_classes=int(cfg.TEST.NUM_CLASSES))
    snapshot = _find_snapshot(args.resume or "", args.snapshot_dir)
    if snapshot:
        load_checkpoint(model, snapshot)
        print("Loaded snapshot", snapshot)
    else:
        print("WARNING: snapshot not found, using random init")
        seeded_init_(model, torch.Generator().manual_seed(args.random_seed))
        stabilize_scratch_init(model, 0.1)
    return model.to(device)


def main(argv):
    args = get_arguments(argv)
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)

    from wseg_tpu_torch.data.pascal_voc import labels_from_mask, read_filelist
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving import MultiScaleServer
    from wseg_tpu_torch.engine.writers import ResultWriter

    nc = int(cfg.TEST.NUM_CLASSES)
    model = load_serving_model(args, get_device(args))

    if not (str(cfg.TEST.METHOD) == "multiscale"
            and bool(cfg.TEST.DEVICE_MERGE)
            and bool(cfg.TEST.UINT8_TRANSFER)
            and bool(cfg.TEST.DEVICE_VIEWS)):
        raise NotImplementedError(
            "only the multiscale device fast path is ported (ROADMAP.md "
            "queue A)")

    threshs = [PROSPECT_THRESHS[i] for i in TEST_ID]
    crf_threshs = [PROSPECT_THRESHS[i] for i in TEST_ID if CRFS[i]]
    pp = make_device_postprocess(
        threshs, crf_threshs, crf_iters=10,
        bg_pow=float(cfg.TEST.BG_POW), crf_dtype=str(cfg.TEST.CRF_DTYPE),
        crf_stride=int(cfg.TEST.CRF_STRIDE),
        crf_tap_div=float(cfg.TEST.CRF_TAP_DIV),
        crf_full_stride=int(cfg.TEST.CRF_FULL_STRIDE),
        crf_refine_iters=int(cfg.TEST.CRF_REFINE_ITERS),
        crf_mode=str(cfg.TEST.CRF_MODE))
    writers = [ResultWriter(args.mask_output_dir + "_"
                            + str(PROSPECT_THRESHS[i]).split(".")[-1])
               for i in TEST_ID]

    entries = read_filelist(args.infer_list, cfg.TEST.DATA_ROOT)
    n_total = len(entries)

    def read_entry(img_path, mask_path):
        from PIL import Image

        with Image.open(img_path) as im:
            image = np.asarray(im.convert("RGB"), np.uint8)
        gt_mask = None
        if mask_path and os.path.isfile(mask_path):
            with Image.open(mask_path) as m:
                gt_mask = np.asarray(m, np.int32)
        gt_labels = (labels_from_mask(gt_mask, num_class=nc)
                     if gt_mask is not None
                     else np.zeros(nc - 1, np.float32))
        return image, gt_mask, gt_labels

    def write_result(res, img_path, image01, gt_mask):
        for k, idx in enumerate(TEST_ID):
            t = PROSPECT_THRESHS[idx]
            writers[k].save_pred(img_path, image01, res[t]["pred"],
                                 res[t].get("pred_crf"), gt_mask)

    n_workers = max(1, int(args.workers or 4))
    server = MultiScaleServer(model, cfg.TEST,
                              max_batch=int(cfg.TEST.BATCH_SIZE),
                              postprocess=pp)
    with ThreadPoolExecutor(n_workers) as pool:
        try:
            if entries:
                first, _, _ = read_entry(*entries[0])
                server.warmup([(first.shape[1], first.shape[0])])
            futures, inflight = deque(), deque()

            def drain_one():
                j, f, p, im01, gm = inflight.popleft()
                res, _ = f.result()
                futures.append(pool.submit(write_result, res, p, im01, gm))
                if j % 100 == 0:
                    print(f"[{j}/{n_total}]", flush=True)

            for i, (img_path, mask_path) in enumerate(entries):
                while len(futures) > 4 * n_workers:
                    futures.popleft().result()
                image, gt_mask, gt_labels = read_entry(img_path, mask_path)
                image01 = (image.astype(np.float32) / 255.0
                           if gt_mask is not None else None)
                inflight.append((i, server.submit(image, gt_labels),
                                 img_path, image01, gt_mask))
                while len(inflight) > 2 * int(cfg.TEST.BATCH_SIZE):
                    drain_one()
            while inflight:
                drain_one()
            while futures:
                futures.popleft().result()
        finally:
            server.close()


if __name__ == "__main__":
    main(sys.argv[1:])
