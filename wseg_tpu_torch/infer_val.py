"""Multi-scale / multi-crop mask inference with the port (same flags as
the root ``infer_val.py``).

    python -m wseg_tpu_torch.infer_val --cfg configs/voc_resnet38.yaml \
        --infer-list data/val_voc.txt --resume snapshot.pth \
        --mask-output-dir results/ [--device cuda]

Loads a port or reference ``.pth`` snapshot (a path, or a suffix
``eNNNXsS.SSS`` that the port's trainer wrote under
``--snapshot-dir``) and writes indexed PNGs per threshold to
``<mask-output-dir>_<thresh>/{no_crf,crf,vis}``.  ``--set NET.DTYPE
int8`` serves with w8a8 backbone convs (dynamic activation scales;
with ``NET.QUANT_ACT static NET.QUANT_STATS stats.pt`` the calibrated
ones that ``wseg_tpu_torch.quant_calibrate`` wrote).  With ``TEST.METHOD``
``multiscale`` or ``multicrop`` and ``TEST.DEVICE_MERGE`` and
``UINT8_TRANSFER`` on (and no heatmap or scoremap writer), every image
goes through the batched server (``MultiScaleServer``: device views, or
host views where ``DEVICE_VIEWS`` is off or an image exceeds the
canvas; ``MultiCropServer`` for multicrop, e.g. ``--set TEST.METHOD
multicrop TEST.PAD_SIZE "[640, 640]"``) with the device writer math and
the dense CRF of ``TEST.CRF_MODE`` (``fast``, or ``exact`` for the
permutohedral mean field).  Otherwise each image goes through the
per-image ``InferenceEngine`` (the model on ``--device``, the merge on
the host or the device) and ``ResultWriter.save`` with the host C++
dense CRF.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node
N``) each rank is one serving replica on its own device
(``cuda:$LOCAL_RANK``): it serves ``entries[rank::N]`` with its own
server of ``TEST.BATCH_SIZE`` slots and writes those images' PNGs
(labels are per image, so the ranks' files together are one process's).
Rank 0 builds the kernels first and prints the progress.
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
from wseg_tpu_torch.parallel import dist

# (prospect_thresh, heatmap, scoremap, crf) per writer; the first
# TEST_ID entries are active
TEST_ID = [0, 1]
PROSPECT_THRESHS = [0.0, 0.1, 0.3, 0.5, 0.7]
HEATMAPS = [False] * 5
SCOREMAPS = [False] * 5
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
    seeded random weights when there is none; with ``NET.DTYPE int8``
    and ``NET.QUANT_ACT static``, the calibrated activation statistics
    of ``NET.QUANT_STATS`` (a ``torch.save`` of {conv name: float32
    (cin,) amax}, as ``wseg_tpu_torch.quant_calibrate`` writes it)."""
    from wseg_tpu_torch.models import get_model
    from wseg_tpu_torch.models.backbones.common import (
        load_quant_stats,
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
    if (str(cfg.NET.DTYPE) == "int8"
            and str(getattr(cfg.NET, "QUANT_ACT", "dynamic")) == "static"):
        # serving with the zero-initialised statistics would saturate
        # every conv input, so missing statistics are an error
        stats_path = str(getattr(cfg.NET, "QUANT_STATS", ""))
        if not stats_path or not os.path.isfile(stats_path):
            raise FileNotFoundError(
                "NET.QUANT_ACT=static needs NET.QUANT_STATS pointing at "
                "a calibration file (python -m "
                f"wseg_tpu_torch.quant_calibrate); got {stats_path!r}")
        load_quant_stats(model, torch.load(stats_path, map_location="cpu",
                                           weights_only=True))
        print("Loaded int8 activation calibration", stats_path)
    return model.to(device)


def main(argv):
    args = get_arguments(argv)
    cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)

    device = get_device(args)
    with dist.process_group(device):
        _serve(args, device)


def kernel_sources(batched: bool) -> list:
    """The native libraries a serving run of ``cfg`` loads: the fast or
    the exact CRF's on the batched path, the host C++ CRF's on the
    per-image one, and the int8 convs'."""
    if not batched:
        names = ["permutohedral_host"]
    elif str(cfg.TEST.CRF_MODE) == "exact":
        names = ["crf_lattice", "permutohedral_host"]
    else:
        names = ["crf_bilateral", "crf_gauss"]
    if str(cfg.NET.DTYPE) == "int8":
        names.append("qconv")
    return names


def _serve(args, device):
    """This rank's share of ``--infer-list``, served and written."""
    from wseg_tpu_torch.data.pascal_voc import (
        check_split_integrity,
        labels_from_mask,
        read_filelist,
    )

    nc = int(cfg.TEST.NUM_CLASSES)
    rank, world = dist.rank(), dist.world_size()
    entries = read_filelist(args.infer_list, cfg.TEST.DATA_ROOT)
    check_split_integrity(
        os.path.splitext(os.path.basename(args.infer_list))[0], len(entries))
    n_total = len(entries)
    entries = entries[rank::world]
    method = str(cfg.TEST.METHOD)
    batched = (method in ("multiscale", "multicrop")
               and bool(cfg.TEST.DEVICE_MERGE)
               and bool(cfg.TEST.UINT8_TRANSFER)
               and not any(HEATMAPS[i] or SCOREMAPS[i] for i in TEST_ID))
    dist.build_first(kernel_sources(batched), device)
    model = load_serving_model(args, device)

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

    def progress(i):
        # rank 0's i-th image is about the (i * world)-th of the list
        if i % 100 == 0:
            dist.print_main(f"[{i * world}/{n_total}]", flush=True)

    n_workers = max(1, int(args.workers or 4))
    with ThreadPoolExecutor(n_workers) as pool:
        if batched:
            _serve_batched(args, model, method, entries, read_entry, pool,
                           n_workers, progress)
        else:
            _serve_per_image(args, model, entries, read_entry, pool,
                             n_workers, progress)
    dist.barrier()


def _serve_batched(args, model, method, entries, read_entry, pool,
                   n_workers, progress):
    """The batched server with the device writer math."""
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.engine.serving import MultiScaleServer
    from wseg_tpu_torch.engine.serving_crop import MultiCropServer
    from wseg_tpu_torch.engine.writers import ResultWriter

    threshs = [PROSPECT_THRESHS[i] for i in TEST_ID]
    crf_threshs = [PROSPECT_THRESHS[i] for i in TEST_ID if CRFS[i]]
    # the reference's multicrop merge applies no BG_POW, only the
    # multi-scale merge does
    pp = make_device_postprocess(
        threshs, crf_threshs, crf_iters=10,
        bg_pow=float(cfg.TEST.BG_POW) if method == "multiscale" else 1.0,
        crf_dtype=str(cfg.TEST.CRF_DTYPE),
        crf_stride=int(cfg.TEST.CRF_STRIDE),
        crf_tap_div=float(cfg.TEST.CRF_TAP_DIV),
        crf_full_stride=int(cfg.TEST.CRF_FULL_STRIDE),
        crf_refine_iters=int(cfg.TEST.CRF_REFINE_ITERS),
        crf_mode=str(cfg.TEST.CRF_MODE))
    writers = [ResultWriter(_out_dir(args, i)) for i in TEST_ID]

    def write_result(res, img_path, image01, gt_mask):
        for k, idx in enumerate(TEST_ID):
            t = PROSPECT_THRESHS[idx]
            writers[k].save_pred(img_path, image01, res[t]["pred"],
                                 res[t].get("pred_crf"), gt_mask)

    server_cls = (MultiScaleServer if method == "multiscale"
                  else MultiCropServer)
    server = server_cls(model, cfg.TEST, max_batch=int(cfg.TEST.BATCH_SIZE),
                        postprocess=pp)
    try:
        if entries:
            first, _, _ = read_entry(*entries[0])
            server.warmup([(first.shape[1], first.shape[0])])
        futures, inflight = deque(), deque()

        def drain_one():
            j, f, p, im01, gm = inflight.popleft()
            res, _ = f.result()
            futures.append(pool.submit(write_result, res, p, im01, gm))
            progress(j)

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


def _serve_per_image(args, model, entries, read_entry, pool, n_workers,
                     progress):
    """The per-image path: ``InferenceEngine`` scores, written by
    ``ResultWriter.save`` with the host C++ dense CRF in the writer
    pool (it overlaps the next image's forward)."""
    from wseg_tpu_torch.engine.infer import InferenceEngine
    from wseg_tpu_torch.engine.writers import ResultWriter
    from wseg_tpu_torch.ops.crf_native import crf_inference_native

    crf_fn = (crf_inference_native if any(CRFS[i] for i in TEST_ID)
              else None)
    writers = [ResultWriter(_out_dir(args, i),
                            prospect_thresh=PROSPECT_THRESHS[i],
                            heatmap=HEATMAPS[i], scoremap=SCOREMAPS[i],
                            use_crf=CRFS[i], crf_fn=crf_fn)
               for i in TEST_ID]
    engine = InferenceEngine(model, cfg.TEST)
    futures = deque()
    for i, (img_path, mask_path) in enumerate(entries):
        image, gt_mask, gt_labels = read_entry(img_path, mask_path)
        merged, _ = engine.run_image(image, gt_labels)
        image01 = image.astype(np.float32) / 255.0
        for w in writers:
            futures.append(pool.submit(w.save, img_path, image01, merged,
                                       gt_mask))
        while len(futures) > 4 * n_workers:
            futures.popleft().result()
        progress(i)
    while futures:
        futures.popleft().result()


def _out_dir(args, idx: int) -> str:
    return (args.mask_output_dir + "_"
            + str(PROSPECT_THRESHS[idx]).split(".")[-1])


if __name__ == "__main__":
    main(sys.argv[1:])
