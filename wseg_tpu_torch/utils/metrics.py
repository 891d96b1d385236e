"""Segmentation / classification metrics, numpy only.

Copy of ``wseg_tpu/utils/metrics.py`` (confusion matrices by
``np.bincount``, IoU, the streaming ``Metric``), except that
``average_precision`` is computed here in numpy with
``sklearn.metrics.average_precision_score``'s definition instead of
importing scikit-learn.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def confusion_matrix(gt: np.ndarray, pred: np.ndarray,
                     num_classes: int = 21) -> np.ndarray:
    """Accumulate a (C, C) confusion matrix, skipping GT==255 pixels.

    Matches reference eval_seg.py:170-183 exactly: rows = GT class,
    cols = predicted class; GT values >= C are ignored.
    """
    gt = gt.reshape(-1).astype(np.int64)
    pred = pred.reshape(-1).astype(np.int64)
    valid = gt < num_classes
    idx = gt[valid] * num_classes + pred[valid]
    counts = np.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).astype(np.float64)


def iou_from_confusion(M: np.ndarray):
    """Per-class (IoU, precision, recall) percentages + means.

    Returns dict with 'iou', 'precision', 'recall' arrays (C,), and means
    with / without background ('miou', 'miou_bkg', ...).
    """
    eps = 1e-20
    tp = np.diag(M)
    fn = M.sum(1) - tp
    fp = M.sum(0) - tp
    iou = 100.0 * tp / (eps + tp + fn + fp)
    pr = 100.0 * tp / (eps + tp + fp)
    re = 100.0 * tp / (eps + tp + fn)
    return {
        "iou": iou, "precision": pr, "recall": re,
        "miou": float(iou[1:].mean()),
        "mprecision": float(pr[1:].mean()),
        "mrecall": float(re[1:].mean()),
        "miou_bkg": float(iou.mean()),
        "mprecision_bkg": float(pr.mean()),
        "mrecall_bkg": float(re.mean()),
    }


def per_image_score(M_one: np.ndarray, labels: Sequence[int]):
    """TP - FN - FP per present class (reference eval_seg.py:75-87)."""
    out = {}
    for i in labels:
        if i == 255:
            continue
        tp = M_one[i, i]
        fn = M_one[i, :].sum() - tp
        fp = M_one[:, i].sum() - tp
        out[int(i)] = float(tp - fn - fp)
    return out


def compute_jaccard(preds: Sequence[np.ndarray],
                    gts: Sequence[np.ndarray], num_classes: int = 21):
    """Streaming jaccard/precision/recall over mask batches.

    Reference utils/metrics.py:145-185 semantics, including overwriting
    predictions with 255 where GT==255.
    """
    tps = np.zeros(num_classes)
    fps = np.zeros(num_classes)
    fns = np.zeros(num_classes)
    for pred, gt in zip(preds, gts):
        pred = np.asarray(pred).copy()
        gt = np.asarray(gt)
        pred[gt == 255] = 255
        for c in range(num_classes):
            p = pred == c
            g = gt == c
            tps[c] += np.sum(p & g)
            fps[c] += np.sum(p & ~g)
            fns[c] += np.sum(~p & g)
    jac = tps / np.maximum(1e-3, tps + fps + fns)
    pr = tps / np.maximum(1e-3, tps + fps)
    re = tps / np.maximum(1e-3, tps + fns)
    return list(jac), list(pr), list(re)


def _average_precision_1d(y: np.ndarray, s: np.ndarray) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n over the distinct score thresholds
    (sklearn's step-wise definition, no interpolation)."""
    order = np.argsort(-s, kind="mergesort")
    s, y = s[order], y[order]
    last = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[last]
    fps = 1 + last - tps
    if tps[-1] <= 0:
        return 0.0
    precision = np.r_[(tps / (tps + fps))[::-1], 1.0]
    recall = np.r_[(tps / tps[-1])[::-1], 0.0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def average_precision(targets: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per-class AP for multi-label classification: (N, C) {0, 1}
    targets and (N, C) scores -> (C,)."""
    t = np.asarray(targets, np.float64)
    sc = np.asarray(scores, np.float64)
    return np.asarray([_average_precision_1d(t[:, c], sc[:, c])
                       for c in range(t.shape[1])])


class Metric:
    """Streaming named-mean metrics (reference utils/metrics.py:17-143)."""

    IoU = "IoU"
    MaskIoU = "IoU"
    Precision = "Precision"
    Recall = "Recall"

    def __init__(self):
        self.data: Dict[str, float] = {}
        self.count: Dict[str, float] = {}

    def add_metric(self, m: str):
        self.data[m] = 0.0
        self.count[m] = 0.0

    def update_value(self, m: str, value: float, count: float = 1.0):
        self.data[m] = self.data.get(m, 0.0) + value
        self.count[m] = self.count.get(m, 0.0) + count

    def summarize(self, m: str) -> float:
        if self.count.get(m, 0.0) == 0.0:
            return 0.0
        return self.data[m] / self.count[m]
