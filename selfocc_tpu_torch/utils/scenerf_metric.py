"""SceneRF-style semantic scene completion metrics — the port's copy of
``selfocc_tpu/utils/scenerf_metric.py``.

Behavioral rewrite of ``utils/scenerf_metric.py`` (itself derived from the
public SSC benchmark code) in vectorized numpy — the per-class python loops
become bincount confusion sums.
"""
from __future__ import annotations

import numpy as np

from .metrics import _allreduce_sum


class SSCMetrics:
    """Scene-completion IoU/precision/recall + per-class semantic IoU
    (reference ``scenerf_metric.py:40-215``). Labels == 255 are ignored."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.completion_tp = 0.0
        self.completion_fp = 0.0
        self.completion_fn = 0.0
        self.tps = np.zeros(self.n_classes)
        self.fps = np.zeros(self.n_classes)
        self.fns = np.zeros(self.n_classes)

    def add_batch(self, y_pred, y_true, nonempty=None, nonsurface=None):
        y_pred = np.asarray(y_pred).reshape(y_pred.shape[0], -1).copy()
        y_true = np.asarray(y_true).reshape(y_true.shape[0], -1).copy()
        mask = y_true != 255
        if nonempty is not None:
            mask = mask & np.asarray(nonempty).reshape(mask.shape).astype(bool)
        base_mask = mask
        if nonsurface is not None:
            mask = mask & np.asarray(nonsurface).reshape(mask.shape).astype(bool)

        # completion: binary occupied-vs-empty under (mask incl. nonsurface)
        ignore = y_true == 255
        p = np.where(ignore, 0, y_pred) > 0
        t = np.where(ignore, 0, y_true) > 0
        m = mask if nonempty is not None or nonsurface is not None else \
            np.ones_like(mask)
        # reference applies `nonempty` (incl. nonsurface) selection only
        self.completion_tp += np.sum(t & p & m)
        self.completion_fp += np.sum(~t & p & m)
        self.completion_fn += np.sum(t & ~p & m)

        # semantics under (mask without nonsurface), y_true != 255
        sel = base_mask & (y_true != 255)
        yt = y_true[sel].astype(np.int64)
        yp = y_pred[sel].astype(np.int64)
        C = self.n_classes
        valid = (yt >= 0) & (yt < C) & (yp >= 0) & (yp < C)
        hist = np.bincount(C * yt[valid] + yp[valid],
                           minlength=C * C).reshape(C, C)
        tp = np.diag(hist)
        self.tps += tp
        self.fps += hist.sum(0) - tp
        self.fns += hist.sum(1) - tp

    def get_stats(self):
        self.completion_tp = float(_allreduce_sum(np.asarray(self.completion_tp)))
        self.completion_fp = float(_allreduce_sum(np.asarray(self.completion_fp)))
        self.completion_fn = float(_allreduce_sum(np.asarray(self.completion_fn)))
        self.tps = _allreduce_sum(self.tps)
        self.fps = _allreduce_sum(self.fps)
        self.fns = _allreduce_sum(self.fns)
        if self.completion_tp != 0:
            precision = self.completion_tp / (self.completion_tp + self.completion_fp)
            recall = self.completion_tp / (self.completion_tp + self.completion_fn)
            iou = self.completion_tp / (
                self.completion_tp + self.completion_fp + self.completion_fn)
        else:
            precision = recall = iou = 0.0
        iou_ssc = self.tps / (self.tps + self.fps + self.fns + 1e-5)
        return {
            "precision": precision, "recall": recall, "iou": iou,
            "iou_ssc": iou_ssc, "iou_ssc_mean": float(np.mean(iou_ssc[1:])),
        }
