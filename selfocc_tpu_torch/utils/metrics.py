"""Depth metrics — the port's copy of ``DepthMetric`` and ``_DEPTH_KEYS``
from ``selfocc_tpu/utils/metrics.py`` (host-side numpy). The port runs one
process, so ``_after_epoch`` averages locally instead of summing across JAX
processes.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

_DEPTH_KEYS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def cal_depth_metric(depth_pred: np.ndarray, depth_gt: np.ndarray) -> Dict:
    """monodepth2-style error set (reference ``metric_util.py:246-287``)."""
    depth_pred = np.clip(depth_pred, 1e-3, 80)
    thresh = np.maximum(depth_gt / depth_pred, depth_pred / depth_gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    rmse = float(np.sqrt(((depth_gt - depth_pred) ** 2).mean()))
    rmse_log = float(np.sqrt(
        ((np.log(depth_gt) - np.log(depth_pred)) ** 2).mean()))
    abs_rel = float((np.abs(depth_gt - depth_pred) / depth_gt).mean())
    sq_rel = float((((depth_gt - depth_pred) ** 2) / depth_gt).mean())
    return {"abs_rel": abs_rel, "sq_rel": sq_rel, "rmse": rmse,
            "rmse_log": rmse_log, "a1": a1, "a2": a2, "a3": a3}


class DepthMetric:
    """Per-camera depth metrics with raw/median-scaled variants
    (reference ``metric_util.py:290-397``). ``_after_step`` takes the depth
    prediction already bilinearly sampled at the lidar pixel locations."""

    def __init__(self, camera_names: Sequence[str] = ("front",),
                 eval_types: Sequence[str] = ("raw", "median")):
        self.camera_names = list(camera_names)
        self.eval_types = list(eval_types)
        self.num_cams = len(self.camera_names)
        self.num_types = len(self.eval_types)
        self._reset()

    def _reset(self):
        shape = (self.num_types, self.num_cams)
        self.sums = {k: np.zeros(shape) for k in _DEPTH_KEYS}
        self.scaling = np.zeros(shape)
        self.count = 0.0

    def _after_step(self, depth_pred_at_gt, depth_gt, depth_mask):
        """depth_pred_at_gt / depth_gt / depth_mask: (N, n)."""
        for cam in range(self.num_cams):
            m = np.asarray(depth_mask[cam]).astype(bool)
            gt = np.asarray(depth_gt[cam])[m]
            pred = np.asarray(depth_pred_at_gt[cam])[m]
            if gt.size == 0:
                continue
            for ti, t in enumerate(self.eval_types):
                if t == "raw":
                    cal = pred
                    self.scaling[ti, cam] += 1.0
                elif t == "median":
                    scaling = np.median(gt) / max(np.median(pred), 1e-8)
                    cal = scaling * pred
                    self.scaling[ti, cam] += scaling
                else:
                    raise NotImplementedError(
                        f"unknown depth eval scaling {t!r} (raw|median)")
                md = cal_depth_metric(cal, gt)
                for k in _DEPTH_KEYS:
                    self.sums[k][ti, cam] += md[k]
        self.count += 1

    def _after_epoch(self, logger=None) -> Dict[str, np.ndarray]:
        count = max(self.count, 1)
        out = {k: self.sums[k] / count for k in _DEPTH_KEYS}
        out["scaling"] = self.scaling / count
        if logger is not None:
            logger.info(f"Averaging over {int(self.count)} samples.")
            for ti, t in enumerate(self.eval_types):
                logger.info(f"{t} evaluation:")
                logger.info(("{:>12} | " * 9).format(
                    "cam_name", *_DEPTH_KEYS, "scale"))
                for cam, name in enumerate(self.camera_names):
                    vals = [out[k][ti, cam] for k in _DEPTH_KEYS]
                    vals.append(out["scaling"][ti, cam])
                    logger.info((f"{name:>12} | " + "&{: 12.3f}  " * 8)
                                .format(*vals))
                vals = [out[k][ti].mean() for k in _DEPTH_KEYS]
                vals.append(out["scaling"][ti].mean())
                logger.info(("{:>12} | " + "&{: 12.3f}  " * 8)
                            .format("All", *vals))
        return out
