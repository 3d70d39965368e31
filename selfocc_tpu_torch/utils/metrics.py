"""Evaluation metrics — the port's copies of ``OPENSEED2NUSCENES`` /
``openseed2nuscenes``, ``MeanIoU``, ``IoU``, ``DepthMetric`` and
``_DEPTH_KEYS`` from ``selfocc_tpu/utils/metrics.py`` (host-side numpy).
The port runs one process, so ``_after_epoch`` sums and averages locally:
the JAX package's ``_allreduce_sum`` across processes is the identity on
one.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# reference metric_util.py:9-64
OPENSEED2NUSCENES = np.array(
    [1, 2, 3, 4, 5, 5, 6, 7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 15, 15, 16, 0],
    np.int32)


def openseed2nuscenes(sem):
    return OPENSEED2NUSCENES[np.asarray(sem).reshape(-1)].reshape(
        np.shape(sem))


class MeanIoU:
    """Semantic occupancy mIoU + binary occupancy IoU
    (reference ``metric_util.py:67-165``), including the Occ3D dict-target
    path with camera masking and the z-crop of empty slabs."""

    def __init__(self, class_indices, empty_label, label_str, use_mask=False,
                 dataset_empty_label=17, name="none"):
        self.class_indices = list(class_indices)
        self.num_classes = len(class_indices)
        self.empty_label = empty_label
        self.dataset_empty_label = dataset_empty_label
        self.label_str = label_str
        self.use_mask = use_mask
        self.name = name
        self.reset()

    def reset(self):
        self.total_seen = np.zeros(self.num_classes + 1)
        self.total_correct = np.zeros(self.num_classes + 1)
        self.total_positive = np.zeros(self.num_classes + 1)

    def _after_step(self, outputs, targets, mask=None):
        outputs = np.asarray(outputs)
        if isinstance(targets, dict):
            assert mask is None
            labels = np.asarray(targets["semantics"]).copy()
            masks = np.asarray(targets["mask_camera"]).astype(bool)
            labels[labels == self.dataset_empty_label] = self.empty_label
            nz = np.nonzero(labels != self.empty_label)[2]
            max_z, min_z = nz.max(), nz.min()
            outputs = outputs.copy()
            outputs[..., (max_z + 1):] = self.empty_label
            outputs[..., :min_z] = self.empty_label
            targets = labels
            if self.use_mask:
                outputs = outputs[masks]
                targets = targets[masks]
        elif mask is not None:
            outputs = outputs[mask]
            targets = targets[mask]
        targets = np.asarray(targets)

        for i, c in enumerate(self.class_indices):
            self.total_seen[i] += np.sum(targets == c)
            self.total_correct[i] += np.sum((targets == c) & (outputs == c))
            self.total_positive[i] += np.sum(outputs == c)
        self.total_seen[-1] += np.sum(targets != self.empty_label)
        self.total_correct[-1] += np.sum((targets != self.empty_label)
                                         & (outputs != self.empty_label))
        self.total_positive[-1] += np.sum(outputs != self.empty_label)

    def _after_epoch(self, logger=None):
        ious = []
        for i in range(self.num_classes):
            if self.total_seen[i] == 0:
                ious.append(1.0)
            else:
                ious.append(self.total_correct[i] /
                            (self.total_seen[i] + self.total_positive[i]
                             - self.total_correct[i]))
        miou = float(np.mean(ious))
        occ_iou = self.total_correct[-1] / max(
            self.total_seen[-1] + self.total_positive[-1]
            - self.total_correct[-1], 1)
        if logger is not None:
            logger.info(f"Validation per class iou {self.name}:")
            for iou, s in zip(ious, self.label_str):
                logger.info("%s : %.2f%%" % (s, iou * 100))
        return miou * 100, float(occ_iou) * 100


class IoU:
    """Binary occupancy IoU against point/voxel targets
    (reference ``metric_util.py:168-240``)."""

    def __init__(self, use_mask=False):
        self.use_mask = use_mask
        self.reset()

    def reset(self):
        self.total_seen = 0.0
        self.total_correct = 0.0
        self.total_positive = 0.0

    def _after_step(self, outputs, targets, occ3d=False):
        outputs = np.asarray(outputs)
        if occ3d:
            mask = np.asarray(targets["mask_camera"]).astype(bool)
            label = np.asarray(targets["semantics"]) != 17
            if self.use_mask:
                label = label[mask]
                outputs = outputs[mask]
            idx = np.nonzero(label)
            self.total_seen += idx[0].shape[0]
            self.total_correct += outputs[idx].sum()
            self.total_positive += outputs.sum()
            return
        # targets: (n, k) integer voxel indices of occupied cells
        targets = np.asarray(targets)
        self.total_seen += targets.shape[0]
        self.total_correct += outputs[tuple(targets.T)].sum()
        self.total_positive += outputs.sum()

    def _after_epoch(self, logger=None):
        self.total_seen = float(self.total_seen)
        self.total_correct = float(self.total_correct)
        self.total_positive = float(self.total_positive)
        if self.total_seen == 0:
            return 100.0
        iou = self.total_correct / (self.total_seen + self.total_positive
                                    - self.total_correct)
        if logger is not None:
            logger.info(f"occupied IoU: {iou * 100:.2f}%")
        return iou * 100

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
