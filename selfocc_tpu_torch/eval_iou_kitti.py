"""SemanticKITTI occupancy evaluation driver on the PyTorch port —
counterpart of the repository's ``eval_iou_kitti.py``.

    python -m selfocc_tpu_torch.eval_iou_kitti [--py-config kitti_occ] \\
        [--kitti-root data/kitti] [--num-samples N] [--sem] [--synthetic] \\
        [--device cpu] [--work-dir DIR] [--no-shard]

The run log goes to stdout and ``<--work-dir>/<time>.log``
(``work_dirs/eval_iou_kitti`` by default, as the JAX driver's).

Real data: the SemanticKITTI val split (``data.build_dataset(cfg, "val")``,
``Kitti_One_Frame`` over ``<data_path>/dataset``, sequence 08, indexed by
the frames with completion labels); the labels are read from
``<--kitti-root>/dataset/sequences/<sequence>/voxels/<frame>.label`` and
``.invalid``. Without the odometry tree it exits non-zero, naming the
missing path.

Per sample: ``GridOccEvaluator`` decodes the field once and evaluates the
sdf (+ semantics with ``--sem``) on the uniform metric grid over the fixed
front-only AABB ``KITTI_AABB`` at ``--resolution`` (256 x 256 x 32 at 0.2
m), thresholds ``sdf <= --thresh``, applies the reference post-crop (the
z-slabs from 28 up, 6-voxel borders) and scores binary ``IoU`` and
``SSCMetrics`` (SceneRF completion IoU, precision, recall) against the
remapped 20-class voxel labels flipped on axis 1; ``--sem`` adds
``MeanIoU`` through ``cityscapes2semantickitti`` (the model needs a
semantic head). ``--synthetic``: the procedural scene's ground slab.

The JAX driver reads the frame's ``token`` and ``sequence`` from
``train.as_arrays(item)``, which drops strings, so it scores no real frame;
this driver reads them from the item. Weights are seeded (``--seed``), or
loaded with ``--ckpt-path`` (the port's ``train.py`` checkpoint) or
``--torch-ckpt`` (a reference-SelfOcc ``.pth``). Runs on the first CUDA
device unless ``--device cpu`` asks for the kernels' plain versions on the
CPU; with no card and no ``--device cpu`` it exits non-zero. On cards
the grid's points split over every visible card (``GridOccEvaluator``, as
the JAX driver's mesh); ``--no-shard`` keeps the query on the first (the
JAX driver has no ``--prepare-shard``).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from .configs.experiments import get_config
from .data.semantic_kitti_io import read_semantic_kitti_voxels
from .eval_depth import build_model
from .utils.eval_lib import GridOccEvaluator, camera_kwargs
from .utils.metrics import IoU, MeanIoU, cityscapes2semantickitti
from .utils.runtime import (add_device_arg, add_shard_args, add_weights_args,
                            get_dataset, get_logger, load_weights,
                            resolve_device, shard_devices, to_device)
from .utils.scenerf_metric import SSCMetrics

# reference eval_iou_kitti.py:163 — the fixed front-only scoring AABB
KITTI_AABB = (-25.6, 0.0, -2.0, 25.6, 51.2, 4.4)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", default="kitti_occ")
    ap.add_argument("--work-dir", default="work_dirs/eval_iou_kitti",
                    help="where the run log <time>.log goes")
    ap.add_argument("--kitti-root", default="data/kitti",
                    help="the SemanticKITTI root holding dataset/sequences/"
                         "<seq>/voxels/<frame>.label and .invalid")
    ap.add_argument("--resolution", type=float, default=0.2)
    ap.add_argument("--thresh", type=float, default=0.0)
    ap.add_argument("--sem", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
    add_shard_args(ap, prepare=False)
    add_weights_args(ap)
    add_device_arg(ap)
    return ap.parse_args(argv)


def crop_prediction(pred_occ: np.ndarray) -> np.ndarray:
    """The reference post-crop (``eval_iou_kitti.py:87-90``), in place."""
    pred_occ[..., 28:] = 0
    pred_occ[-6:, ...] = 0
    pred_occ[:, :6, :] = 0
    pred_occ[:, -6:, :] = 0
    return pred_occ


def read_labels(kitti_root: str, sequence: str, token: str) -> np.ndarray:
    """The frame's 20-class voxel labels (invalid -> 255), flipped on axis
    1 into the prediction grid's orientation (``eval_iou_kitti.py:72-78``)."""
    label_path = os.path.join(kitti_root, "dataset/sequences", str(sequence),
                              "voxels", f"{token}.label")
    gt = read_semantic_kitti_voxels(label_path,
                                    label_path.replace(".label", ".invalid"))
    return np.flip(gt, 1)


def evaluate(cfg, model, ds, device, args, logger) -> Dict:
    """The eval loop of the repository's ``eval_iou_kitti.py``: scores
    ``args.num_samples`` items of ``ds``. Returns the metric objects, the
    binary ``iou``, the SceneRF ``stats``, ``miou`` with ``--sem``, the
    last frame's ``pred_occ`` and ``sdf``, and the seconds spent in prepare
    and in the grid queries (synchronised on the device)."""
    evaluator = GridOccEvaluator(
        model, devices=shard_devices(device, args.no_shard))
    if args.sem and not model.head._occ_sem(("sem",)):
        raise SystemExit(f"--sem: the {cfg.name} model has no semantic "
                         "head (return_sem with sem_dims > 0)")
    iou_metric = IoU()
    scenerf_metric = SSCMetrics(n_classes=20)
    miou_metric = MeanIoU(
        class_indices=list(range(1, 20)), empty_label=0,
        label_str=[f"c{i}" for i in range(1, 20)]) if args.sem else None
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t_prep = t_query = 0.0
    keys = ("sdf", "sem") if args.sem else ("sdf",)
    res = {}
    n = min(args.num_samples or len(ds), len(ds))
    for i in range(n):
        item = ds[i]
        batch = to_device(item, device)
        sync()
        t0 = time.perf_counter()
        volume = evaluator.prepare(batch["imgs"], batch["lidar2img"],
                                   **camera_kwargs(cfg, batch))
        sync()
        t1 = time.perf_counter()
        out = evaluator.query_grid(volume, KITTI_AABB, args.resolution,
                                   keys=keys)
        t_query += time.perf_counter() - t1
        t_prep += t1 - t0
        pred_occ = crop_prediction(
            (out["sdf"] <= args.thresh).astype(np.int32))
        res.update(pred_occ=pred_occ, sdf=out["sdf"])

        token, seq = item.get("token"), item.get("sequence")
        if not args.synthetic and token is not None:
            gt_raw = read_labels(args.kitti_root, seq, token)
            gt = gt_raw.copy()
            gt[gt == 255] = 0
            iou_metric._after_step(pred_occ, np.stack(np.nonzero(gt), -1))
            scenerf_metric.add_batch(pred_occ[None], gt_raw[None])
            if miou_metric is not None:
                sem = cityscapes2semantickitti(out["sem"])
                miou_metric._after_step(pred_occ * sem, gt_raw,
                                        gt_raw != 255)
        elif hasattr(ds, "gt_occupancy"):
            gt = ds.gt_occupancy(list(KITTI_AABB), args.resolution)
            gt = gt[:pred_occ.shape[0], :pred_occ.shape[1],
                    :pred_occ.shape[2]]
            iou_metric._after_step(pred_occ, np.stack(np.nonzero(gt), -1))
            scenerf_metric.add_batch(pred_occ[None],
                                     gt[None].astype(np.int32))
        else:
            logger.warning(f"[{i}] no labels for this frame; not scored")
            continue
        logger.info(f"[{i + 1}/{n}] occupied {pred_occ.mean() * 100:.2f}%")

    res["iou"] = iou_metric._after_epoch(logger=logger)
    res["stats"] = scenerf_metric.get_stats()
    logger.info(f"IoU: {res['iou']:.2f}")
    logger.info(f"SceneRF iou: {res['stats']['iou']:.4f} precision: "
                f"{res['stats']['precision']:.4f} recall: "
                f"{res['stats']['recall']:.4f}")
    if miou_metric is not None:
        res["miou"], res["miou_iou"] = miou_metric._after_epoch(logger=logger)
        logger.info(f"mIoU: {res['miou']:.2f} IoU: {res['miou_iou']:.2f}")
    logger.info(f"prepare {t_prep:.3f}s, grid queries {t_query:.3f}s")
    return dict(res, prepare_s=t_prep, query_s=t_query,
                iou_metric=iou_metric, scenerf_metric=scenerf_metric,
                miou_metric=miou_metric)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    ds = get_dataset(cfg, args.synthetic, phase="val")
    logger = get_logger(args.work_dir)
    model = build_model(cfg, args.seed, device)
    load_weights(model, args.ckpt_path, args.torch_ckpt, logger)
    return evaluate(cfg, model, ds, device, args, logger)


if __name__ == "__main__":
    main()
