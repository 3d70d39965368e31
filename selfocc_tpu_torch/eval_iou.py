"""Occupancy IoU / mIoU evaluation driver on the PyTorch port — counterpart
of the repository's ``eval_iou.py`` on one device.

    python -m selfocc_tpu_torch.eval_iou --py-config nuscenes_occ \\
        [--synthetic] --num-samples 1 --occ3d --use-mask --sem [--device cpu]

Real data: the nuScenes val split (``data.build_dataset(cfg, "val")``,
``data/nuscenes_infos_val_sweeps.pkl`` and ``data/nuscenes/``); its items
carry ``occ3d_label_path`` (``<occ3d_root>/<scene name>/<token>/
labels.npz``) and ``openocc_label_path`` where the config's dataset args
name ``occ3d_root`` / ``openocc_root``. Without the index it exits
non-zero, naming the missing path.

Per sample: ``GridOccEvaluator`` decodes the field once and evaluates the
sdf (+ semantics) on the uniform metric grid over the scoring AABB,
thresholds ``sdf <= --thresh`` (``--density``: ``>=``) into occupancy and
scores it as the JAX driver does:

- Occ3D (``--occ3d``): the 200x200x16 ego grid through ``ego2lidar``
  (identity when the batch has none), the dense sdf and logits trilinearly
  resampled there (align-corners, zeros padding), the argmax of the
  resampled logits, the fixed crops; ``--use-mask`` honours
  ``mask_camera``; ``--sem`` adds the mIoU; ``--save-sem DIR`` writes the
  predicted classes as ``labels.npz``.
- OpenOccupancy (no ``--occ3d``, items with ``openocc_label_path``): the
  native grid, which must have the label frame's shape (``--openocc-grid``,
  512x512x40), against the sparse voxel labels.
- Synthetic (``--synthetic`` without Occ3D labels): the procedural scene's
  ground slab (``SyntheticDataset.gt_occupancy``).

``--grid-query separable`` queries the grid as three per-axis lerps (the
same interpolant, ~1 ulp apart) instead of one trilinear query of every
point. Weights are seeded (``--seed``), or loaded with ``--ckpt-path`` (the
port's ``train.py`` checkpoint) or ``--torch-ckpt`` (a reference-SelfOcc
``.pth``). Runs on the first CUDA device unless ``--device cpu`` asks for
the kernels' plain versions on the CPU; with no card and no ``--device
cpu`` it exits non-zero. The JAX driver's mesh options
(``--no-shard``, ``--prepare-shard``) have no counterpart on one device.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from .configs.experiments import get_config
from .eval_depth import build_model
from .ops.interp import trilinear_sample
from .utils.eval_lib import GridOccEvaluator
from .utils.metrics import IoU, MeanIoU, openseed2nuscenes
from .utils.runtime import (add_device_arg, add_weights_args, get_dataset,
                            get_logger, load_weights, resolve_device,
                            to_device)

# reference eval_iou.py:174-196 — (point_cloud_range, expansion) per
# --scene-size under --occ3d; expansion always equals the full range.
OCC3D_SCENES = {
    0: ([-51.2, -51.2, -4.0, 51.2, 51.2, 4.0], [102.4, 102.4, 8.0]),
    1: ([-40.0, -40.0, -2.8, 40.0, 40.0, 3.6], [80.0, 80.0, 6.4]),
    2: ([-40.0, -40.0, -3.1, 40.0, 40.0, 3.9], [80.0, 80.0, 7.0]),
    3: ([-40.0, -40.0, -3.2, 40.0, 40.0, 4.0], [80.0, 80.0, 7.2]),
    4: ([-40.0, -40.0, -1.0, 40.0, 40.0, 5.4], [80.0, 80.0, 6.4]),
    5: ([-51.2, -51.2, -5.0, 51.2, 51.2, 3.0], [102.4, 102.4, 8.0]),
    6: ([-51.2, -51.2, -4.0, 51.2, 51.2, 5.0], [102.4, 102.4, 9.0]),
}
# reference eval_iou.py:174-175 — fixed AABB when scoring OpenOccupancy
OPENOCC_PCR = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]

NUSC_LABELS = [
    "barrier", "bicycle", "bus", "car", "construction_vehicle", "motorcycle",
    "pedestrian", "traffic_cone", "trailer", "truck", "driveable_surface",
    "other_flat", "sidewalk", "terrain", "manmade", "vegetation"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--resolution", type=float, default=0.2)
    ap.add_argument("--thresh", type=float, default=0.0)
    ap.add_argument("--occ3d", action="store_true")
    ap.add_argument("--sem", action="store_true")
    ap.add_argument("--use-mask", action="store_true")
    ap.add_argument("--scene-size", type=int, default=0)
    ap.add_argument("--openocc-grid", type=int, nargs=3,
                    default=[512, 512, 40],
                    help="OpenOccupancy label-frame shape (the reference "
                         "fixes 512x512x40)")
    ap.add_argument("--density", action="store_true",
                    help="field is a density (occupied = value >= thresh)")
    ap.add_argument("--save-sem", default="")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--grid-query", default="gather",
                    choices=["gather", "separable"],
                    help="dense-grid query: 'gather' (one trilinear query "
                         "of every grid point, the parity default) or "
                         "'separable' (three per-axis lerps: the same "
                         "interpolant, ~1 ulp fp32 rounding difference)")
    add_weights_args(ap)
    add_device_arg(ap)
    return ap.parse_args(argv)


# ------------------------------------------------ copies of eval_iou.py's
def read_occ3d_label(path):
    """Occ3D-nuScenes ``labels.npz``: semantics (200,200,16) uint8 with
    17 = free, plus camera/lidar visibility masks (reference
    ``eval_iou.py:26-32``)."""
    data = np.load(path)
    return {"semantics": data["semantics"],
            "mask_camera": data["mask_camera"].astype(bool),
            "mask_lidar": data["mask_lidar"].astype(bool)}


def read_openoccupancy_label(path):
    """OpenOccupancy ``.npy``: rows of occupied voxels, the first three
    columns the voxel coordinates, a fourth (when present) the nuScenes
    class. Returns ``(coords, cls)`` with ``cls=None`` for 3-column
    files."""
    label = np.load(path)
    coords = np.asarray(label[:, :3], dtype=np.int64)
    cls = np.asarray(label[:, 3], dtype=np.int64) if label.shape[1] > 3 \
        else None
    return coords, cls


def openocc_gt_grid(coords, shape=(512, 512, 40), cls=None):
    """Scatter sparse OpenOccupancy voxel coords into a dense grid,
    including the reference's axis reorder (``eval_iou.py:261-263``:
    ``gt_occ[:, [1, 2, 0]]`` then used as (dim0, dim1, dim2) indices).
    Binary 0/1 by default; with ``cls`` the per-voxel semantic class is
    scattered instead (0 stays free)."""
    coords = coords[:, [1, 2, 0]]
    gt = np.zeros(shape, dtype=np.int32)
    valid = np.all((coords >= 0) & (coords < np.asarray(shape)), axis=1)
    c = coords[valid]
    gt[c[:, 0], c[:, 1], c[:, 2]] = 1 if cls is None else cls[valid]
    return gt


def occ3d_ego_to_grid_coords(pcr, expansion, ego2lidar):
    """Metric lidar-frame points (200, 200, 16, 3) of the Occ3D ego grid
    (reference ``eval_iou.py:151-164, 210-218``: ``linspace(-40, 40, 200)``
    x ``linspace(-1, 5.4, 16)`` through ``ego2lidar``)."""
    xs = np.linspace(-40.0, 40.0, 200)
    ys = np.linspace(-40.0, 40.0, 200)
    zs = np.linspace(-1.0, 5.4, 16)
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)  # X,Y,Z,3
    pts = np.concatenate([grid, np.ones_like(grid[..., :1])], -1)
    pts = (pts @ np.asarray(ego2lidar).T)[..., :3]
    return pts


def resample_volume_at(vol, pts, pcr, expansion):
    """Trilinear-sample a (H, W, D[, C]) lidar-frame volume (numpy) at
    metric points with ``grid_sample``'s zeros-padding / align-corners
    semantics; (H, W, D) <-> (y, x, z), fractional index ``norm * (size -
    1)`` (through the port's ``trilinear_sample``, on the CPU)."""
    H, W, D = vol.shape[:3]
    fy = (pts[..., 1] - pcr[1]) / expansion[1] * (H - 1)
    fx = (pts[..., 0] - pcr[0]) / expansion[0] * (W - 1)
    fz = (pts[..., 2] - pcr[2]) / expansion[2] * (D - 1)
    idx = torch.from_numpy(np.stack([fy, fx, fz], -1).astype(np.float32))
    v = vol if vol.ndim == 4 else vol[..., None]
    out = trilinear_sample(torch.from_numpy(np.asarray(v, np.float32)), idx,
                           "zeros").numpy()
    return out if vol.ndim == 4 else out[..., 0]


def apply_occ3d_crops(occ):
    """Fixed Occ3D post-crops (reference ``eval_iou.py:228-233``)."""
    occ = occ.copy()
    occ[..., 12:] = 0
    occ[:6, ...] = 0
    occ[-6:, ...] = 0
    occ[:, :6, :] = 0
    occ[:, -6:, :] = 0
    return occ


def apply_openocc_crops(occ):
    """Fixed non-Occ3D post-crops (reference ``eval_iou.py:252-257``)."""
    occ = occ.copy()
    occ[..., -4:] = 0
    occ[..., :5] = 0
    occ[:6, ...] = 0
    occ[-6:, ...] = 0
    occ[:, :6, :] = 0
    occ[:, -6:, :] = 0
    return occ


# -------------------------------------------------------------- evaluation
def scene(args):
    """The scoring AABB and its expansion (``eval_iou.py:230-236``)."""
    if args.occ3d:
        pcr, expansion = OCC3D_SCENES[args.scene_size]
        return list(pcr), list(expansion)
    pcr = list(OPENOCC_PCR)
    return pcr, [pcr[3] - pcr[0], pcr[4] - pcr[1], pcr[5] - pcr[2]]


def evaluate(cfg, model, ds, device, args, logger) -> Dict:
    """The eval loop of the repository's ``eval_iou.py``: scores
    ``args.num_samples`` items of ``ds``. Returns the metric objects, their
    final numbers and the seconds spent in prepare and in the grid queries
    (synchronised on the device)."""
    pcr, expansion = scene(args)
    evaluator = GridOccEvaluator(model, query=args.grid_query)
    # both metrics are MeanIoU instances, dataset_empty_label=0
    # (reference eval_iou.py:138-149)
    iou_metric = MeanIoU([1], 0, ["occupied"], args.use_mask, 0, name="iou")
    miou_metric = MeanIoU(list(range(1, 17)), 0, NUSC_LABELS, args.use_mask,
                          0, name="miou") if args.sem else None
    sem_remap = openseed2nuscenes if cfg.sem_space == "openseed" \
        else (lambda s: s)
    synth_iou = IoU(use_mask=args.use_mask)
    used_synth = False
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t_prep = t_query = 0.0

    def occupied(sdf):
        return (sdf >= args.thresh) if args.density else (sdf <= args.thresh)

    n = min(args.num_samples or len(ds), len(ds))
    for i in range(n):
        item = ds[i]
        batch = to_device(item, device)
        sync()
        t0 = time.perf_counter()
        volume = evaluator.prepare(batch["imgs"], batch["lidar2img"])
        sync()
        t1 = time.perf_counter()
        t_prep += t1 - t0

        occ3d_targets = None
        if args.occ3d:
            if "occ3d_label_path" in item:
                occ3d_targets = read_occ3d_label(item["occ3d_label_path"])
            elif hasattr(ds, "occ3d_labels"):
                occ3d_targets = ds.occ3d_labels(i)

        if args.occ3d and occ3d_targets is not None:
            ego2lidar = np.asarray(item.get("ego2lidar", np.eye(4)[None]))[0]
            pts = occ3d_ego_to_grid_coords(pcr, expansion, ego2lidar)
            outr = evaluator.query_grid_occ3d(volume, tuple(pcr),
                                              args.resolution, pts, pcr,
                                              expansion)
            t_query += time.perf_counter() - t1
            pred_occ_iou = apply_occ3d_crops(
                occupied(outr["sdf_r"]).astype(np.int32))
            gt_raw = np.asarray(occ3d_targets["semantics"]).copy()
            masks = np.asarray(occ3d_targets["mask_camera"]).astype(bool)
            gt_raw[gt_raw == 17] = 0
            gt_occ_iou = (gt_raw > 0).astype(np.int32)
            iou_metric._after_step(pred_occ_iou, gt_occ_iou,
                                   masks if args.use_mask else None)
            pred_occ_miou = None
            if miou_metric is not None and "sem_r" in outr:
                pred_occ_miou = pred_occ_iou * sem_remap(outr["sem_r"])
                miou_metric._after_step(pred_occ_miou, gt_raw,
                                        masks if args.use_mask else None)
        elif not args.occ3d and "openocc_label_path" in item:
            out = evaluator.query_grid(
                volume, tuple(pcr), args.resolution,
                keys=("sdf", "sem") if miou_metric is not None
                else ("sdf",))
            t_query += time.perf_counter() - t1
            pred_occ_iou = apply_openocc_crops(
                occupied(out["sdf"]).astype(np.int32))
            # the OpenOccupancy label frame is fixed (512x512x40 in the
            # reference, eval_iou.py:262): a prediction of another shape
            # would drop labels, so it is an error
            oshape = tuple(args.openocc_grid)
            if pred_occ_iou.shape != oshape:
                raise SystemExit(
                    f"OpenOccupancy eval needs a {oshape} prediction grid "
                    f"(got {pred_occ_iou.shape}); use --resolution 0.2 with "
                    f"the matching --scene-size AABB (or --openocc-grid)")
            coords, gt_cls = read_openoccupancy_label(
                item["openocc_label_path"])
            gt_occ_iou = openocc_gt_grid(coords, shape=oshape)
            iou_metric._after_step(pred_occ_iou, gt_occ_iou, None)
            pred_occ_miou = None
            if miou_metric is not None:
                pred_occ_miou = pred_occ_iou * sem_remap(out["sem"])
                if gt_cls is not None:
                    # the class column scattered into the label frame (the
                    # JAX driver's fix of the reference's coordinates-as-
                    # labels sem path, eval_iou.py:41, :266-270)
                    miou_metric._after_step(
                        pred_occ_miou,
                        openocc_gt_grid(coords, shape=oshape, cls=gt_cls),
                        None)
                else:
                    logger.warning(
                        "OpenOccupancy label file has no class column; "
                        "binary IoU only (sem predictions still saved "
                        "with --save-sem)")
        elif hasattr(ds, "gt_occupancy"):
            sdf = evaluator.query_grid(volume, tuple(pcr), args.resolution,
                                       keys=("sdf",))["sdf"]
            t_query += time.perf_counter() - t1
            occ = occupied(sdf)
            gt = ds.gt_occupancy(pcr, args.resolution)
            synth_iou._after_step(occ.astype(np.float32),
                                  np.stack(np.nonzero(gt), -1))
            used_synth = True
            pred_occ_iou, pred_occ_miou = occ, None
        else:
            logger.warning(f"[{i}] no GT labels available; skipping score")
            continue
        logger.info(f"[{i + 1}/{n}] occupied {pred_occ_iou.mean() * 100:.1f}%")

        if args.save_sem and pred_occ_miou is not None:
            token = str(item.get("token", f"{i:06d}"))
            save_path = os.path.join(args.save_sem, token)
            os.makedirs(save_path, exist_ok=True)
            np.savez_compressed(os.path.join(save_path, "labels.npz"),
                                semantics=pred_occ_miou.astype(np.uint8))

    res = {"prepare_s": t_prep, "query_s": t_query, "iou_metric": iou_metric,
           "miou_metric": miou_metric, "synth_iou": synth_iou}
    if used_synth:
        res["iou"] = synth_iou._after_epoch(logger=logger)
        logger.info(f"Final IoU: {res['iou']:.2f}")
    else:
        res["iou_miou"], res["iou_iou"] = iou_metric._after_epoch(
            logger=logger)
        logger.info(f"iou_miou: {res['iou_miou']:.4f}, iou_iou: "
                    f"{res['iou_iou']:.4f}")
        if miou_metric is not None:
            res["miou_miou"], res["miou_iou"] = miou_metric._after_epoch(
                logger=logger)
            logger.info(f"miou_miou: {res['miou_miou']:.4f}, miou_iou: "
                        f"{res['miou_iou']:.4f}")
    logger.info(f"prepare {t_prep:.3f}s, grid queries {t_query:.3f}s")
    return res


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    ds = get_dataset(cfg, args.synthetic, phase="val")
    logger = get_logger()
    model = build_model(cfg, args.seed, device)
    load_weights(model, args.ckpt_path, args.torch_ckpt, logger)
    return evaluate(cfg, model, ds, device, args, logger)


if __name__ == "__main__":
    main()
