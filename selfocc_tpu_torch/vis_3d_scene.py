"""Scene-level 3D occupancy visualization on the PyTorch port — counterpart
of the repository's ``vis_3d_scene.py``: accumulates per-frame occupancy
predictions into one global point cloud using the ego poses, exporting
merged ``scene_points.npy`` / ``scene.ply`` (mayavi-free, see ``vis_3d``).

    python -m selfocc_tpu_torch.vis_3d_scene --py-config nuscenes_occ \
        [--synthetic | --imageset INFOS.pkl --data-path DIR \
        [--scene-token TOKEN]] [--num-samples 8] [--device cpu]

With ``--imageset`` (a file that exists) the driver walks one scene's
keyframes in order through the scene-walk vis dataset
(``data/vis_dataset``: ``nuScenes_Scene_Vis`` + ``VisDatasetWrapper``);
otherwise it reads the config's val split, or ``--synthetic``. Each frame
runs ``TPVSegmentor.forward_occ`` (as ``vis_3d``) and lifts its occupied
voxels into the scene frame by the frame's ``lidar2global`` where the item
has one, else by ``--frame-spacing`` metres along x a frame. Weights:
seeded (``--seed``) or ``--ckpt-path``, as the JAX driver's. Runs on the
first CUDA device unless ``--device cpu``; with no card and no ``--device
cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .configs.experiments import get_config
from .eval_depth import build_model
from .utils.runtime import (add_device_arg, get_dataset, get_logger,
                            host_arrays, load_weights, resolve_device,
                            to_device)
from .vis_3d import NUSC_COLORS, height_colors, occ_on_host, write_ply


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--work-dir", default="work_dirs/vis_3d_scene")
    ap.add_argument("--ckpt-path", default="",
                    help="the port's own train.py checkpoint (a file, or a "
                         "work dir holding ckpts/latest.pt): its model entry")
    ap.add_argument("--resolution", type=float, default=0.4)
    ap.add_argument("--thresh", type=float, default=0.0)
    ap.add_argument("--sem", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=8)
    ap.add_argument("--frame-spacing", type=float, default=2.0,
                    help="synthetic ego displacement per frame")
    ap.add_argument("--seed", type=int, default=42)
    # scene-walk vis dataset (reference *_vis variants): when --imageset
    # exists, walk ONE scene's keyframes via nuScenes_Scene_Vis instead of
    # the training dataset
    ap.add_argument("--imageset", default="",
                    help="nuScenes infos pkl for the scene-walk vis dataset")
    ap.add_argument("--data-path", default="data/nuscenes/")
    ap.add_argument("--scene-token", default=None,
                    help="scene to walk (default: first in the pkl)")
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the occupied voxel count of each frame, the scene cloud's
    point count and the seconds of the ``forward_occ`` calls and of the
    writes."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    logger = get_logger(args.work_dir)
    os.makedirs(args.work_dir, exist_ok=True)
    if args.imageset and os.path.exists(args.imageset):
        from .data.vis_dataset import VisDatasetWrapper, nuScenes_Scene_Vis
        raw = nuScenes_Scene_Vis(
            data_path=args.data_path, imageset=args.imageset,
            scene_token=args.scene_token, crop_size=tuple(cfg.img_size),
            ego_centric=bool(cfg.train_dataset_args.get("ego_centric")),
            num_cams=cfg.num_cams)
        ds = VisDatasetWrapper(raw, cfg)
        logger.info(f"scene-walk vis: scene {raw.scene_token}, "
                    f"{len(ds)} keyframes")
    else:
        ds = get_dataset(cfg, args.synthetic, phase="val")
    model = build_model(cfg, args.seed, device)
    load_weights(model, args.ckpt_path, logger=logger)
    aabb = list(cfg.model.head.roi_aabb)

    res = {"voxels": [], "occ_s": 0.0}
    all_pts, all_colors = [], []
    for i in range(min(args.num_samples, len(ds))):
        item = ds[i]
        t0 = time.perf_counter()
        out = occ_on_host(model, to_device(item, device), cfg, aabb,
                          args.resolution)
        res["occ_s"] += time.perf_counter() - t0
        occ = out["sdf"] <= args.thresh
        pts = out["xyz"][occ]
        # lift frame-local points into the scene frame. Real datasets carry
        # lidar2global chains; the synthetic scene moves the ego along +x.
        host = host_arrays(item)
        if "lidar2global" in host:
            m = host["lidar2global"][0]
            pts = pts @ m[:3, :3].T + m[:3, 3]
        else:
            pts = pts + np.array([args.frame_spacing * i, 0.0, 0.0])
        if args.sem and "sem" in out:
            colors = NUSC_COLORS[np.clip(out["sem"][occ], 0,
                                         len(NUSC_COLORS) - 1)]
        else:
            colors = height_colors(pts)
        all_pts.append(pts)
        all_colors.append(colors)
        res["voxels"].append(int(occ.sum()))
        logger.info(f"[{i}] accumulated {occ.sum()} voxels")

    t0 = time.perf_counter()
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3))
    colors = np.concatenate(all_colors) if all_colors else np.zeros((0, 3),
                                                                    np.uint8)
    np.save(f"{args.work_dir}/scene_points.npy", pts)
    write_ply(f"{args.work_dir}/scene.ply", pts, colors)
    res["write_s"] = time.perf_counter() - t0
    res["points"] = len(pts)
    logger.info(f"scene cloud: {len(pts)} points -> {args.work_dir}/scene.ply")
    return res


if __name__ == "__main__":
    main()
