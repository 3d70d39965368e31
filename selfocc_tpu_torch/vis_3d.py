"""3D occupancy visualization on the PyTorch port — counterpart of the
repository's ``vis_3d.py`` (the reference renders voxels with mayavi
behind a virtual X display, ``vis_3d.py:1-12``): per frame the thresholded
occupancy of the uniform grid over the head's ``roi_aabb`` as (a) ``.npy``
grids, (b) coloured point-cloud ``.ply`` files loadable in any viewer, and
(c) with ``--png`` matplotlib top-down / side projections.

    python -m selfocc_tpu_torch.vis_3d --py-config nuscenes_occ \
        [--synthetic] [--resolution 0.4] [--sem] [--gt] [--png] \
        [--work-dir DIR] [--device cpu]

Each frame runs ``TPVSegmentor.forward_occ`` under ``torch.no_grad()``
(prepare, then the values-only query of every channel at each grid point;
``nuscenes_occ`` at 0.4 m: 200 x 200 x 16 points) and writes
``occ_{i:03d}.npy`` (occupancy: sdf <= ``--thresh``), ``occ_{i:03d}.ply``
(coloured by class with ``--sem``, else by height) and with ``--sem``
``sem_{i:03d}.npy``. ``--gt`` also exports the ground truth beside it
(``export_gt``). ``--png`` needs matplotlib: without it the driver exits
non-zero, naming it, before any work. Data: the config's val split, or
``--synthetic``; weights: seeded (``--seed``), ``--ckpt-path`` or
``--torch-ckpt``. Runs on the first CUDA device unless ``--device cpu``;
with no card and no ``--device cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .configs.experiments import get_config
from .eval_depth import build_model
from .utils.eval_lib import camera_kwargs
from .utils.runtime import (add_device_arg, add_weights_args, get_dataset,
                            get_logger, load_weights, resolve_device,
                            to_device)

# nuScenes 17-class colormap (RGB), matching the reference's vis palette
NUSC_COLORS = np.array([
    [0, 0, 0], [112, 128, 144], [220, 20, 60], [255, 127, 80],
    [255, 158, 0], [233, 150, 70], [255, 61, 99], [0, 0, 230],
    [47, 79, 79], [255, 140, 0], [255, 99, 71], [0, 207, 191],
    [175, 0, 75], [75, 0, 75], [112, 180, 60], [222, 184, 135],
    [0, 175, 0]], dtype=np.uint8)

# SemanticKITTI 20-class palette (remapped label space), standard colors
SEMKITTI_COLORS = np.array([
    [0, 0, 0], [100, 150, 245], [100, 230, 245], [30, 60, 150],
    [80, 30, 180], [100, 80, 250], [255, 30, 30], [255, 40, 200],
    [150, 30, 90], [255, 0, 255], [255, 150, 255], [75, 0, 75],
    [175, 0, 75], [255, 200, 0], [255, 120, 50], [0, 175, 0],
    [135, 60, 0], [150, 240, 80], [255, 240, 150], [255, 0, 0]],
    dtype=np.uint8)


def export_gt(args, ds, i, item, out, aabb, logger):
    """GT voxel export next to the prediction (reference ``vis_3d.py:663``
    mode 2 draws the GT labels): Occ3D ``labels.npz`` (ego 200x200x16 grid,
    17 = free), SemanticKITTI ``.label/.invalid`` voxels (256x256x32, 0.2 m),
    or the synthetic dataset's procedural grid. Writes ``gt_{i}.npy`` (label
    grid) + ``gt_{i}.ply`` (colored points). ``out``: the frame's
    ``forward_occ`` outputs as host arrays."""
    gt_pts = gt_colors = gt_grid = None
    occ3d = None
    if isinstance(item, dict) and "occ3d_label_path" in item:
        data = np.load(item["occ3d_label_path"])
        occ3d = np.asarray(data["semantics"])
    elif hasattr(ds, "occ3d_labels"):
        occ3d = np.asarray(ds.occ3d_labels(i)["semantics"])
    if occ3d is not None:
        # Occ3D ego grid: linspace(-40,40,200)^2 x linspace(-1,5.4,16)
        # (reference eval_iou.py:151-164)
        xs = np.linspace(-40.0, 40.0, 200)
        zs = np.linspace(-1.0, 5.4, 16)
        grid = np.stack(np.meshgrid(xs, xs, zs, indexing="ij"), -1)
        occ = occ3d != 17
        gt_grid, gt_pts = occ3d, grid[occ]
        gt_colors = NUSC_COLORS[np.clip(occ3d[occ], 0,
                                        len(NUSC_COLORS) - 1)]
    elif args.kitti_root and isinstance(item, dict) and "token" in item:
        from .data.semantic_kitti_io import read_semantic_kitti_voxels
        label_path = os.path.join(
            args.kitti_root, "dataset/sequences", str(item.get("sequence")),
            "voxels", f"{item['token']}.label")
        gt_raw = read_semantic_kitti_voxels(
            label_path, label_path.replace(".label", ".invalid"))
        gt_raw = np.flip(gt_raw, 1)            # reference eval_iou_kitti:174
        gt = gt_raw.copy()
        gt[gt == 255] = 0
        # grid -> metric (0.2 m voxels over the fixed front AABB,
        # eval_iou_kitti.py KITTI_AABB)
        h, w, d = np.nonzero(gt)
        gt_pts = np.stack([-25.6 + 0.2 * w, 0.0 + 0.2 * h, -2.0 + 0.2 * d],
                          -1)
        gt_colors = SEMKITTI_COLORS[
            np.clip(gt[h, w, d].astype(int), 0, len(SEMKITTI_COLORS) - 1)]
        gt_grid = gt_raw
    elif hasattr(ds, "gt_occupancy"):
        gt = np.asarray(ds.gt_occupancy(list(aabb),
                                        args.resolution)).astype(bool)
        xyz = np.asarray(out["xyz"])
        gt = gt[:xyz.shape[0], :xyz.shape[1], :xyz.shape[2]]
        gt_pts = xyz[:gt.shape[0], :gt.shape[1], :gt.shape[2]][gt]
        z = gt_pts[:, 2]
        zn = (z - z.min()) / max(z.max() - z.min(), 1e-9) if len(z) else z
        gt_colors = (np.stack([zn, 1 - zn, np.full_like(zn, 0.5)], -1)
                     * 255).astype(np.uint8)
        gt_grid = gt.astype(np.uint8)
    if gt_pts is None:
        logger.warning(f"[{i}] --gt: no GT labels available for this sample")
        return
    np.save(f"{args.work_dir}/gt_{i:03d}.npy", gt_grid)
    write_ply(f"{args.work_dir}/gt_{i:03d}.ply", gt_pts, gt_colors)
    logger.info(f"[{i}] {len(gt_pts)} GT voxels exported")


def write_ply(path, xyz, rgb):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.3f} {p[1]:.3f} {p[2]:.3f} {c[0]} {c[1]} {c[2]}\n")


def height_colors(pts):
    """Colours of points by height (``vis_3d.py:164-167``): green at the
    lowest, red at the highest."""
    z = pts[:, 2]
    zn = (z - z.min()) / max(z.max() - z.min(), 1e-9) if len(z) else z
    return (np.stack([zn, 1 - zn, np.full_like(zn, 0.5)], -1)
            * 255).astype(np.uint8)


def pyplot():
    """matplotlib's pyplot on the Agg backend, for ``--png``; exits
    non-zero, naming matplotlib, where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit("vis_3d --png needs matplotlib, which is not "
                         "installed; run without --png (the .npy and .ply "
                         "files need none)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def occ_on_host(model, batch, cfg, aabb, resolution):
    """One frame's ``forward_occ`` on the model's device -> host arrays
    (``sdf``, ``xyz`` and, with semantics, ``logits`` and ``sem``)."""
    import torch
    with torch.no_grad():
        out = model.forward_occ(batch["imgs"], batch["lidar2img"],
                                aabb=tuple(aabb), resolution=resolution,
                                **camera_kwargs(cfg, batch))
    return {k: v.cpu().numpy() for k, v in out.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--work-dir", default="work_dirs/vis_3d")
    add_weights_args(ap)
    ap.add_argument("--resolution", type=float, default=0.4)
    ap.add_argument("--thresh", type=float, default=0.0)
    ap.add_argument("--sem", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=1)
    ap.add_argument("--png", action="store_true",
                    help="also write matplotlib projection images")
    ap.add_argument("--gt", action="store_true",
                    help="also export the GT voxel labels (reference "
                         "vis_3d.py mode 2): Occ3D labels.npz / "
                         "SemanticKITTI voxels / synthetic grid -> "
                         "gt_{i}.npy + gt_{i}.ply beside the predictions")
    ap.add_argument("--kitti-root", default="",
                    help="SemanticKITTI root for --gt label lookup")
    ap.add_argument("--seed", type=int, default=42)
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Returns per frame the occupied voxel count, and the seconds of the
    ``forward_occ`` calls (with their host copies) and of the writes; and
    the last frame's host outputs (``last``)."""
    args = parse_args(argv)
    plt = pyplot() if args.png else None
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    ds = get_dataset(cfg, args.synthetic, phase="val")
    logger = get_logger(args.work_dir)
    os.makedirs(args.work_dir, exist_ok=True)
    model = build_model(cfg, args.seed, device)
    load_weights(model, args.ckpt_path, args.torch_ckpt, logger)
    aabb = list(cfg.model.head.roi_aabb)
    res = {"voxels": [], "occ_s": 0.0, "write_s": 0.0}
    for i in range(min(args.num_samples, len(ds))):
        item = ds[i]
        t0 = time.perf_counter()
        out = occ_on_host(model, to_device(item, device), cfg, aabb,
                          args.resolution)
        t1 = time.perf_counter()
        occ = out["sdf"] <= args.thresh
        np.save(f"{args.work_dir}/occ_{i:03d}.npy", occ)
        pts = out["xyz"][occ]
        if args.sem and "sem" in out:
            colors = NUSC_COLORS[np.clip(out["sem"][occ], 0,
                                         len(NUSC_COLORS) - 1)]
            np.save(f"{args.work_dir}/sem_{i:03d}.npy", out["sem"])
        else:
            colors = height_colors(pts)
        write_ply(f"{args.work_dir}/occ_{i:03d}.ply", pts, colors)
        if plt is not None:
            fig, axes = plt.subplots(1, 2, figsize=(12, 6))
            axes[0].scatter(pts[:, 0], pts[:, 1], s=0.5,
                            c=colors / 255.0)
            axes[0].set_title("top-down")
            axes[1].scatter(pts[:, 0], pts[:, 2], s=0.5, c=colors / 255.0)
            axes[1].set_title("side")
            fig.savefig(f"{args.work_dir}/occ_{i:03d}.png", dpi=120)
            plt.close(fig)
        logger.info(f"[{i}] {occ.sum()} occupied voxels exported")
        if args.gt:
            export_gt(args, ds, i, item, out, aabb, logger)
        res["occ_s"] += t1 - t0
        res["write_s"] += time.perf_counter() - t1
        res["voxels"].append(int(occ.sum()))
        res["last"] = out
    return res


if __name__ == "__main__":
    main()
