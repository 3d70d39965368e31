"""2D visualization driver on the PyTorch port — counterpart of the
repository's ``vis_pics.py``: per camera a magma-coloured inverse-depth map
and the rendered RGB of the prepared field, optionally from an offset pose
(``--novel-view dx dy dz yaw_deg``; reference ``vis_pics.py:56-63, 111,
208-245``).

    python -m selfocc_tpu_torch.vis_pics --py-config nuscenes_occ \
        [--synthetic] [--novel-view 1.0 0.5 0.3 10] [--num-samples 1] \
        [--work-dir DIR] [--device cpu]

Each frame: prepare -> the eval matrices (``eval_trans_mats``), offset by
``apply_novel_view`` -> the fixed eval ray grid -> a chunked render of
depth and RGB (every channel of the volume is sampled: the render is not
geo-only) -> ``<work-dir>/depth_{i:03d}_cam{c}.png`` and
``rgb_{i:03d}_cam{c}.png``. The depth colours come from the port's own
magma table (``utils/magma``), so no matplotlib is needed. The RGB is
written as the JAX driver writes it, scaled by 256 * 255 and clipped
(``vis_pics.py:86``). Data: the config's val split, or ``--synthetic``;
weights: seeded (``--seed``), ``--ckpt-path`` or ``--torch-ckpt``. Runs on
the first CUDA device unless ``--device cpu``; with no card and no
``--device cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .configs.experiments import get_config
from .eval_depth import build_model
from .geometry.projection import apply_novel_view
from .utils.eval_lib import (ChunkedRenderer, camera_kwargs, eval_ray_grid,
                             eval_trans_mats, rays_for_cams)
from .utils.magma import magma
from .utils.runtime import (add_device_arg, add_weights_args, get_dataset,
                            get_logger, load_weights, resolve_device,
                            to_device)


def save_depth_map(depth, path, max_depth=None):
    """Magma-coloured inverse-depth image (reference ``vis_pics.py:56-63``),
    the JAX driver's ``save_depth_map`` with the port's magma table."""
    import cv2
    disp = 1.0 / np.maximum(depth, 1e-3)
    if max_depth is not None:
        disp = np.clip(disp, 1.0 / max_depth, None)
    disp = (disp - disp.min()) / max(disp.max() - disp.min(), 1e-9)
    rgb = (magma(disp) * 255).astype(np.uint8)
    cv2.imwrite(path, rgb[..., ::-1])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--work-dir", default="work_dirs/vis_pics")
    add_weights_args(ap)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=1)
    ap.add_argument("--novel-view", type=float, nargs=4, default=None,
                    help="dx dy dz yaw_deg pose offset")
    ap.add_argument("--max-depth", type=float, default=80.0)
    ap.add_argument("--seed", type=int, default=42)
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the seconds of the prepares, renders and PNG writes, the
    rays rendered and the last frame's (N_cams, H, W) depth and
    (N_cams, H, W, 3) RGB."""
    import cv2
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    ds = get_dataset(cfg, args.synthetic, phase="val")
    logger = get_logger(args.work_dir)
    os.makedirs(args.work_dir, exist_ok=True)
    model = build_model(cfg, args.seed, device)
    load_weights(model, args.ckpt_path, args.torch_ckpt, logger)
    renderer = ChunkedRenderer(model, chunk=args.batch,
                               outputs=("depth", "rgb"))
    rays = eval_ray_grid(cfg, device=device)
    rh, rw = cfg.eval_num_rays
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    res = {"prepare_s": 0.0, "render_s": 0.0, "write_s": 0.0, "rays": 0}
    for i in range(min(args.num_samples, len(ds))):
        batch = to_device(ds[i], device)
        sync()
        t0 = time.perf_counter()
        volume = renderer.prepare(batch["imgs"], batch["lidar2img"],
                                  **camera_kwargs(cfg, batch))
        sync()
        t1 = time.perf_counter()
        i2l = eval_trans_mats(batch, cfg)
        if args.novel_view is not None:
            i2l = apply_novel_view(i2l, args.novel_view)
        origin, direction = rays_for_cams(i2l, rays)
        out = renderer.render(volume, origin, direction)
        t2 = time.perf_counter()
        depth = out["depth"].reshape(cfg.num_cams, rh, rw)
        rgb = out["rgb"].reshape(cfg.num_cams, rh, rw, -1)
        for c in range(cfg.num_cams):
            save_depth_map(depth[c],
                           f"{args.work_dir}/depth_{i:03d}_cam{c}.png",
                           args.max_depth)
            if rgb.shape[-1] == 3:
                img = np.clip(np.asarray(rgb[c]) * 256 * 255, 0, 255)
                cv2.imwrite(f"{args.work_dir}/rgb_{i:03d}_cam{c}.png",
                            img.astype(np.uint8)[..., ::-1])
        res["prepare_s"] += t1 - t0
        res["render_s"] += t2 - t1
        res["write_s"] += time.perf_counter() - t2
        res["rays"] += origin.shape[0]
        res["last_depth"], res["last_rgb"] = depth, rgb
        logger.info(f"[{i}] wrote {cfg.num_cams} depth/rgb maps")
    logger.info(f"{res['rays']} rays: prepare {res['prepare_s']:.3f}s, "
                f"render {res['render_s']:.3f}s, PNGs {res['write_s']:.3f}s")
    return res


if __name__ == "__main__":
    main()
