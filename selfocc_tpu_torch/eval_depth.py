"""Rendered-depth evaluation driver on the PyTorch port — counterpart of the
repository's ``eval_depth.py`` (prepare -> chunked ray render over the
config's eval grid (450x800 per nuScenes camera, 176x608 on KITTI-raw) ->
bilinear lookup of the predicted depth at the sparse GT pixels ->
``DepthMetric`` raw / median-scaled tables).

    python -m selfocc_tpu_torch.eval_depth --py-config nuscenes_occ \
        [--synthetic] --num-samples 1 [--flip] [--depth-metric-tgt max] \
        [--save-depth --work-dir DIR] [--device cpu] [--no-shard]
        [--prepare-shard]

Real data: the config's val split (``data.build_dataset(cfg, "val")``:
nuScenes reads ``data/nuscenes_infos_val_sweeps.pkl`` with images and lidar
sweeps under ``data/nuscenes/``; ``kitti_raw_depth`` reads the eigen split's
``test_files.txt`` with the raw drives under ``data/kitti_raw/``), whose
items carry the lidar depth GT (``depth_loc``, ``depth_gt``,
``depth_mask``; KITTI-raw's within the eigen crop, of a length of their
own per frame); without it the driver exits non-zero, naming the missing
path. ``--synthetic``: the procedural scene.
``--flip``: flip test-time augmentation, a second prepare and render on
the images mirrored along W with the features mirrored back
(``prepare(flip=True)``), the two depths averaged (reference
``eval_depth.py:168-183``). ``--depth-metric-tgt max`` scores the
argmax-weight depth (the head's ``return_max_depth``); ``median`` exits, as
the JAX driver does. ``--save-depth`` writes each frame's (N_cams, H, W)
depth to ``<work-dir>/depth_{i:04d}.npy`` (and with ``max``
``depth_max_{i:04d}.npy``). The run log goes to stdout and
``<work-dir>/<time>.log``.
Weights are drawn from seeded initialisers that mirror the JAX package's
(``--seed``), or loaded from the port's own ``train.py`` checkpoint
(``--ckpt-path``) or a reference-SelfOcc ``.pth`` (``--torch-ckpt``). Runs
on the first CUDA device (kernels built on first use) unless ``--device
cpu`` asks for the kernels' plain versions on the CPU; with no card and no
``--device cpu`` it exits non-zero. On cards the render's chunks split
their rays over every visible card (``utils/eval_lib.ChunkedRenderer``;
the JAX driver's mesh); ``--no-shard`` keeps it on the first,
``--prepare-shard`` also splits the prepare's cameras.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from .configs.experiments import get_config
from .models.initializers import init_weights
from .models.segmentor import TPVSegmentor
from .ops.interp import bilinear_sample
from .utils.eval_lib import (ChunkedRenderer, camera_kwargs, enable_max_depth,
                             eval_ray_grid, eval_trans_mats, rays_for_cams)
from .utils.metrics import DepthMetric
from .utils.runtime import (add_device_arg, add_shard_args, add_weights_args,
                            get_dataset, get_logger, load_weights,
                            resolve_device, shard_devices, to_device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--batch", type=int, default=32768,
                    help="rays per render chunk")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--work-dir", default="work_dirs/eval_depth")
    ap.add_argument("--flip", action="store_true",
                    help="flip test-time augmentation: average the depth "
                         "with a second pass on the images mirrored along W")
    ap.add_argument("--depth-metric-tgt", default="raw",
                    choices=["raw", "median", "max"],
                    help="the scored render: raw (expected depth) or max "
                         "(argmax-weight depth); median exits, as the JAX "
                         "driver does (the reference's median render is "
                         "dead code)")
    ap.add_argument("--save-depth", action="store_true",
                    help="save each frame's (N_cams, H, W) depth map to "
                         "<work-dir>/depth_{i:04d}.npy")
    add_shard_args(ap)
    add_weights_args(ap)
    add_device_arg(ap)
    return ap.parse_args(argv)


def build_model(cfg, seed: int, device) -> TPVSegmentor:
    """The port's segmentor with seeded JAX-like initial weights, eval mode."""
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def sample_depth_at(depth_map: torch.Tensor, loc: np.ndarray, rh: int,
                    rw: int) -> np.ndarray:
    """(N, rh, rw) depth maps sampled at (N, n, 2) [0, 1] GT locations with
    border padding (reference ``metric_util.py:311-322``) -> (N, n)."""
    pix = torch.as_tensor(np.stack([loc[..., 0] * (rw - 1),
                                    loc[..., 1] * (rh - 1)], -1),
                          dtype=torch.float32)
    return np.stack([bilinear_sample(depth_map[c][..., None].cpu(), pix[c],
                                     "border")[..., 0].numpy()
                     for c in range(depth_map.shape[0])])


def evaluate(cfg, model, ds, device, num_samples: int, chunk: int,
             logger, flip: bool = False, tgt: str = "raw",
             save_dir: str = "", devices=None,
             prepare_shard: bool = False) -> Dict:
    """The eval loop. ``flip``: flip-TTA; ``tgt``: the scored render
    (``raw`` or ``max``, the model built with ``return_max_depth``);
    ``save_dir``: where the depth maps go (none when empty); ``devices``,
    ``prepare_shard``: the renderer's sharding. Returns the
    metric table, timings (seconds, synchronised on the device; the flip
    pass's in them) and the last frame's depth maps."""
    outputs = ("depth",) if tgt == "raw" else ("depth", "max_depth")
    renderer = ChunkedRenderer(model, chunk=chunk, outputs=outputs,
                               devices=devices, prepare_shard=prepare_shard)
    rays = eval_ray_grid(cfg, device=device)
    rh, rw = cfg.eval_num_rays
    metric = DepthMetric(camera_names=[f"cam{i}" for i in range(cfg.num_cams)],
                         eval_types=["raw", "median"])
    n = min(num_samples or len(ds), len(ds))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t_prep = t_render = 0.0
    total_rays = 0
    depth = maxd = None

    def maps(out):
        return {k: torch.from_numpy(v).reshape(cfg.num_cams, rh, rw)
                for k, v in out.items()}

    for i in range(n):
        batch = to_device(ds[i], device)
        origin, direction = rays_for_cams(eval_trans_mats(batch, cfg), rays)
        outs = []
        for mirrored in (False, True) if flip else (False,):
            imgs = batch["imgs"].flip(3) if mirrored else batch["imgs"]
            sync()
            t0 = time.perf_counter()
            # the camera parameters stay unmirrored: the flip pass mirrors
            # the features back before the encoder (eval_depth.py:123-129)
            volume = renderer.prepare(imgs, batch["lidar2img"], flip=mirrored,
                                      **camera_kwargs(cfg, batch))
            sync()
            t1 = time.perf_counter()
            outs.append(maps(renderer.render(volume, origin, direction)))
            t_prep += t1 - t0
            t_render += time.perf_counter() - t1
            total_rays += origin.shape[0]
        out = outs[0] if not flip else {
            k: 0.5 * (outs[0][k] + outs[1][k]) for k in outs[0]}
        depth, maxd = out["depth"], out.get("max_depth")
        if save_dir:
            np.save(os.path.join(save_dir, f"depth_{i:04d}.npy"),
                    depth.numpy())
            if maxd is not None:
                np.save(os.path.join(save_dir, f"depth_max_{i:04d}.npy"),
                        maxd.numpy())
        if "depth_loc" in batch:
            score_map = maxd if tgt == "max" else depth
            pred_at = sample_depth_at(score_map,
                                      batch["depth_loc"].cpu().numpy(), rh, rw)
            metric._after_step(pred_at, batch["depth_gt"].cpu().numpy(),
                               batch["depth_mask"].cpu().numpy())
        logger.info(f"[{i + 1}/{n}] rendered {origin.shape[0]} rays"
                    + (" twice (flip)" if flip else ""))
    logger.info(f"total {total_rays} rays: prepare {t_prep:.3f}s, render "
                f"{t_render:.3f}s ({total_rays / max(t_render, 1e-9):.0f} "
                "rays/s)")
    table = metric._after_epoch(logger)
    return {"metric": table, "prepare_s": t_prep, "render_s": t_render,
            "rays": total_rays, "last_depth": depth, "last_max_depth": maxd}


def main(argv=None):
    args = parse_args(argv)
    if args.depth_metric_tgt == "median":
        raise SystemExit("--depth-metric-tgt median: the reference's median "
                         "depth render is dead code (see --help); use raw "
                         "(median-scaled column included) or max")
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    if args.depth_metric_tgt == "max":
        cfg = enable_max_depth(cfg)
    ds = get_dataset(cfg, args.synthetic, phase="val")
    logger = get_logger(args.work_dir)
    model = build_model(cfg, args.seed, device)
    load_weights(model, args.ckpt_path, args.torch_ckpt, logger)
    if args.save_depth:
        os.makedirs(args.work_dir, exist_ok=True)
    return evaluate(cfg, model, ds, device, args.num_samples, args.batch,
                    logger, flip=args.flip, tgt=args.depth_metric_tgt,
                    save_dir=args.work_dir if args.save_depth else "",
                    devices=shard_devices(device, args.no_shard),
                    prepare_shard=args.prepare_shard)


if __name__ == "__main__":
    main()
