"""Rendered-depth evaluation driver on the PyTorch port — counterpart of the
repository's ``eval_depth.py`` (prepare -> chunked 450x800-per-camera ray
render -> bilinear lookup of the predicted depth at the sparse GT pixels ->
``DepthMetric`` raw / median-scaled tables).

    python -m selfocc_tpu_torch.eval_depth --py-config nuscenes_occ \
        --synthetic --num-samples 1 [--device cpu]

Weights are drawn from seeded initialisers that mirror the JAX package's
(``--seed``); checkpoint loading, flip test-time augmentation, the
argmax-weight depth target and the real nuScenes loaders come with later
slices (without ``--synthetic`` it stops with an error). Runs on the first
CUDA device (kernels built on first use) unless ``--device cpu`` asks for the
kernels' plain versions on the CPU; with no card and no ``--device cpu`` it
exits non-zero.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from .configs.experiments import get_config
from .models.initializers import init_weights
from .models.segmentor import TPVSegmentor
from .ops.interp import bilinear_sample
from .utils.eval_lib import (ChunkedRenderer, eval_ray_grid, eval_trans_mats,
                             rays_for_cams)
from .utils.metrics import DepthMetric
from .utils.runtime import (add_device_arg, get_dataset, get_logger,
                            resolve_device, to_device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--batch", type=int, default=32768,
                    help="rays per render chunk")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
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
             logger) -> Dict:
    """The eval loop. Returns the metric table and timings (seconds,
    synchronised on the device)."""
    renderer = ChunkedRenderer(model, chunk=chunk, outputs=("depth",))
    rays = eval_ray_grid(cfg, device=device)
    rh, rw = cfg.eval_num_rays
    metric = DepthMetric(camera_names=[f"cam{i}" for i in range(cfg.num_cams)],
                         eval_types=["raw", "median"])
    n = min(num_samples or len(ds), len(ds))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t_prep = t_render = 0.0
    total_rays = 0
    depth = None
    for i in range(n):
        batch = to_device(ds[i], device)
        sync()
        t0 = time.perf_counter()
        volume = renderer.prepare(batch["imgs"], batch["lidar2img"])
        sync()
        t1 = time.perf_counter()
        origin, direction = rays_for_cams(eval_trans_mats(batch, cfg), rays)
        out = renderer.render(volume, origin, direction)
        t2 = time.perf_counter()
        t_prep += t1 - t0
        t_render += t2 - t1
        total_rays += origin.shape[0]
        depth = torch.from_numpy(out["depth"]).reshape(cfg.num_cams, rh, rw)
        if "depth_loc" in batch:
            pred_at = sample_depth_at(depth, batch["depth_loc"].cpu().numpy(),
                                      rh, rw)
            metric._after_step(pred_at, batch["depth_gt"].cpu().numpy(),
                               batch["depth_mask"].cpu().numpy())
        logger.info(f"[{i + 1}/{n}] rendered {origin.shape[0]} rays")
    logger.info(f"total {total_rays} rays: prepare {t_prep:.3f}s, render "
                f"{t_render:.3f}s ({total_rays / max(t_render, 1e-9):.0f} "
                "rays/s)")
    table = metric._after_epoch(logger)
    return {"metric": table, "prepare_s": t_prep, "render_s": t_render,
            "rays": total_rays, "last_depth": depth}


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    ds = get_dataset(cfg, args.synthetic)
    logger = get_logger()
    model = build_model(cfg, args.seed, device)
    return evaluate(cfg, model, ds, device, args.num_samples, args.batch,
                    logger)


if __name__ == "__main__":
    main()
