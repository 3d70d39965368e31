"""Rendered-depth evaluation driver on the PyTorch port — counterpart of the
repository's ``eval_depth.py`` (prepare -> chunked 450x800-per-camera ray
render -> bilinear lookup of the predicted depth at the sparse GT pixels ->
``DepthMetric`` raw / median-scaled tables).

    python -m selfocc_tpu_torch.eval_depth --py-config nuscenes_occ \
        --synthetic --num-samples 1

Weights are drawn from seeded initialisers that mirror the JAX package's
(``--seed``); checkpoint loading, flip test-time augmentation and the
argmax-weight depth target come with later slices. Runs on the first CUDA
device when there is one (kernels built on first use), else on the CPU with
the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict

import numpy as np
import torch

from selfocc_tpu.configs.experiments import get_config
from selfocc_tpu.utils.metrics import _DEPTH_KEYS, DepthMetric

from .models.initializers import init_weights
from .models.segmentor import TPVSegmentor
from .ops.interp import bilinear_sample
from .utils.eval_lib import (ChunkedRenderer, eval_ray_grid, eval_trans_mats,
                             rays_for_cams)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--batch", type=int, default=32768,
                    help="rays per render chunk")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
    return ap.parse_args(argv)


def get_dataset(cfg, synthetic: bool):
    """Real val split when its data is on disk, else the synthetic scene
    (the JAX driver's fallback, ``train.py:114-135``)."""
    from selfocc_tpu.data.synthetic import SyntheticDataset
    if not synthetic:
        try:
            from selfocc_tpu.data import build_dataset
            ds = build_dataset(cfg, phase="val")
            if ds is not None:
                return ds
        except (ImportError, FileNotFoundError):
            pass
    n_sem = max(cfg.num_classes, cfg.model.head.sem_dims or 0)
    return SyntheticDataset(
        num_cams=cfg.num_cams, input_size=cfg.input_size,
        img_size=cfg.img_size, num_classes=n_sem, length=64)


def build_model(cfg, seed: int, device) -> TPVSegmentor:
    """The port's segmentor with seeded JAX-like initial weights, eval mode."""
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def to_device(item, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in item.items() if not isinstance(v, (str, dict))}


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


def reduce_depth_metric(metric: DepthMetric, logger) -> Dict[str, np.ndarray]:
    """``DepthMetric._after_epoch`` for one process (that method reduces
    across JAX processes)."""
    count = max(metric.count, 1)
    out = {k: metric.sums[k] / count for k in _DEPTH_KEYS}
    out["scaling"] = metric.scaling / count
    logger.info(f"Averaging over {int(metric.count)} samples.")
    for ti, t in enumerate(metric.eval_types):
        logger.info(f"{t} evaluation:")
        logger.info(("{:>12} | " * 9).format("cam_name", *_DEPTH_KEYS,
                                              "scale"))
        for cam, name in enumerate(metric.camera_names):
            vals = [out[k][ti, cam] for k in _DEPTH_KEYS]
            vals.append(out["scaling"][ti, cam])
            logger.info((f"{name:>12} | " + "&{: 12.3f}  " * 8).format(*vals))
        vals = [out[k][ti].mean() for k in _DEPTH_KEYS]
        vals.append(out["scaling"][ti].mean())
        logger.info(("{:>12} | " + "&{: 12.3f}  " * 8).format("All", *vals))
    return out


def get_logger() -> logging.Logger:
    logger = logging.getLogger("selfocc_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(h)
    return logger


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
    table = reduce_depth_metric(metric, logger)
    return {"metric": table, "prepare_s": t_prep, "render_s": t_render,
            "rays": total_rays, "last_depth": depth}


def main(argv=None):
    args = parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        # the exact tier is fp32: no TF32 in convolutions or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.py_config)
    logger = get_logger()
    model = build_model(cfg, args.seed, device)
    ds = get_dataset(cfg, args.synthetic)
    return evaluate(cfg, model, ds, device, args.num_samples, args.batch,
                    logger)


if __name__ == "__main__":
    main()
