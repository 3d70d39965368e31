"""Training driver on the PyTorch port — counterpart of the repository's
``train.py`` (its single-device path, ``train.py:138-337``).

    python -m selfocc_tpu_torch.train --py-config nuscenes_occ --synthetic \\
        --max-steps 3 [--device cpu] [--work-dir DIR] [--resume-from CKPT]

Weights are drawn from seeded initialisers that mirror the JAX package's
(``--seed``); the random draws of each step (dropout, the cellular ray grid,
the stratified jitter, the random background) come from a
``torch.Generator`` seeded with ``seed + step``. Steps are not
synchronised with the card: every ``--print-freq`` steps it logs the loss
dict, ``grad_norm``, ``lr`` (reading them waits for the step) and the host
seconds the step took to dispatch, which are not its device time. At the
end it saves ``model``, ``optimizer`` and ``step`` with ``torch.save`` to
``<work-dir>/ckpts/latest.pt``; ``--resume-from`` (a file, or a work dir
holding one) continues from there. Runs on the first CUDA device unless
``--device cpu`` asks for the kernels' plain versions on the CPU; with no
card and no ``--device cpu`` it exits non-zero. The real nuScenes loaders,
``--dp``, ``--mp``, ``--teacher-ckpt``, ``--amp``, ``--profile`` and
``--eval-every-epoch`` come with later slices.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .configs.experiments import get_config
from .models.initializers import init_weights
from .models.segmentor import TPVSegmentor
from .utils.runtime import (add_device_arg, checkpoint_path, get_dataset,
                            get_logger, resolve_device, to_device)
from .utils.train_lib import Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--work-dir", default="work_dirs/torch_run")
    ap.add_argument("--resume-from", default="")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after this many optimizer steps (0: epochs)")
    ap.add_argument("--print-freq", type=int, default=50)
    add_device_arg(ap)
    return ap.parse_args(argv)


def build_trainer(cfg, seed: int, device) -> Trainer:
    """The port's segmentor with seeded JAX-like initial weights on
    ``device``, and its optimizer."""
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return Trainer(cfg, model.to(device))


def format_metrics(metrics) -> str:
    scalars = {k: float(v) for k, v in metrics.items() if k != "times"}
    return ", ".join(f"{k}={v:.6g}" for k, v in sorted(scalars.items()))


def train(cfg, trainer: Trainer, ds, device, max_steps: int, seed: int,
          print_freq: int, logger):
    """Steps over ``ds`` in a seeded shuffled order per epoch, from the
    trainer's step up to ``max_steps`` (0: ``cfg.max_epochs`` epochs).
    Returns the last step's metrics."""
    total = max_steps or cfg.max_epochs * len(ds)
    metrics = None
    while trainer.global_step < total:
        step = trainer.global_step
        epoch, pos = divmod(step, len(ds))
        item = np.random.RandomState(seed + epoch).permutation(len(ds))[pos]
        batch = to_device(ds[int(item)], device)
        gen = torch.Generator(device=device).manual_seed(seed + step)
        t0 = time.perf_counter()
        metrics = trainer.step(batch, gen)
        dispatch_s = time.perf_counter() - t0
        if step % print_freq == 0 or step + 1 == total:
            logger.info(f"[e{epoch} i{step}] {format_metrics(metrics)} "
                        f"(host dispatch {dispatch_s:.3f}s)")
    return metrics


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    ds = get_dataset(cfg, args.synthetic)
    logger = get_logger()
    logger.info(f"config {cfg.name} on {device}")
    trainer = build_trainer(cfg, args.seed, device)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info(f"params: {n_params / 1e6:.2f}M")
    if args.resume_from:
        path = checkpoint_path(args.resume_from)
        trainer.load_state_dict(torch.load(path, map_location=device))
        logger.info(f"resumed from {path} at step {trainer.global_step}")
    metrics = train(cfg, trainer, ds, device, args.max_steps, args.seed,
                    args.print_freq, logger)
    path = os.path.join(args.work_dir, "ckpts", "latest.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(trainer.state_dict(), path)
    logger.info(f"step {trainer.global_step}: checkpoint saved at {path}")
    return metrics


if __name__ == "__main__":
    main()
