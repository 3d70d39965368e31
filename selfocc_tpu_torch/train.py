"""Training driver on the PyTorch port — counterpart of the repository's
``train.py`` (its single-device path, ``train.py:185-329``).

    python -m selfocc_tpu_torch.train --py-config nuscenes_occ \\
        [--synthetic] [--max-steps N] [--epochs N] [--device cpu] \\
        [--work-dir DIR] [--ckpt-freq-iters N] \\
        [--resume-from CKPT [--iter-resume]] [--resnet-pth PTH]

Data: the nuScenes train split (``data.build_dataset(cfg, "train")``:
``data/nuscenes_infos_train_sweeps.pkl``, images and sweeps under
``data/nuscenes/``); without it the driver exits non-zero, naming the
missing path. ``--synthetic``: the procedural scene. Each epoch's order
comes from ``DistributedSampler(len(ds), 1, 0, shuffle=True, seed)``;
``BatchPrefetcher`` builds the next ``--prefetch`` host batches (JPEG
decode, augmentation) in a worker thread while the card runs the step
(``--prefetch 0``: in the loop). Python's and numpy's global generators are
seeded from (seed, epoch, position) before each item is built, so an item
is the same whichever run builds it.

Weights are drawn from seeded initialisers that mirror the JAX package's
(``--seed``); ``--resnet-pth`` loads torchvision's ImageNet ResNet-50 into
the backbone (the default path is read only where it exists; another path
that does not exist is an error). The random draws of each step (dropout,
the cellular ray grid, the stratified jitter, the random background) come
from a ``torch.Generator`` seeded with ``seed + step``. Steps are not
synchronised with the card: every ``--print-freq`` steps it logs the item,
the loss dict, ``grad_norm``, ``lr`` (reading them waits for the step) and
the host seconds the step took to dispatch, which are not its device time.

Checkpoints (``utils/checkpoint.py``) go to ``<work-dir>/ckpts/``:
``epoch_<e>.pt`` at the end of every epoch, ``iter_<n>.pt`` every
``--ckpt-freq-iters`` steps, ``final.pt`` where ``--max-steps`` ends a run,
each also as ``latest.pt``; each records the epoch and the items of it
already trained on. ``--resume-from`` (a file, or a work dir holding
``ckpts/latest.pt``) continues the weights, the optimizer and the step
count; with ``--iter-resume`` it also skips the items of the epoch already
trained on (the reference's iteration resume), without it the epoch starts
again from its first item. Runs on the first CUDA device unless ``--device
cpu`` asks for the kernels' plain versions on the CPU; with no card and no
``--device cpu`` it exits non-zero. ``--dp``, ``--mp``,
``--teacher-ckpt``, ``--amp``, ``--profile``, ``--eval-every-epoch`` and
gradient accumulation come with later slices.
"""
from __future__ import annotations

import argparse
import os
import random
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .configs.experiments import get_config
from .data.prefetch import BatchPrefetcher
from .data.sampler import DistributedSampler
from .models.initializers import init_weights
from .models.segmentor import TPVSegmentor
from .utils.checkpoint import load_torch_resnet50, save_checkpoint
from .utils.runtime import (add_device_arg, checkpoint_path, get_dataset,
                            get_logger, resolve_device, to_device)
from .utils.train_lib import Trainer

RESNET_PTH = "ckpts/resnet50-0676ba61.pth"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--work-dir", default="work_dirs/torch_run")
    ap.add_argument("--resume-from", default="")
    ap.add_argument("--iter-resume", action="store_true",
                    help="on --resume-from, skip the items of the epoch "
                         "that the checkpoint had trained on")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after this many optimizer steps (0: epochs)")
    ap.add_argument("--epochs", type=int, default=0,
                    help="override the config's max_epochs")
    ap.add_argument("--print-freq", type=int, default=50)
    ap.add_argument("--ckpt-freq-iters", type=int, default=0,
                    help="save an iteration checkpoint every N steps "
                         "(0: off)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="host batches built ahead in a worker thread "
                         "(0: in the loop)")
    ap.add_argument("--resnet-pth", default=RESNET_PTH,
                    help="torchvision ResNet-50 weights for the backbone")
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


def host_batch(ds, index: int, seed: int, epoch: int, pos: int) -> Dict:
    """Item ``index`` of ``ds`` as host arrays (labels and tokens dropped),
    built after seeding Python's and numpy's global generators from
    (seed, epoch, position): the dataset's augmentation draws from them."""
    s = (seed * 1_000_003 + epoch * 100_003 + pos) % 2**32
    random.seed(s)
    np.random.seed(s)
    return {k: np.asarray(v) for k, v in ds[index].items()
            if not isinstance(v, (str, dict))}


def train(cfg, trainer: Trainer, ds, device, max_steps: int, seed: int,
          print_freq: int, logger, epochs: int = 0, start_epoch: int = 0,
          start_pos: int = 0, prefetch: int = 0,
          checkpoint: Optional[Callable[[str, int, int], None]] = None,
          ckpt_freq_iters: int = 0) -> Dict:
    """Steps over ``ds`` from item ``start_pos`` of epoch ``start_epoch``,
    in the sampler's order, up to ``max_steps`` optimizer steps in all (0:
    no limit) or the end of epoch ``epochs`` (0: ``cfg.max_epochs``).
    ``checkpoint(name, epoch, position)`` is called every
    ``ckpt_freq_iters`` steps, at each epoch's end and where ``max_steps``
    ends the run. Returns the last step's ``metrics``, the ``items`` trained
    on, the logged steps' scalars (``logged``: step -> losses,
    ``grad_norm``, ``lr``), and per step the host seconds spent waiting for
    its batch (``data_wait_s``) and from that wait's start to the step's
    end (``step_s``: the step's time where it is logged, since reading the
    losses waits for the card; else its host dispatch)."""
    sampler = DistributedSampler(len(ds), 1, 0, shuffle=True, seed=seed)
    res = {"metrics": None, "items": [], "logged": {}, "data_wait_s": [],
           "step_s": []}
    if max_steps and trainer.global_step >= max_steps:
        return res
    for epoch in range(start_epoch, epochs or cfg.max_epochs):
        sampler.set_epoch(epoch)
        offset = start_pos if epoch == start_epoch else 0
        sampler.set_last_iter(offset)
        order = list(iter(sampler))

        def build(job):
            pos, index = job
            return host_batch(ds, index, seed, epoch, pos)

        jobs = list(enumerate(order, offset))
        batches = (BatchPrefetcher(build, jobs, depth=prefetch)
                   if prefetch > 0 else map(build, jobs))
        pos, done = offset, False
        try:
            t_wait = time.perf_counter()
            for (pos, index), host in zip(jobs, batches):
                step = trainer.global_step
                res["data_wait_s"].append(time.perf_counter() - t_wait)
                batch = to_device(host, device)
                gen = torch.Generator(device=device).manual_seed(seed + step)
                t0 = time.perf_counter()
                metrics = trainer.step(batch, gen)
                dispatch_s = time.perf_counter() - t0
                res["metrics"] = metrics
                res["items"].append(index)
                pos += 1
                done = bool(max_steps) and trainer.global_step >= max_steps
                if step % print_freq == 0 or done:
                    res["logged"][step] = {k: float(v) for k, v in
                                           metrics.items() if k != "times"}
                    logger.info(f"[e{epoch} i{step}] item {index}: "
                                f"{format_metrics(metrics)} (host dispatch "
                                f"{dispatch_s:.3f}s)")
                res["step_s"].append(time.perf_counter() - t_wait)
                if (checkpoint is not None and ckpt_freq_iters
                        and trainer.global_step % ckpt_freq_iters == 0):
                    checkpoint(f"iter_{trainer.global_step}", epoch, pos)
                if done:
                    break
                t_wait = time.perf_counter()
        finally:
            if hasattr(batches, "close"):
                batches.close()       # stop the worker on an early exit
        if done and pos < len(ds):
            if checkpoint is not None:
                checkpoint("final", epoch, pos)
            return res
        if checkpoint is not None:
            checkpoint(f"epoch_{epoch + 1}", epoch + 1, 0)
        if done:
            return res
    return res


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    ds = get_dataset(cfg, args.synthetic, phase="train")
    logger = get_logger()
    logger.info(f"config {cfg.name} on {device}; {len(ds)} items")
    resnet_pth = args.resnet_pth if cfg.model.backbone_type == "resnet50" \
        and args.resnet_pth and os.path.exists(args.resnet_pth) else ""
    if not resnet_pth and args.resnet_pth not in ("", RESNET_PTH) and \
            not os.path.exists(args.resnet_pth):
        sys.exit(f"selfocc_tpu_torch: --resnet-pth {args.resnet_pth!r} "
                 "not found")
    trainer = build_trainer(cfg, args.seed, device)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info(f"params: {n_params / 1e6:.2f}M")
    if resnet_pth:
        n = load_torch_resnet50(trainer.model, resnet_pth)
        logger.info(f"backbone: {n} tensors from {resnet_pth}")
    start_epoch, start_pos = 0, 0
    if args.resume_from:
        path = checkpoint_path(args.resume_from)
        state = torch.load(path, map_location=device)
        trainer.load_state_dict(state)
        start_epoch = int(state.get("epoch", 0))
        if args.iter_resume:
            start_pos = int(state.get("last_iter", 0))
        logger.info(f"resumed from {path} at step {trainer.global_step}, "
                    f"epoch {start_epoch}, item {start_pos} of the epoch")
    ckpt_dir = os.path.join(args.work_dir, "ckpts")

    def checkpoint(name, epoch, pos):
        path = save_checkpoint(ckpt_dir, name, dict(
            trainer.state_dict(), epoch=epoch, last_iter=pos))
        logger.info(f"step {trainer.global_step}: checkpoint saved at "
                    f"{path} (epoch {epoch}, item {pos})")

    return train(cfg, trainer, ds, device, args.max_steps, args.seed,
                 args.print_freq, logger, epochs=args.epochs,
                 start_epoch=start_epoch, start_pos=start_pos,
                 prefetch=args.prefetch, checkpoint=checkpoint,
                 ckpt_freq_iters=args.ckpt_freq_iters)


if __name__ == "__main__":
    main()
