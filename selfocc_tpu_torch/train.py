"""Training driver on the PyTorch port — counterpart of the repository's
``train.py`` (its single-device path, ``train.py:185-329``).

    python -m selfocc_tpu_torch.train --py-config nuscenes_occ \\
        [--synthetic] [--max-steps N] [--epochs N] [--device cpu] \\
        [--work-dir DIR] [--ckpt-freq-iters N] \\
        [--resume-from CKPT [--iter-resume]] [--resnet-pth PTH] [--amp] \\
        [--gradient-accumulation K] [--profile] \\
        [--eval-every-epoch [--eval-samples N]] [--teacher-ckpt CKPT]

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
the host seconds the step took to dispatch, which are not its device time,
and writes the same scalars as ``loss/<name>`` to
``<work-dir>/scalars.jsonl`` (``utils/logging_util.ScalarWriter``, and to
TensorBoard under ``<work-dir>/tb`` where it imports). The run log goes to
stdout and ``<work-dir>/<time>.log``.

``--gradient-accumulation K``: ``optax.MultiSteps`` semantics
(``utils/train_lib.Trainer``): K micro-steps' gradients are averaged and
the optimizer steps once on the mean; the step counts (``--max-steps``,
``--ckpt-freq-iters``, the model's ``global_iter``, the log's ``i``) count
micro-steps, the LR schedule counts optimizer updates. A checkpoint
carries the running mean, so a resume mid-window continues it.
``--profile``: a ``torch.profiler`` trace (CPU and, on the card, CUDA
activities) of micro-steps 5 to 9 (started before step 5, stopped before
step 10 or at the run's end, as the JAX driver's ``train.py:296-302``),
written as a Chrome trace to ``<work-dir>/profile/trace.json``.
``--eval-every-epoch``: after each epoch's checkpoint (and the one where
``--max-steps`` ends the run) a depth eval of the first
``--eval-samples`` items that carry lidar depth (``run_epoch_eval``).

Checkpoints (``utils/checkpoint.py``) go to ``<work-dir>/ckpts/``:
``epoch_<e>.pt`` at the end of every epoch, ``iter_<n>.pt`` every
``--ckpt-freq-iters`` steps, ``final.pt`` where ``--max-steps`` ends a run,
each also as ``latest.pt``; each records the epoch and the items of it
already trained on. ``--resume-from`` (a file, or a work dir holding
``ckpts/latest.pt``) continues the weights, the optimizer and the step
count; without it, a ``--work-dir`` that holds ``ckpts/latest.pt`` is
resumed from (as the JAX driver restores its own ``ckpts``), so the same
command run again continues where it stopped. With ``--iter-resume`` a
resume also skips the items of the epoch already trained on (the
reference's iteration resume), without it the epoch starts again from its
first item. Runs on the first CUDA device unless ``--device
cpu`` asks for the kernels' plain versions on the CPU; with no card and no
``--device cpu`` it exits non-zero. ``--amp`` sets the config's
``compute_dtype`` to bf16 (backbone and neck), as the JAX driver does
(``train.py:39-41, 165-169``). ``--teacher-ckpt``: an HF Swin-UperNet
checkpoint (``.pt``, ``.bin``, ``.safetensors``) for the online semantic
teacher (``utils/openseed_utils.TorchSemTeacher``, on the step's device):
where the config trains semantics (``cfg.sem``) and a batch carries no
``sem_gt``, the teacher's maps of ``curr_imgs[0] * 256`` at
``cfg.img_size`` become its ``sem_gt``, as the JAX driver does
(``train.py:215-219, 272-286``; the reference's ``train.py:213-215``).
``--dp`` and ``--mp`` are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from .geometry.ray_sampler import RaySampler
from .models.initializers import init_weights
from .models.segmentor import TPVSegmentor
from .ops.interp import bilinear_sample
from .utils.checkpoint import load_torch_resnet50, save_checkpoint
from .utils.eval_lib import ChunkedRenderer, camera_kwargs, rays_for_cams
from .utils.logging_util import ScalarWriter
from .utils.metrics import DepthMetric
from .utils.openseed_utils import TorchSemTeacher
from .utils.runtime import (add_device_arg, checkpoint_path, get_dataset,
                            get_logger, host_arrays, resolve_device,
                            to_device)
from .utils.train_lib import Trainer

RESNET_PTH = "ckpts/resnet50-0676ba61.pth"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--work-dir", default="work_dirs/torch_run")
    ap.add_argument("--resume-from", default="")
    ap.add_argument("--iter-resume", action="store_true",
                    help="on a resume (--resume-from, or the work dir's "
                         "ckpts/latest.pt), skip the items of the epoch "
                         "that the checkpoint had trained on")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after this many (micro-)steps (0: epochs)")
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
    ap.add_argument("--amp", action="store_true",
                    help="bf16 backbone/neck compute (the config's "
                         "compute_dtype)")
    ap.add_argument("--gradient-accumulation", type=int, default=1,
                    help="micro-steps whose mean gradient one optimizer "
                         "update takes")
    ap.add_argument("--profile", action="store_true",
                    help="a torch.profiler trace of micro-steps 5-9 into "
                         "<work-dir>/profile")
    ap.add_argument("--eval-every-epoch", action="store_true",
                    help="a depth eval after each epoch's checkpoint")
    ap.add_argument("--eval-samples", type=int, default=4)
    ap.add_argument("--teacher-ckpt", default="",
                    help="HF Swin-UperNet checkpoint for the online "
                         "semantic teacher: sem_gt from curr_imgs where a "
                         "batch carries none")
    add_device_arg(ap)
    return ap.parse_args(argv)


def config_of(args):
    """The config ``--py-config`` names, with ``--amp`` applied."""
    cfg = get_config(args.py_config)
    if args.amp:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))
    return cfg


def build_trainer(cfg, seed: int, device,
                  grad_accumulation: int = 1) -> Trainer:
    """The port's segmentor with seeded JAX-like initial weights on
    ``device``, and its optimizer (``grad_accumulation``: see
    ``Trainer``)."""
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return Trainer(cfg, model.to(device), grad_accumulation)


@torch.no_grad()
def run_epoch_eval(model, cfg, ds, logger, n_samples: int, epoch: int,
                   device) -> Dict:
    """The per-epoch depth eval (``train.py:70-110``, reference
    ``train.py:306-373``): of the first ``n_samples`` items of ``ds`` that
    carry ``depth_loc``, the fixed ray grid at ``cfg.num_rays`` through
    ``img2lidar``, rendered (depth only) in chunks of 8192 rays against
    the prepared volume (``camera_kwargs`` for a camera-aware encoder),
    looked up bilinearly at the lidar pixels and scored by ``DepthMetric``
    (raw). The model evaluates in eval mode and returns to the mode it was
    in; no generator is drawn from. Logs and returns the table."""
    renderer = ChunkedRenderer(model, chunk=8192, outputs=("depth",))
    rh, rw = cfg.num_rays
    rays = RaySampler(ray_sample_mode="fixed", ray_number=(rh, rw),
                      ray_img_size=tuple(cfg.img_size))(device)
    metric = DepthMetric(camera_names=[f"cam{i}" for i in
                                       range(cfg.num_cams)],
                         eval_types=["raw"])
    was_training = model.training
    model.eval()
    try:
        for i in range(min(n_samples, len(ds))):
            item = host_arrays(ds[i])
            if "depth_loc" not in item:
                continue
            batch = to_device(item, device)
            volume = renderer.prepare(batch["imgs"], batch["lidar2img"],
                                      **camera_kwargs(cfg, batch))
            origin, direction = rays_for_cams(batch["img2lidar"], rays)
            depth = torch.from_numpy(renderer.render(
                volume, origin, direction)["depth"]).reshape(
                    cfg.num_cams, rh, rw)
            loc = item["depth_loc"]
            pix = torch.from_numpy(np.stack(
                [loc[..., 0] * (rw - 1), loc[..., 1] * (rh - 1)],
                -1)).float()
            pred_at = np.stack([
                bilinear_sample(depth[c][..., None], pix[c],
                                "border")[..., 0].numpy()
                for c in range(cfg.num_cams)])
            metric._after_step(pred_at, item["depth_gt"], item["depth_mask"])
    finally:
        model.train(was_training)
    logger.info(f"=== epoch {epoch} depth eval ===")
    return metric._after_epoch(logger=logger)


class StepProfiler:
    """``--profile``: a ``torch.profiler`` trace of micro-steps 5 to 9,
    started before step 5 and stopped before step 10 (or by ``close`` at
    the run's end), exported as a Chrome trace to
    ``<work_dir>/profile/trace.json``."""

    START, STOP = 5, 10

    def __init__(self, work_dir: str, device, logger):
        self.path = os.path.join(work_dir, "profile", "trace.json")
        self.device, self.logger = device, logger
        self.prof = None

    def before_step(self, step: int):
        if step == self.START and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        elif step == self.STOP:
            self.close()

    def close(self):
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        t0 = time.perf_counter()
        prof.__exit__(None, None, None)
        t1 = time.perf_counter()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)
        self.logger.info(f"profiler trace written to {self.path} (stop "
                         f"{t1 - t0:.1f}s, export "
                         f"{time.perf_counter() - t1:.1f}s)")


def format_metrics(metrics) -> str:
    scalars = {k: float(v) for k, v in metrics.items() if k != "times"}
    return ", ".join(f"{k}={v:.6g}" for k, v in sorted(scalars.items()))


def host_batch(ds, index: int, seed: int, epoch: int, pos: int) -> Dict:
    """Item ``index`` of ``ds`` as host arrays (labels, tokens and
    sequence names dropped), built after seeding Python's and numpy's
    global generators from (seed, epoch, position): the dataset's
    augmentation and KITTI-raw's stereo side draw from them."""
    s = (seed * 1_000_003 + epoch * 100_003 + pos) % 2**32
    random.seed(s)
    np.random.seed(s)
    return host_arrays(ds[index])


def train(cfg, trainer: Trainer, ds, device, max_steps: int, seed: int,
          print_freq: int, logger, epochs: int = 0, start_epoch: int = 0,
          start_pos: int = 0, prefetch: int = 0,
          checkpoint: Optional[Callable[[str, int, int], None]] = None,
          ckpt_freq_iters: int = 0, writer: Optional[ScalarWriter] = None,
          profiler: Optional[StepProfiler] = None,
          epoch_eval: Optional[Callable[[int], Dict]] = None,
          teacher=None) -> Dict:
    """Steps over ``ds`` from item ``start_pos`` of epoch ``start_epoch``,
    in the sampler's order, up to ``max_steps`` (micro-)steps in all (0:
    no limit) or the end of epoch ``epochs`` (0: ``cfg.max_epochs``).
    ``checkpoint(name, epoch, position)`` is called every
    ``ckpt_freq_iters`` steps, at each epoch's end and where ``max_steps``
    ends the run, and ``epoch_eval(epoch)`` after the last two. The logged
    steps' scalars also go to ``writer`` as ``loss/<name>``; ``profiler``
    sees each step's count before it runs. ``teacher`` (a
    ``TorchSemTeacher``) fills a batch's missing ``sem_gt`` where
    ``cfg.sem``. Returns the last step's
    ``metrics``, the ``items`` trained on, the logged steps' scalars
    (``logged``: step -> losses, ``grad_norm``, ``lr``), per step the host
    seconds spent waiting for its batch (``data_wait_s``) and from that
    wait's start to the step's end (``step_s``: the step's time where it
    is logged, since reading the losses waits for the card; else its host
    dispatch), and ``epoch_evals`` (epoch -> ``epoch_eval``'s table)."""
    sampler = DistributedSampler(len(ds), 1, 0, shuffle=True, seed=seed)
    res = {"metrics": None, "items": [], "logged": {}, "data_wait_s": [],
           "step_s": [], "epoch_evals": {}}
    if max_steps and trainer.global_step >= max_steps:
        return res

    def end_of_epoch(name, epoch, next_epoch, pos):
        if checkpoint is not None:
            checkpoint(name, next_epoch, pos)
        if epoch_eval is not None:
            res["epoch_evals"][epoch] = epoch_eval(epoch)
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
                if teacher is not None and cfg.sem and "sem_gt" not in batch:
                    # the reference feeds curr_imgs[0] * 256 at img_size
                    # (train.py:214)
                    batch["sem_gt"] = teacher(batch["curr_imgs"][0] * 256.0,
                                              size=cfg.img_size)[None]
                gen = torch.Generator(device=device).manual_seed(seed + step)
                if profiler is not None:
                    profiler.before_step(step)
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
                    if writer is not None:
                        for k, v in res["logged"][step].items():
                            writer.add_scalar(f"loss/{k}", v, step)
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
            end_of_epoch("final", epoch, epoch, pos)
            return res
        end_of_epoch(f"epoch_{epoch + 1}", epoch, epoch + 1, 0)
        if done:
            return res
    return res


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_of(args)
    ds = get_dataset(cfg, args.synthetic, phase="train")
    logger = get_logger(args.work_dir)
    logger.info(f"config {cfg.name} on {device}; {len(ds)} items")
    resnet_pth = args.resnet_pth if cfg.model.backbone_type == "resnet50" \
        and args.resnet_pth and os.path.exists(args.resnet_pth) else ""
    if not resnet_pth and args.resnet_pth not in ("", RESNET_PTH) and \
            not os.path.exists(args.resnet_pth):
        sys.exit(f"selfocc_tpu_torch: --resnet-pth {args.resnet_pth!r} "
                 "not found")
    trainer = build_trainer(cfg, args.seed, device,
                            args.gradient_accumulation)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info(f"params: {n_params / 1e6:.2f}M")
    if resnet_pth:
        n = load_torch_resnet50(trainer.model, resnet_pth)
        logger.info(f"backbone: {n} tensors from {resnet_pth}")
    start_epoch, start_pos = 0, 0
    ckpt_dir = os.path.join(args.work_dir, "ckpts")
    resume = args.resume_from or (
        args.work_dir if os.path.exists(os.path.join(ckpt_dir, "latest.pt"))
        else "")
    if resume:
        path = checkpoint_path(resume)
        state = torch.load(path, map_location=device)
        trainer.load_state_dict(state)
        start_epoch = int(state.get("epoch", 0))
        if args.iter_resume:
            start_pos = int(state.get("last_iter", 0))
        logger.info(f"resumed from {path} at step {trainer.global_step}, "
                    f"epoch {start_epoch}, item {start_pos} of the epoch")

    def checkpoint(name, epoch, pos):
        path = save_checkpoint(ckpt_dir, name, dict(
            trainer.state_dict(), epoch=epoch, last_iter=pos))
        logger.info(f"step {trainer.global_step}: checkpoint saved at "
                    f"{path} (epoch {epoch}, item {pos})")

    def epoch_eval(epoch):
        return run_epoch_eval(trainer.model, cfg, ds, logger,
                              args.eval_samples, epoch, device)

    teacher = None
    if args.teacher_ckpt:
        teacher = TorchSemTeacher.from_checkpoint(args.teacher_ckpt,
                                                  device=device)
        logger.info(f"online semantic teacher: {args.teacher_ckpt}")
    writer = ScalarWriter(args.work_dir)
    profiler = StepProfiler(args.work_dir, device, logger) \
        if args.profile else None
    try:
        res = train(cfg, trainer, ds, device, args.max_steps, args.seed,
                    args.print_freq, logger, epochs=args.epochs,
                    start_epoch=start_epoch, start_pos=start_pos,
                    prefetch=args.prefetch, checkpoint=checkpoint,
                    ckpt_freq_iters=args.ckpt_freq_iters, writer=writer,
                    profiler=profiler,
                    epoch_eval=epoch_eval if args.eval_every_epoch
                    else None, teacher=teacher)
    finally:
        if profiler is not None:
            profiler.close()
        writer.close()
    logger.info("training complete")
    return res


if __name__ == "__main__":
    main()
