"""Training library — counterpart of ``selfocc_tpu/utils/train_lib.py``
(single-device path): the LR schedule, AdamW with the backbone LR multiplier
and frozen subtrees, the global-norm clip, gradient accumulation
(``optax.MultiSteps``), the loss inputs and one train step, which a process
group makes a data-parallel step (``make_dp_train_step``, ``train_lib.py:
202-231``) or a model-parallel one (``make_mp_train_step``,
``train_lib.py:174-199``).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import torch

from ..configs.base import Config
from ..losses import MultiLoss
from ..parallel.mesh import Group, all_reduce_mean, all_reduce_sum

ADAM_EPS = 1e-8   # optax.adamw's default


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Linear warmup from 1e-6 to ``lr`` over ``warmup_iters``, then
    MultiStep decay at ``multistep_decay_t`` (``optax.piecewise_constant``:
    scaled from the boundary step on) or cosine to zero. Step k, counted
    from 0 as optax's count is, trains with ``sched(k)``."""
    total = cfg.steps_per_epoch * cfg.max_epochs
    decay_steps = max(total - cfg.warmup_iters, 1)

    def base(step):
        if cfg.multisteplr:
            v = cfg.lr
            for t in sorted(int(t) for t in cfg.multistep_decay_t):
                if step >= t:
                    v *= cfg.multistep_decay_rate
            return v
        c = min(step, decay_steps)
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    def sched(step):
        if step < cfg.warmup_iters:
            frac = 1.0 - min(max(step, 0), cfg.warmup_iters) / cfg.warmup_iters
            return (1e-6 - cfg.lr) * frac + cfg.lr
        return base(step)
    return sched


def _frozen_prefixes(cfg: Config):
    frozen = []
    if cfg.model.freeze_img_backbone:
        frozen.append("img_backbone")
    if cfg.model.freeze_img_neck:
        frozen.append("img_neck")
    return frozen


def make_optimizer(cfg: Config, model: torch.nn.Module):
    """``torch.optim.AdamW`` (betas (0.9, 0.999), eps 1e-8, weight decay
    ``cfg.weight_decay`` on every parameter, as ``optax.adamw``) in two
    groups: ``img_backbone.*`` at ``lr x backbone_lr_mult``, the rest at
    ``lr``. Frozen backbone / neck parameters get ``requires_grad=False``
    (the reference's ``requires_grad_(False)``): no update, no decay and no
    part in the clip norm. Returns (optimizer, schedule); each group's
    ``lr_mult`` scales the schedule."""
    frozen = _frozen_prefixes(cfg)
    groups = {"backbone": [], "rest": []}
    for name, p in model.named_parameters():
        if any(name.startswith(f + ".") for f in frozen):
            p.requires_grad_(False)
            continue
        key = "backbone" if name.startswith("img_backbone.") else "rest"
        groups[key].append(p)
    sched = make_lr_schedule(cfg)
    param_groups = [
        {"params": groups["backbone"], "lr_mult": cfg.backbone_lr_mult},
        {"params": groups["rest"], "lr_mult": 1.0}]
    param_groups = [g for g in param_groups if g["params"]]
    for g in param_groups:
        g["lr"] = sched(0) * g["lr_mult"]
    opt = torch.optim.AdamW(param_groups, betas=(0.9, 0.999), eps=ADAM_EPS,
                            weight_decay=cfg.weight_decay)
    return opt, sched


def clip_by_global_norm(params: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` when the global norm exceeds ``max_norm``, else
    leave it. Unlike ``torch.nn.utils.clip_grad_norm_`` there is no 1e-6
    added to the norm. Returns the norm before clipping; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    torch._foreach_mul_(grads, scale)
    return norm


def optimizer_step(optimizer, sched, step: int,
                   max_norm: float) -> torch.Tensor:
    """Clip, set the LR of ``step`` and apply AdamW; returns the gradient
    norm before clipping."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    norm = clip_by_global_norm(params, max_norm)
    for g in optimizer.param_groups:
        g["lr"] = sched(step) * g["lr_mult"]
    optimizer.step()
    return norm


def build_loss_inputs(cfg: Config, out: Dict, batch: Dict) -> Dict:
    """Remap head outputs through ``loss_input_convertion`` and add the
    batch's supervision tensors (reference ``train.py:232-234``)."""
    inputs = {cfg.loss_input_convertion[k]: out[k]
              for k in cfg.loss_input_convertion if k in out}
    for k in ("curr_imgs", "prev_imgs", "next_imgs", "color_imgs", "sem_gt",
              "img2prevImg", "img2nextImg"):
        if k in batch:
            inputs[k] = batch[k]
    return inputs


def aug_kwargs(batch: Dict, camera_aware: bool = False) -> Dict:
    """The augmentation record the model takes from a batch, where the
    batch has it (``train_lib.py:132-142``): ``flip``, the per-camera
    ``focal_ratios_x`` / ``focal_ratios_y`` of a ``pad_scale_rate``
    resize, and for a ``camera_aware`` encoder the batch's ``intrinsic``
    and ``cam2ego``."""
    kw = {}
    if "flip" in batch:
        kw["flip"] = batch["flip"]
    if "focal_ratios_x" in batch:
        kw["focal_ratios_x"] = batch["focal_ratios_x"]
        kw["focal_ratios_y"] = batch["focal_ratios_y"]
    if camera_aware:
        kw["intrinsic"] = batch["intrinsic"]
        kw["cam2ego"] = batch["cam2ego"]
    return kw


class Trainer:
    """Model, optimizer, schedule, loss and step count of one run; ``step``
    is ``selfocc_tpu/utils/train_lib.py``'s ``make_train_step`` body.

    ``grad_accumulation`` K > 1 is ``optax.MultiSteps(tx,
    every_k_schedule=K)`` around the optimizer chain (``train_lib.py:
    106-107``): each micro-step's gradients go into a running mean (the
    Welford update ``acc + (g - acc) / (n + 1)``, as optax's); at the K-th
    the clip, AdamW and its weight decay act once on the mean and the
    mean is reset; at the others the parameters do not change. The LR
    schedule and AdamW's step count advance with the optimizer updates
    (``updates``), the model's ``global_iter`` with the micro-steps
    (``global_step``, the JAX ``TrainState.step``). K = 1 is the plain
    step, with no copy of the gradients.

    ``group`` (``parallel.mesh.Group``, more than one rank) makes each
    micro-step a data-parallel one, ``make_dp_train_step``'s
    (``train_lib.py:213-224``): after the backward, one ``all_reduce_mean``
    (``average``) replaces the trainable gradients, ``total``, the weighted
    losses and the BatchNorm running statistics by their means over the
    ranks, then ``apply_gradients`` runs on the mean as on one rank's
    gradients (so ``grad_norm`` is the averaged gradients' and K > 1
    accumulates averaged gradients, as ``optax.MultiSteps`` inside the JAX
    step does). The statistics are averaged after each rank's own update,
    the JAX ``pmean(new_bs)``, not the reference's SyncBN. Every rank must
    hold the same parameters and optimizer state at the start (the driver
    broadcasts rank 0's); they then stay bit-equal. One rank: the plain
    step, bit for bit.

    ``model_parallel`` (with a ``group``) makes each micro-step the JAX
    ``make_mp_train_step``'s instead: every rank takes the same batch and
    generator, the model's ``model_shard(group)`` gives the TPV encoder
    the rank's rows of each plane (``models/encoder.TPVFormerEncoder``; a
    BEV model runs whole on every rank), and the rest of the step runs
    whole on every rank. A parameter's gradient is then the sum of the
    ranks' gradients: each rank backpropagates its loss divided by
    ``world``, every ``gather_rows`` sums over the ranks in its backward,
    and one ``all_reduce_sum`` sums the trainable gradients (with the
    has-gradient counts of ``_reduce_gradients``) before
    ``apply_gradients`` (clip and ``grad_norm`` after the sum). The
    losses and BatchNorm statistics are the rank's own: every rank
    computes them whole. The ranks stay bit-equal. A one-rank group runs
    the sharded code path, numerically the plain step."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 grad_accumulation: int = 1, group: Optional[Group] = None,
                 model_parallel: bool = False):
        if grad_accumulation < 1:
            raise ValueError("grad_accumulation must be >= 1")
        if model_parallel and group is None:
            raise ValueError("model_parallel needs a process group")
        self.cfg = cfg
        self.model = model
        self.loss_fn = MultiLoss(cfg.loss_cfgs)
        self.optimizer, self.sched = make_optimizer(cfg, model)
        self.grad_accumulation = grad_accumulation
        self.group = group
        self.model_parallel = model_parallel
        self.shard = model.model_shard(group) if model_parallel else None
        self.global_step = 0        # micro-steps (the model's global_iter)
        self.updates = 0            # optimizer updates (the LR schedule's)
        self.mini_step = 0          # micro-steps into the current window
        self.acc_grads = None       # their running mean (K > 1)

    def running_stats(self) -> List[torch.Tensor]:
        """The BatchNorm running statistics (``running_mean`` /
        ``running_var`` of ``models/resnet.BatchNorm2d``, which the UNet2D
        and ``CameraAwareSE`` use too), in module order."""
        return [b for m in self.model.modules()
                for k, b in m._buffers.items()
                if k in ("running_mean", "running_var") and b is not None]

    def _reduce_gradients(self, reduce, device, extra=()):
        """``reduce`` (a ``parallel.mesh`` all-reduce) of the trainable
        gradients, a has-gradient count per parameter and ``extra``, in one
        call. Gradients can be missing on some ranks only (a
        data-dependent branch): a parameter with a gradient on no rank
        keeps ``None``, as in the plain step; one with a gradient on some
        ranks takes zeros on the others, as JAX's gradient of an unused
        parameter is. Where every trainable parameter has a gradient here,
        no host synchronisation; else the counts are read."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        here = [p.grad is not None for p in params]
        grads = [p.grad if h else torch.zeros_like(p)
                 for p, h in zip(params, here)]
        have = torch.ones(len(params), device=device) if all(here) else \
            torch.tensor(here, dtype=torch.float32, device=device)
        reduce(grads + [have] + list(extra), self.group)
        if not all(here):
            anywhere = (have > 0).tolist()
            for p, g, h, a in zip(params, grads, here, anywhere):
                if not h:
                    p.grad = g if a else None

    def average(self, tot: torch.Tensor, ldict: Dict):
        """The data-parallel part of a micro-step: one ``all_reduce_mean``
        of the trainable gradients, a has-gradient count per parameter
        (``_reduce_gradients``), ``tot`` and the losses, and the BatchNorm
        running statistics. Returns the averaged (``tot``, ``ldict``)."""
        keys = sorted(ldict)
        losses = torch.stack([tot.detach().float()]
                             + [ldict[k].detach().float() for k in keys])
        self._reduce_gradients(all_reduce_mean, tot.device,
                               [losses] + self.running_stats())
        return losses[0], dict(zip(keys, losses[1:]))


    def apply_gradients(self):
        """The optimizer's part of a micro-step, on the parameters'
        ``.grad``: returns (the gradients' global norm before clipping,
        the LR of this update). K = 1: ``optimizer_step``. K > 1: the
        running mean takes the gradients (a trainable parameter without
        one takes zeros, as JAX's gradient of an unused parameter is), and
        on the window's last micro-step the optimizer steps on it."""
        lr = self.sched(self.updates)
        K = self.grad_accumulation
        if K == 1:
            norm = optimizer_step(self.optimizer, self.sched, self.updates,
                                  self.cfg.grad_max_norm)
            self.updates += 1
            return norm, lr
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in named]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if self.acc_grads is None:
            self.acc_grads = {n: torch.zeros_like(p) for n, p in named}
        acc = [self.acc_grads[n] for n, _ in named]
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(acc, delta)
        self.mini_step += 1
        if self.mini_step == K:
            for (_, p), mean in zip(named, acc):
                p.grad = mean
            optimizer_step(self.optimizer, self.sched, self.updates,
                           self.cfg.grad_max_norm)
            self.updates += 1
            self.mini_step = 0
            self.acc_grads = None
        return norm, lr

    def step(self, batch: Dict[str, torch.Tensor], generator,
             draws: Optional[Dict] = None,
             sync: Optional[Callable[[], None]] = None) -> Dict:
        """One micro-step on a device batch (with K = 1 one optimizer
        step; its ``flip``, focal ratios and, for a camera-aware encoder,
        cameras go to the model: ``aug_kwargs``). The model gets
        ``global_step``, the count of micro-steps before this one (the JAX
        step's ``state.step``; resume restores it). Returns the weighted
        loss dict, ``total``, ``grad_norm`` (of this micro-step's
        gradients of the trainable parameters, before clipping) and ``lr``
        (of the update this micro-step belongs to) as tensors, plus the
        host seconds of forward, backward and optimizer (each ended by
        ``sync`` when given; with a group also ``all_reduce_s``, the
        reduction between backward and optimizer; after the data-parallel
        ``average`` the metrics are the averaged losses)."""
        sync = sync or (lambda: None)
        self.model.train()
        kw = aug_kwargs(batch, self.cfg.model.encoder.camera_aware)
        if self.shard is not None:
            kw["shard"] = self.shard
        t0 = time.perf_counter()
        out = self.model(batch["imgs"], batch["lidar2img"],
                         batch[self.cfg.model.head.trans_kw], train=True,
                         generator=generator, draws=draws,
                         global_iter=self.global_step, **kw)
        tot, ldict = self.loss_fn(build_loss_inputs(self.cfg, out, batch))
        sync()
        t1 = time.perf_counter()
        self.optimizer.zero_grad(set_to_none=True)
        (tot / self.group.world if self.model_parallel else tot).backward()
        sync()
        t2 = time.perf_counter()
        times = {"forward_s": t1 - t0, "backward_s": t2 - t1}
        if self.model_parallel:
            self._reduce_gradients(all_reduce_sum, tot.device)
            sync()
            times["all_reduce_s"] = time.perf_counter() - t2
            t2 = time.perf_counter()
        elif self.group is not None and self.group.world > 1:
            tot, ldict = self.average(tot, ldict)
            sync()
            times["all_reduce_s"] = time.perf_counter() - t2
            t2 = time.perf_counter()
        norm, lr = self.apply_gradients()
        sync()
        times["optimizer_s"] = time.perf_counter() - t2
        self.global_step += 1
        metrics = dict(ldict, total=tot.detach(), grad_norm=norm)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["lr"] = lr
        metrics["times"] = times
        return metrics

    def state_dict(self) -> Dict:
        """Model, optimizer and step counts; with K > 1 also the window's
        position and its running mean (by parameter name), so that a
        resume mid-window continues it."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "step": self.global_step, "updates": self.updates}
        if self.grad_accumulation > 1:
            state["mini_step"] = self.mini_step
            state["acc_grads"] = dict(self.acc_grads or {})
        return state

    def load_state_dict(self, state: Dict):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = int(state["step"])
        self.updates = int(state.get("updates", self.global_step))
        if self.grad_accumulation > 1:
            self.mini_step = int(state.get("mini_step", 0))
            params = dict(self.model.named_parameters())
            self.acc_grads = {n: v.to(params[n].device).clone() for n, v in
                              state["acc_grads"].items()} \
                if state.get("acc_grads") else None
