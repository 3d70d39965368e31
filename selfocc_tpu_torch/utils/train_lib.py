"""Training library — counterpart of ``selfocc_tpu/utils/train_lib.py``
(single-device path): the LR schedule, AdamW with the backbone LR multiplier
and frozen subtrees, the global-norm clip, the loss inputs and one train
step. Gradient accumulation, data and model parallelism are not ported.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import torch

from ..configs.base import Config
from ..losses import MultiLoss

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


class Trainer:
    """Model, optimizer, schedule, loss and step count of one run; ``step``
    is ``selfocc_tpu/utils/train_lib.py``'s ``make_train_step`` body."""

    def __init__(self, cfg: Config, model: torch.nn.Module):
        self.cfg = cfg
        self.model = model
        self.loss_fn = MultiLoss(cfg.loss_cfgs)
        self.optimizer, self.sched = make_optimizer(cfg, model)
        self.global_step = 0

    def step(self, batch: Dict[str, torch.Tensor], generator,
             draws: Optional[Dict] = None,
             sync: Optional[Callable[[], None]] = None) -> Dict:
        """One optimizer step on a device batch. Returns the weighted loss
        dict, ``total``, ``grad_norm`` (of the trainable parameters, before
        clipping) and ``lr`` as tensors, plus the host seconds of forward,
        backward and optimizer (each ended by ``sync`` when given)."""
        sync = sync or (lambda: None)
        self.model.train()
        t0 = time.perf_counter()
        out = self.model(batch["imgs"], batch["lidar2img"],
                         batch[self.cfg.model.head.trans_kw], train=True,
                         generator=generator, draws=draws)
        tot, ldict = self.loss_fn(build_loss_inputs(self.cfg, out, batch))
        sync()
        t1 = time.perf_counter()
        self.optimizer.zero_grad(set_to_none=True)
        tot.backward()
        sync()
        t2 = time.perf_counter()
        lr = self.sched(self.global_step)
        norm = optimizer_step(self.optimizer, self.sched, self.global_step,
                              self.cfg.grad_max_norm)
        sync()
        t3 = time.perf_counter()
        self.global_step += 1
        metrics = dict(ldict, total=tot.detach(), grad_norm=norm)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["lr"] = lr
        metrics["times"] = {"forward_s": t1 - t0, "backward_s": t2 - t1,
                            "optimizer_s": t3 - t2}
        return metrics

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.global_step}

    def load_state_dict(self, state: Dict):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = int(state["step"])
