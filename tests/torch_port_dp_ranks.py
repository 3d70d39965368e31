"""The ranks of ``tests/test_torch_port_dp.py``: what
``selfocc_tpu_torch.parallel.mesh.spawn`` runs in new processes, which
import torch and the port only."""
import torch

from selfocc_tpu_torch.models.resnet import Bottleneck
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import train_lib


def running_stats(module):
    return {n: b.clone() for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def dp_step(group, cfg, state_dict, batches, draws, blk_state, blk_inputs,
            threads):
    """One data-parallel ``tiny`` step on this rank's item (``batches[r]``,
    the head's draws ``draws[r]``), the averaged gradients caught where the
    optimizer clips them; then a train-mode ResNet bottleneck on this
    rank's input, its BatchNorm statistics before and after
    ``Trainer.average``. Returns host tensors."""
    torch.set_num_threads(threads)
    model = TPVSegmentor(cfg.model)
    model.load_state_dict(state_dict, strict=True)
    trainer = train_lib.Trainer(cfg, model, group=group)
    seen = {}
    clip = train_lib.clip_by_global_norm

    def caught(params, max_norm):
        seen["grads"] = {n: p.grad.clone() for n, p in
                         model.named_parameters() if p.grad is not None}
        return clip(params, max_norm)

    train_lib.clip_by_global_norm = caught
    try:
        batch = {k: torch.from_numpy(v) for k, v in
                 batches[group.rank].items()}
        metrics = trainer.step(batch, None, draws=draws[group.rank])
    finally:
        train_lib.clip_by_global_norm = clip

    blk = Bottleneck(16, 8, stride=2, downsample=True)
    blk.load_state_dict(blk_state, strict=True)
    blk.train()
    blk_trainer = train_lib.Trainer(cfg, blk, group=group)
    x, cot = (torch.from_numpy(a) for a in blk_inputs[group.rank])
    tot = (blk(x) * cot).sum()
    tot.backward()
    own = running_stats(blk)
    blk_trainer.average(tot, {})

    # gradients on some ranks only: a is used on rank 0, b on both, c on
    # neither
    toy = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.ones(3))
                                  for k in "abc"})
    toy_trainer = train_lib.Trainer(cfg, toy, group=group)
    x = torch.arange(3.0) + 10 * group.rank
    tot = (toy["b"] * x).sum()
    if group.rank == 0:
        tot = tot + (toy["a"] * x).sum()
    tot.backward()
    toy_trainer.average(tot, {})
    return {"metrics": {k: float(v) for k, v in metrics.items()
                        if k != "times"},
            "grads": seen["grads"],
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "bn_own": own, "bn_avg": running_stats(blk),
            "toy_grads": {k: None if p.grad is None else p.grad.clone()
                          for k, p in toy.items()}}
