"""The ranks of ``tests/test_torch_port_mp.py``: what
``selfocc_tpu_torch.parallel.mesh.spawn`` runs in new processes, which
import torch and the port only."""
import numpy as np
import torch

from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.parallel import mesh
from selfocc_tpu_torch.utils import train_lib

GATHER_SIZES = (7, 5, 4)      # planes of rows no rank count divides
GATHER_WIDTH = 3


def one_step(cfg, state_dict, batch, seed=None, draws=None, group=None):
    """One ``Trainer.step`` of ``cfg``'s model from ``state_dict`` on
    ``batch`` (host arrays), model-parallel over ``group`` where given,
    its generator seeded with ``seed`` (None: no generator) and the head's
    draws ``draws``. Returns host tensors: the metrics, the gradients the
    optimizer was given (caught where it clips them), the parameters
    after the update and the BatchNorm statistics."""
    model = TPVSegmentor(cfg.model)
    model.load_state_dict(state_dict, strict=True)
    trainer = train_lib.Trainer(cfg, model, group=group,
                                model_parallel=group is not None)
    seen = {}
    clip = train_lib.clip_by_global_norm

    def caught(params, max_norm):
        seen["grads"] = {n: p.grad.clone() for n, p in
                         model.named_parameters() if p.grad is not None}
        return clip(params, max_norm)

    train_lib.clip_by_global_norm = caught
    try:
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        metrics = trainer.step({k: torch.from_numpy(v)
                                for k, v in batch.items()}, gen, draws=draws)
    finally:
        train_lib.clip_by_global_norm = clip
    return {"metrics": {k: float(v) for k, v in metrics.items()
                        if k != "times"},
            "grads": seen["grads"],
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def mp_steps(group, cases, threads):
    """Each case of ``cases`` (name -> ``one_step``'s arguments but the
    group) as a model-parallel step of this rank."""
    torch.set_num_threads(threads)
    return {name: one_step(*args, group=group, **kw)
            for name, (args, kw) in cases.items()}


def gather_case(group, route):
    """``gather_rows`` on the planes of ``GATHER_SIZES`` and their
    concatenated sequence, by ``route``: the gathered rows (every rank's
    own rows of one seeded table, integer-valued so that any order of
    summation is exact) and this rank's cotangent (each rank's cotangent
    of the whole sequence is seeded by its rank)."""
    shard = mesh.ModelShard(group, GATHER_SIZES, route)
    out = {"route": shard.route}
    for key, rows in [(f"plane{i}", r) for i, r in enumerate(shard.planes)] \
            + [("seq", shard.seq)]:
        table = torch.from_numpy(np.random.RandomState(rows.n).randint(
            -50, 50, (1, rows.n, GATHER_WIDTH)).astype(np.float32))
        x = rows.take(table).clone().requires_grad_(True)
        full = mesh.gather_rows(x, rows)
        cot = torch.from_numpy(np.random.RandomState(100 + group.rank).randint(
            -50, 50, (1, rows.n, GATHER_WIDTH)).astype(np.float32))
        full.backward(cot)
        out[key] = {"table": table, "full": full.detach(), "grad": x.grad,
                    "index": torch.from_numpy(rows.index)}
    return out


def gather_checks(group, routes):
    """``gather_case`` on each of ``routes``."""
    return {route: gather_case(group, route) for route in routes}


def mp_ranks(group, cases, threads, routes):
    """``mp_steps`` and ``gather_checks`` in one rank."""
    return {"steps": mp_steps(group, cases, threads),
            "gather": gather_checks(group, routes)}
