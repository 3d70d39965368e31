"""Process groups, the data-parallel step's collectives and the eval's row
splits — counterpart of ``selfocc_tpu/parallel/mesh.py``.

The JAX package runs one process over a device mesh: ``shard_map`` and
``pmean`` for the data-parallel gradients (``utils/train_lib.py:202-231``),
sharded ray and point axes for the eval. The port trains as the reference
does (``train.py:32-45, 400-403``): one process per card, each rank one
replica, joined in an explicit ``torch.distributed`` process group
(``init_group``, ``spawn``; a launcher such as ``torchrun`` sets
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``, ``launcher_env``). The backend
is always the caller's choice: the drivers pass ``"nccl"`` on cards and
``"gloo"`` on the CPU; nothing here picks one. The eval needs no group:
one process splits its rows over its cards (``split_rows``,
``utils/eval_lib``).

The collectives are ``all_reduce`` and ``broadcast`` only, each over a few
flat buffers (``BUCKET_ELEMS`` elements at most) rather than one call per
tensor. Gloo carries CUDA tensors for these two (not for ``all_gather``),
which lets two gloo ranks share one card; NCCL refuses two ranks on one
device.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
BUCKET_ELEMS = 1 << 24                 # 64 MB of fp32 a collective
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of its process group: ``rank`` of ``world``, the
    device it computes on, the backend and the ``torch.distributed``
    group handle (``pg``)."""
    rank: int
    world: int
    device: torch.device
    backend: str
    pg: object

    def barrier(self):
        kw = {"device_ids": [self.device.index]} \
            if self.backend == "nccl" else {}
        dist.barrier(group=self.pg, **kw)


def init_group(backend: str, rank: int, world: int, device,
               init_method: str,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Group:
    """Join the process group of ``world`` ranks as ``rank`` through
    ``init_method`` (``file://...``, ``tcp://localhost:<port>`` or
    ``env://``), computing on ``device`` (a card becomes the current
    device). ``backend``: ``"nccl"`` or ``"gloo"``; ``timeout`` bounds
    every collective and barrier."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return Group(rank, world, device, backend, dist.group.WORLD)


def close(group: Group):
    """Leave the process group."""
    dist.destroy_process_group(group.pg)


def launcher_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local rank) where a launcher set ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK`` (``torchrun``); None otherwise."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               devices: Sequence[str], init_method: str, out_dir: str,
               timeout: datetime.timedelta, args: tuple):
    group = init_group(backend, rank, world, devices[rank], init_method,
                       timeout)
    try:
        out = fn(group, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close(group)


def spawn(fn: Callable, world: int, backend: str, devices: Sequence,
          args: tuple = (),
          timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> List:
    """Run ``fn(group, *args)`` in ``world`` new processes
    (``torch.multiprocessing.spawn``, as the reference's ``train.py:400-403``),
    rank r on ``devices[r]``, joined through a file store in a temporary
    directory (no port). ``fn`` is pickled by its import path and its
    return value by ``torch.save``: keep both on the host. Returns the
    ranks' return values in rank order; a rank that raises makes the whole
    call raise."""
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got "
                         f"{list(devices)}")
    with tempfile.TemporaryDirectory(prefix="selfocc_dp_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world, join=True,
            args=(fn, world, backend, [str(d) for d in devices], init, tmp,
                  timeout, tuple(args)))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """``tensors`` grouped by (device, dtype) in their order, each group
    cut into runs of at most ``BUCKET_ELEMS`` elements (a larger tensor
    alone)."""
    by_kind: Dict[tuple, List[List[torch.Tensor]]] = {}
    sizes: Dict[tuple, int] = {}
    for t in tensors:
        kind = (t.device, t.dtype)
        runs = by_kind.setdefault(kind, [[]])
        if runs[-1] and sizes[kind] + t.numel() > BUCKET_ELEMS:
            runs.append([])
            sizes[kind] = 0
        runs[-1].append(t)
        sizes[kind] = sizes.get(kind, 0) + t.numel()
    return [run for runs in by_kind.values() for run in runs]


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], group: Group):
    """Replace each tensor by its mean over the group's ranks, in place
    (the JAX ``lax.pmean``: the sum over ranks divided by their count).
    The tensors travel in a few flat buffers (``_buckets``); every rank
    must pass tensors of the same shapes, dtypes and order. One rank: no
    collective. Enqueues the collectives without a host synchronisation
    (NCCL)."""
    if group.world == 1:
        return
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.pg)
        flat.div_(group.world)
        for t, v in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(v.view_as(t))


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], group: Group, src: int = 0):
    """Overwrite each tensor with rank ``src``'s, in place, in a few flat
    buffers."""
    if group.world == 1:
        return
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.broadcast(flat, src, group=group.pg)
        if group.rank != src:
            for t, v in zip(run, flat.split([t.numel() for t in run])):
                t.copy_(v.view_as(t))


@torch.no_grad()
def replicas_equal(tensors: Sequence[torch.Tensor], group: Group) -> bool:
    """Whether every rank holds rank 0's ``tensors`` bit for bit (a copy is
    broadcast and compared; the count of differing tensors is summed over
    the ranks). Synchronises with the device."""
    if group.world == 1:
        return True
    def bits(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)

    ref = [t.detach().clone() for t in tensors]
    broadcast_(ref, group)
    differ = torch.stack([(bits(a) != bits(b)).any()
                          for a, b in zip(ref, tensors)]).sum().float()
    dist.all_reduce(differ, op=dist.ReduceOp.SUM, group=group.pg)
    return float(differ) == 0.0


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous (start, stop) slices of ``n`` rows over ``parts`` shards,
    in order, sizes differing by at most one (the larger first): the
    port's ``pad_to_multiple`` / ``batch_sharded``, without padding."""
    if parts < 1:
        raise ValueError("parts must be >= 1")
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out
