"""Process groups, the data- and model-parallel steps' collectives and the
eval's row splits — counterpart of ``selfocc_tpu/parallel/mesh.py``.

The JAX package runs one process over a device mesh: ``shard_map`` and
``pmean`` for the data-parallel gradients (``utils/train_lib.py:202-231``),
``maybe_shard`` hints on a ``"model"`` mesh for the model-parallel step
(``parallel/mesh.py:53-77``, ``utils/train_lib.py:174-199``), sharded ray
and point axes for the eval. The port trains as the reference does
(``train.py:32-45, 400-403``): one process per card, each rank one
replica, joined in an explicit ``torch.distributed`` process group
(``init_group``, ``spawn``; a launcher such as ``torchrun`` sets
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``, ``launcher_env``). The backend
is always the caller's choice: the drivers pass ``"nccl"`` on cards and
``"gloo"`` on the CPU; nothing here picks one. The eval needs no group:
one process splits its rows over its cards (``split_rows``,
``utils/eval_lib``).

The data-parallel collectives are ``all_reduce`` and ``broadcast``, each
over a few flat buffers (``BUCKET_ELEMS`` elements at most) rather than one
call per tensor (``all_reduce_mean``, ``all_reduce_sum``, ``broadcast_``).
The model-parallel step shards the TPV encoder's query rows
(``ModelShard``: each rank a contiguous block of each plane, ``split_rows``)
and joins them with ``gather_rows``, an autograd all-gather whose backward
is a reduce-scatter by sum. Its route follows the (backend, device type)
of the group (``collective_route``): NCCL, and gloo on CPU tensors,
``all_gather`` / ``reduce_scatter`` over shards padded to the largest; gloo
carries only ``all_reduce`` and ``broadcast`` for CUDA tensors, so there
the gather is an ``all_reduce`` of a zeroed buffer that holds the rank's
own rows (exact: x + 0 = x), which lets two gloo ranks share one card;
NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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
def all_reduce_sum(tensors: Sequence[torch.Tensor], group: Group,
                   mean: bool = False):
    """Replace each tensor by its sum over the group's ranks, in place
    (``mean``: divided by their count). The tensors travel in a few flat
    buffers (``_buckets``); every rank must pass tensors of the same
    shapes, dtypes and order. One rank: no collective. Enqueues the
    collectives without a host synchronisation (NCCL)."""
    if group.world == 1:
        return
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.pg)
        if mean:
            flat.div_(group.world)
        for t, v in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(v.view_as(t))


def all_reduce_mean(tensors: Sequence[torch.Tensor], group: Group):
    """Replace each tensor by its mean over the group's ranks, in place
    (the JAX ``lax.pmean``: the sum over ranks divided by their count;
    see ``all_reduce_sum``)."""
    all_reduce_sum(tensors, group, mean=True)


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


# ------------------------------------------------------ the model-parallel step
ROUTES = ("gather", "all_reduce")


def collective_route(backend: str, device_type: str) -> str:
    """How ``gather_rows`` moves rows for a group of ``backend`` whose
    tensors lie on ``device_type``: ``"gather"`` (``all_gather`` forward,
    ``reduce_scatter`` backward) for NCCL and for gloo on the CPU;
    ``"all_reduce"`` for gloo on CUDA tensors, where gloo has no gather."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return "all_reduce" if (backend, device_type) == ("gloo", "cuda") \
        else "gather"


class RowShard:
    """One rank's rows of an ``n``-row sequence, and how ``gather_rows``
    puts the ranks' rows back in global order. ``owned[r]``: rank r's
    global row indices, in order. Every rank's tensors in a gather are (1,
    rows, C): the rank's own rows in, the whole sequence out. The index
    tables go to a device once and are kept (a host-to-device copy in a
    per-call path blocks the stream)."""

    def __init__(self, owned: Sequence[np.ndarray], rank: int, group: Group,
                 route: str):
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        self.group, self.route, self.rank = group, route, rank
        self.counts = [len(o) for o in owned]
        self.n = sum(self.counts)
        self.width = max(self.counts)          # rows a rank sends, padded
        self.index = np.asarray(owned[rank], np.int64)
        # global row j -> its position in the gathered (world * width) rows
        src = np.empty(self.n, np.int64)
        for r, o in enumerate(owned):
            src[np.asarray(o, np.int64)] = r * self.width + np.arange(len(o))
        if sorted(np.concatenate(owned).tolist()) != list(range(self.n)):
            raise ValueError("the ranks' rows must cover the sequence once")
        self.src = src
        self.identity = bool(np.array_equal(src, np.arange(self.n)))
        lo = int(self.index[0]) if len(self.index) else 0
        self.span = (lo, lo + len(self.index)) if np.array_equal(
            self.index, np.arange(lo, lo + len(self.index))) else None
        self._tables: Dict[tuple, torch.Tensor] = {}

    @property
    def count(self) -> int:
        """The rows this rank owns."""
        return len(self.index)

    def table(self, name: str, device) -> torch.Tensor:
        """``index`` or ``src`` as an int64 tensor on ``device``."""
        key = (name, torch.device(device))
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(getattr(self, name)).to(
                device)
        return self._tables[key]

    def take(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of ``t`` (the whole sequence along ``dim``)."""
        if self.span is not None:
            return t.narrow(dim, self.span[0], self.count)
        return t.index_select(dim, self.table("index", t.device))


class ModelShard:
    """A rank's share of the TPV encoder under the model-parallel step
    (the JAX ``maybe_shard(p, None, "model", None)`` on each plane at each
    layer's entry): ``planes[i]``, a contiguous block of plane i's ``sizes[i]``
    rows (``split_rows(sizes[i], world)[rank]``); ``seq``, the same rows of
    the concatenated sequence (hw, then zh, then wz), which the
    self-attention's value and the shared FFN see. ``route``: see
    ``collective_route`` (default: the group's)."""

    def __init__(self, group: Group, sizes: Sequence[int],
                 route: Optional[str] = None):
        route = route or collective_route(group.backend, group.device.type)
        self.group, self.sizes, self.route = group, tuple(sizes), route
        splits = [split_rows(n, group.world) for n in self.sizes]
        self.planes = [RowShard([np.arange(a, b) for a, b in s],
                                group.rank, group, route) for s in splits]
        starts = np.cumsum((0,) + self.sizes[:-1])
        self.seq = RowShard(
            [np.concatenate([o + np.arange(s[r][0], s[r][1])
                             for o, s in zip(starts, splits)])
             for r in range(group.world)], group.rank, group, route)


def _gather(x: torch.Tensor, rows: RowShard) -> torch.Tensor:
    """(1, rows.count, C) own rows -> (1, rows.n, C), global order."""
    x = x[0].contiguous()
    group = rows.group
    if rows.route == "all_reduce":
        buf = x.new_zeros((rows.n,) + x.shape[1:])
        if rows.span is not None:
            buf[rows.span[0]:rows.span[1]] = x
        else:
            buf.index_copy_(0, rows.table("index", x.device), x)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
        return buf[None]
    if rows.count < rows.width:
        x = torch.cat([x, x.new_zeros((rows.width - rows.count,)
                                      + x.shape[1:])])
    out = x.new_empty((group.world * rows.width,) + x.shape[1:])
    dist.all_gather(list(out.chunk(group.world)), x, group=group.pg)
    if rows.identity:
        return out[:rows.n][None]
    return out.index_select(0, rows.table("src", x.device))[None]


def _scatter_sum(g: torch.Tensor, rows: RowShard) -> torch.Tensor:
    """(1, rows.n, C) cotangent on every rank -> (1, rows.count, C), each
    own row's sum over the ranks."""
    g = g[0].contiguous()
    group = rows.group
    if rows.route == "all_reduce":
        buf = g.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
        return rows.take(buf[None])
    if rows.identity and rows.n == group.world * rows.width:
        buf = g
    else:
        buf = g.new_zeros((group.world * rows.width,) + g.shape[1:])
        buf.index_copy_(0, rows.table("src", g.device), g)
    out = g.new_empty((rows.width,) + g.shape[1:])
    dist.reduce_scatter(out, list(buf.chunk(group.world)),
                        op=dist.ReduceOp.SUM, group=group.pg)
    return out[:rows.count][None]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return _gather(x, rows)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _scatter_sum(g, ctx.rows), None


def gather_rows(x: torch.Tensor, rows: RowShard) -> torch.Tensor:
    """Every rank's own rows of a sequence, (1, rows.count, C), as the
    whole sequence (1, rows.n, C) in global row order, on every rank. The
    backward sums each row's cotangent over the ranks and hands each rank
    its own rows (a reduce-scatter by sum): with every rank
    backpropagating its loss over ``world``, the sum is the one-process
    cotangent. The route is ``rows.route``."""
    return _GatherRows.apply(x, rows)
