"""Row gather ``table[idx]`` — counterpart of
``selfocc_tpu/ops/gather_rows.py::gather_rows`` (a Pallas DMA-ring kernel on
the TPU).

For a CUDA table ``gather_rows`` launches ``csrc/gather_rows.cu`` (one warp
per output row, vector copies of the row's bytes, any dtype); for a CPU table
it takes the plain version ``gather_rows_plain``. The contract is the JAX
function's: a row-major (R, C) table, (N,) int32 indices in range, N a
multiple of ``block``, output dtype = table dtype. ``block`` only checks that
contract here (the kernel needs no blocking), and the TPU's ``inflight`` DMA
semaphore count has no counterpart. No production path calls it; the
microbenchmark shape is ``tools/bench_gather.py``'s.
"""
from __future__ import annotations

import torch

from .. import _build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table.index_select(0, idx)``."""
    return table.index_select(0, idx.long())


def gather_rows_fwd(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gather_rows.cu`` on a contiguous 2-D CUDA table and
    int32 CUDA indices."""
    _build.require_cuda_tensor(table, "gather_rows table", table.dtype, 2)
    _build.require_cuda_tensor(idx, "gather_rows idx", torch.int32, 1)
    if idx.device != table.device:
        raise ValueError("gather_rows: idx must be on the table's device")
    N = idx.shape[0]
    out = torch.empty((N, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    lib = _build.load("gather_rows", _SIGNATURES)
    status = lib.gather_rows(
        _build.ptr(table), _build.ptr(idx), _build.ptr(out), N,
        table.shape[1] * table.element_size(),
        _build.stream_ptr(table.device))
    _build.check(status, "gather_rows")
    gather_rows_fwd.launches += 1
    return out


gather_rows_fwd.launches = 0
_SIGNATURES = {"gather_rows": (
    _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I64, _build.PTR)}


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                block: int = 512) -> torch.Tensor:
    """``table[idx]`` for a row-major (R, C) table and (N,) indices in
    range; N must be a multiple of ``block``. Returns (N, C) in
    ``table.dtype``."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError("gather_rows: expected a (R, C) table and (N,) "
                         f"indices, got {tuple(table.shape)} / "
                         f"{tuple(idx.shape)}")
    if idx.shape[0] % block:
        raise ValueError(f"gather_rows: N={idx.shape[0]} is not a multiple "
                         f"of block={block}")
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    return gather_rows_fwd(table.contiguous(),
                           idx.to(torch.int32).contiguous())
