"""Multi-scale deformable attention — counterpart of
``selfocc_tpu/ops/msda.py::ms_deform_attn`` (per-head sampling locations,
the exact tier).

Semantics are mmcv's pytorch fallback ``multi_scale_deformable_attn_pytorch``:
``grid_sample`` with ``align_corners=False`` and zeros padding (fractional
pixel ``loc * size - 0.5``), reduced with the softmaxed attention weights in
fp32. For CUDA tensors ``ms_deform_attn`` launches ``csrc/msda.cu``; for CPU
tensors it takes the plain version ``ms_deform_attn_plain``.

The JAX package's TPU layout levers (``shared_locations``, corner/pair
bundling, ``point_chunk``, ``query_chunk``, ``query_unroll``) are not ported:
the kernel stands in for them.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import _build


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one ``grid_sample`` per level, then the
    attention-weighted sum. Materialises (B*H, D, Q, P) per level."""
    B, _, H, D = value.shape
    _, Q, _, Lv, P, _ = sampling_locations.shape
    value_list = value.split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2.0 * sampling_locations - 1.0
    out = value.new_zeros((B * H, D, Q))
    att = attention_weights.transpose(1, 2).reshape(B * H, 1, Q, Lv, P)
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value_list[lvl].flatten(2).transpose(1, 2).reshape(B * H, D, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)   # BH,Q,P,2
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)                  # BH,D,Q,P
        out = out + (s * att[:, :, :, lvl]).sum(-1)
    return out.view(B, H * D, Q).transpose(1, 2).contiguous()


def msda_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/msda.cu`` on contiguous fp32 CUDA tensors."""
    B, L, H, D = value.shape
    _, Q, _, Lv, P, _ = sampling_locations.shape
    _build.require_cuda_tensor(value, "msda_fwd value", torch.float32, 4)
    _build.require_cuda_tensor(sampling_locations, "msda_fwd locations",
                               torch.float32, 6)
    _build.require_cuda_tensor(attention_weights, "msda_fwd weights",
                               torch.float32, 5)
    table, start = [], 0
    for h, w in spatial_shapes:
        table += [h, w, start]
        start += h * w
    level_table = torch.tensor(table, dtype=torch.int32, device=value.device)
    lib = _build.load("msda", _SIGNATURES)
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    status = lib.msda_fwd(
        _build.ptr(value), _build.ptr(level_table),
        _build.ptr(sampling_locations), _build.ptr(attention_weights),
        _build.ptr(out), B, L, H, D, Q, Lv, P,
        _build.stream_ptr(value.device))
    _build.check(status, "msda_fwd")
    msda_fwd.launches += 1
    return out


msda_fwd.launches = 0
_SIGNATURES = {"msda_fwd": (
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.I64,
    _build.I32, _build.I32, _build.I32, _build.I32, _build.I32, _build.I32,
    _build.PTR)}


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention.

    Args:
      value: (B, L, H, D), L = sum(h * w for h, w in spatial_shapes).
      spatial_shapes: (h, w) per level.
      sampling_locations: (B, Q, H, Lv, P, 2) normalized [0, 1] (x, y).
      attention_weights: (B, Q, H, Lv, P), softmaxed over Lv * P.
    Returns:
      (B, Q, H * D) fp32.
    """
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, L, H, D = value.shape
    if L != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"ms_deform_attn: L={L} vs shapes {spatial_shapes}")
    if (sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2
            or sampling_locations.shape[0] != B
            or sampling_locations.shape[2] != H
            or sampling_locations.shape[3] != len(spatial_shapes)
            or attention_weights.shape != sampling_locations.shape[:-1]):
        raise ValueError(
            "ms_deform_attn: locations (B, Q, H, Lv, P, 2) / weights "
            f"(B, Q, H, Lv, P) expected, got {tuple(sampling_locations.shape)}"
            f" / {tuple(attention_weights.shape)}")
    if not value.is_cuda:
        return ms_deform_attn_plain(value.float(), spatial_shapes,
                                    sampling_locations.float(),
                                    attention_weights.float())
    return msda_fwd(value.float().contiguous(), spatial_shapes,
                    sampling_locations.float().contiguous(),
                    attention_weights.float().contiguous())
