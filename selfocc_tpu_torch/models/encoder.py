"""TPVFormer encoder (TPV path) and BEVFormer encoder (BEV path) —
counterpart of ``selfocc_tpu/models/encoder.py``.

Module names follow the reference tree so the state-dict keys are the
reference's ``encoder.*`` keys (``layers.{n}.attentions.0.*`` for the
cross-view hybrid self-attention, ``layers.{n}.attentions.1.attn_{hw,zh,wz}.*``
for the per-plane image cross-attention, ``ffns.0.layers.*``,
``norms.{0,1,2}``; the BEV path's ``layers.{n}.attentions.0`` for the
single-plane deformable self-attention and ``layers.{n}.attentions.1`` for
the image cross-attention, ``encoder.positional_encoding.position_layer``
for its position embedding). The JAX package's ``nn.scan`` over layers becomes an
``nn.ModuleList``; its ``DeformHeads`` submodule becomes ``deform_heads``, a
function over the attention's own ``sampling_offsets``/``attention_weights``
Linears (the reference keeps those on the attention module).

``CameraAwareSE`` (``camera_aware``) gates the image features by the
cameras' intrinsics and poses before the encoder flattens them; the
reference's import map has no keys for it, so its parameters carry the
JAX module's names under ``encoder.camera_se_net.`` (``bn``,
``context_mlp_fc1``, ``context_mlp_fc2``, ``context_conv``, and
``reduce_conv`` / ``reduce_bn`` where its mid width is not
``embed_dims``). ``multi_plane_ffn_norm`` gives each plane its own
LayerNorms and FFN (the reference's MultiPlaneNorm / MultiPlaneFFN),
``norms.{j}.{plane}`` and ``ffns.{plane}`` (plane 0, 1, 2 = hw, zh, wz).

The encoder's recipe options are ported: head-shared sampling locations
(``shared_locations``, ``DeformHeads`` averages the offsets over heads and
the shared MSDA op reads one set), visibility compaction of the image
cross-attention (``visible_capacity`` < 1, per plane) and bf16-rounded
attention values (``value_bf16``). The TPU layout levers (bundling,
point/query chunking) are fp reassociations that the MSDA kernels stand in
for. Dropout (p = ``EncoderConfig.dropout``)
sits where the JAX package has it (``encoder.py:270,387,404,406``): after the
self-attention's and each cross-attention's output projection and twice in
the FFN. It is active in train mode only and draws its masks from an explicit
``torch.Generator`` passed to ``forward``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..geometry.mappings import make_mapping
from ..geometry.projection import point_sampling
from ..ops.msda import ms_deform_attn
from ..parallel.mesh import gather_rows
from .initializers import normal_, xavier_uniform_
from .resnet import BatchNorm2d
from .lifter import (TPVPositionalEncoding, fourier_feat_from_meter,
                     tpv_plane_meters)

LN_EPS = 1e-6   # flax nn.LayerNorm default


# --------------------------------------------------------------------- utils
def get_cross_view_ref_points(tpv_h, tpv_w, tpv_z,
                              num_points_in_pillar) -> np.ndarray:
    """Cross-plane 2D reference points for hybrid self-attention (reference
    ``tpvformer/utils.py:5-75``, offset 0 as the encoder calls it). Returns
    (hw+zh+wz, 3, P, 2) float32."""
    p0, p1, p2 = num_points_in_pillar

    def lin(n, steps):
        return (np.linspace(0, n - 1, steps) / n).astype(np.float32)

    h_r = np.repeat(lin(tpv_h, tpv_h), tpv_w)
    w_r = np.tile(lin(tpv_w, tpv_w), tpv_h)
    hw_hw = np.stack([w_r, h_r], -1)[:, None, :].repeat(p2, 1)
    z_r = np.broadcast_to(lin(tpv_z, p2)[None], (tpv_h * tpv_w, p2))
    h_q = np.repeat(lin(tpv_h, tpv_h), tpv_w)[:, None].repeat(p2, 1)
    hw_zh = np.stack([h_q, z_r], -1)
    w_q = np.tile(lin(tpv_w, tpv_w), tpv_h)[:, None].repeat(p2, 1)
    hw_wz = np.stack([z_r, w_q], -1)

    w_r = np.broadcast_to(lin(tpv_w, p1)[None], (tpv_z * tpv_h, p1))
    h_q = np.tile(lin(tpv_h, tpv_h), tpv_z)[:, None].repeat(p1, 1)
    zh_hw = np.stack([w_r, h_q], -1)
    z_q = np.repeat(lin(tpv_z, tpv_z), tpv_h)[:, None].repeat(p1, 1)
    zh_zh = np.stack([h_q, z_q], -1)
    zh_wz = np.stack([z_q, w_r], -1)

    h_r = np.broadcast_to(lin(tpv_h, p0)[None], (tpv_w * tpv_z, p0))
    w_q = np.repeat(lin(tpv_w, tpv_w), tpv_z)[:, None].repeat(p0, 1)
    wz_hw = np.stack([w_q, h_r], -1)
    z_q = np.tile(lin(tpv_z, tpv_z), tpv_w)[:, None].repeat(p0, 1)
    wz_zh = np.stack([h_r, z_q], -1)
    wz_wz = np.stack([z_q, w_q], -1)

    return np.concatenate([
        np.stack([hw_hw, hw_zh, hw_wz], 1),
        np.stack([zh_hw, zh_zh, zh_wz], 1),
        np.stack([wz_hw, wz_zh, wz_wz], 1)], 0)


def tpv_ref_3d(mapping, num_points_cross) -> Tuple[torch.Tensor, ...]:
    """Per-plane 3D reference pillars (reference
    ``tpvformer_encoder.py:131-154``): three (P, Q, 3) metric tensors."""
    H, W, D = mapping.size_h, mapping.size_w, mapping.size_d
    ah = np.arange(H, dtype=np.float32)
    aw = np.arange(W, dtype=np.float32)
    ad = np.arange(D, dtype=np.float32)
    p_hw, p_zh, p_wz = (num_points_cross[2], num_points_cross[1],
                        num_points_cross[0])

    def to_meter(grid, q, p):
        m = mapping.grid2meter(torch.from_numpy(np.ascontiguousarray(grid)))
        return m.reshape(q, p, 3).transpose(0, 1).contiguous()

    ud = np.linspace(0, D - 1, p_hw, dtype=np.float32)
    hw = np.stack(np.broadcast_arrays(
        ah[:, None, None], aw[None, :, None], ud[None, None, :]), -1)
    uw = np.linspace(0, W - 1, p_zh, dtype=np.float32)
    zh = np.stack(np.broadcast_arrays(
        ah[None, :, None], uw[None, None, :], ad[:, None, None]), -1)
    uh = np.linspace(0, H - 1, p_wz, dtype=np.float32)
    wz = np.stack(np.broadcast_arrays(
        uh[None, None, :], aw[:, None, None], ad[None, :, None]), -1)
    return (to_meter(hw, H * W, p_hw), to_meter(zh, D * H, p_zh),
            to_meter(wz, W * D, p_wz))


def offset_bias_init(num_heads, num_levels, num_points,
                     scale_by_point) -> np.ndarray:
    """mmcv directional init for the sampling-offset bias
    (``image_cross_attention.py:226-244``; the cross-view/mmcv variant also
    scales by point index). Flat (H * L * P * 2,) float32."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    if scale_by_point:
        grid = grid * (np.arange(1, num_points + 1, dtype=np.float32)
                       [None, None, :, None])
    return grid.reshape(-1).astype(np.float32)


def dropout(x, p: float, training: bool, generator, rows=None):
    """flax ``nn.Dropout``: keep with probability 1 - p, scale by
    1 / (1 - p); the identity at eval or p = 0. ``rows`` (a
    ``parallel.mesh.RowShard``): ``x`` holds a rank's rows of a longer
    sequence (dim 1); the mask is drawn for the whole sequence, as one
    process draws it, and the rank keeps its rows."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    shape = x.shape if rows is None else \
        (x.shape[0], rows.n) + tuple(x.shape[2:])
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    if rows is not None:
        keep = rows.take(keep)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def deform_heads(query, sampling_offsets: nn.Linear,
                 attention_weights: nn.Linear, H: int, L: int, P: int,
                 shared_locations: bool = False):
    """Query -> sampling offsets (B, Q, H, L, P, 2) and softmaxed attention
    weights (B, Q, H, L, P) (the JAX package's ``DeformHeads``). With
    ``shared_locations`` the offsets are averaged over heads, (B, Q, L, P,
    2): the JAX package broadcasts that mean to every head and its shared
    op reads head 0 (``encoder.py:164-166``)."""
    B, Q, _ = query.shape
    offsets = sampling_offsets(query).reshape(B, Q, H, L, P, 2)
    if shared_locations:
        offsets = offsets.mean(dim=2)
    attn = attention_weights(query).reshape(B, Q, H, L * P)
    attn = torch.softmax(attn, dim=-1).reshape(B, Q, H, L, P)
    return offsets, attn


def bf16_rounded(x):
    """``x`` rounded to bf16 and back: the JAX package's bf16 attention
    payloads (``value_bf16``), gathered by the fp32 kernels."""
    return x.to(torch.bfloat16).float()


def visible_rows(Q: int, capacity: float) -> int:
    """Queries per camera that the compacted image cross-attention runs:
    ``min(Q, ceil(int(Q * capacity) / 128) * 128)`` (``encoder.py:337``),
    Q for a capacity of 1."""
    if capacity >= 1.0:
        return Q
    return min(Q, -(-int(Q * capacity) // 128) * 128)


def visible_first(hit, M: int):
    """(cams, M) query indices of each camera, its visible queries first in
    their order (a stable ``argsort`` of ``~hit``, (cams, Q) bool)."""
    return torch.argsort((~hit).to(torch.uint8), dim=1, stable=True)[:, :M]


def gather_visible(sel, hit, ref_cams, offsets, attn):
    """The compacted image cross-attention's query-side tensors at ``sel``
    (cams, M): the hits and reference points per camera, (cams, M) and
    (cams, M, P, 2); the offsets and weights, (Q, ...) for all cameras,
    as (cams, M, ...)."""
    return (torch.gather(hit, 1, sel),
            torch.take_along_dim(ref_cams, sel[:, :, None, None], 1),
            offsets[sel], attn[sel])


def rows_to_slots(sel, Q: int, *rows):
    """Each (cams, M, ...) tensor of ``rows`` copied into a zeroed (cams,
    Q, ...) one at ``sel``; each camera's ``sel`` is a permutation's head,
    so no slot is written twice."""
    cams, M = sel.shape
    idx = (sel + Q * torch.arange(cams, device=sel.device)[:, None]
           ).reshape(-1)
    return tuple(
        r.new_zeros((cams * Q,) + r.shape[2:]).index_copy(
            0, idx, r.reshape((cams * M,) + r.shape[2:])).view(
            (cams, Q) + r.shape[2:]) for r in rows)


def plane_capacities(capacity) -> Tuple[float, float, float]:
    """A scalar capacity, or one per plane (hw, zh, wz), as three."""
    if isinstance(capacity, (tuple, list)):
        return tuple(float(c) for c in capacity)
    return (float(capacity),) * 3


def _reset_deform_linears(sampling_offsets, attention_weights, H, L, P,
                          scale_by_point):
    sampling_offsets.weight.data.zero_()
    sampling_offsets.bias.data.copy_(torch.from_numpy(
        offset_bias_init(H, L, P, scale_by_point)))
    attention_weights.weight.data.zero_()
    attention_weights.bias.data.zero_()


def _reset_xavier(linear: nn.Linear, generator):
    xavier_uniform_(linear.weight, generator)
    linear.bias.data.zero_()


def _normalizer(spatial_shapes, device):
    """(Lv, 2) float32 (w, h) per level, built once per (shapes, device): a
    host-to-device copy from pageable memory blocks the stream, so it stays
    out of the per-call path."""
    return _normalizer_table(
        tuple((int(h), int(w)) for h, w in spatial_shapes), device)


@functools.lru_cache(maxsize=None)
def _normalizer_table(spatial_shapes, device):
    return torch.tensor([[w, h] for h, w in spatial_shapes],
                        dtype=torch.float32, device=device)


# ----------------------------------------------------------------- attention
class CrossViewHybridAttention(nn.Module):
    """TPV self-attention across the 3 planes (reference
    ``cross_view_hybrid_attention.py:12-124``): the planes are the 3 levels of
    a deformable attention over the concatenated plane sequence."""

    def __init__(self, embed_dims: int, num_heads: int, num_points: int,
                 dropout_p: float = 0.0, shared_locations: bool = False,
                 value_bf16: bool = False):
        super().__init__()
        self.num_heads, self.num_points = num_heads, num_points
        self.dropout_p = dropout_p
        self.shared_locations, self.value_bf16 = shared_locations, value_bf16
        self.sampling_offsets = nn.Linear(embed_dims,
                                          num_heads * 3 * num_points * 2)
        self.attention_weights = nn.Linear(embed_dims,
                                           num_heads * 3 * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def reset_parameters_like_jax(self, generator):
        _reset_deform_linears(self.sampling_offsets, self.attention_weights,
                              self.num_heads, 3, self.num_points, True)
        _reset_xavier(self.value_proj, generator)
        _reset_xavier(self.output_proj, generator)

    def forward(self, query, query_pos, ref_points, spatial_shapes,
                generator=None, rows=None):
        # query (B, Qtot, C); ref_points (Qtot, 3, P, 2). ``rows`` (a
        # parallel.mesh.RowShard of the sequence): query and query_pos hold
        # this rank's rows; the value is gathered whole, in global order
        B, Q, C = query.shape
        H = self.num_heads
        value = self.value_proj(query)
        if self.value_bf16:
            value = bf16_rounded(value)
        if rows is not None:
            value = gather_rows(value, rows)
            ref_points = rows.take(ref_points, 0)
        value = value.reshape(B, -1, H, C // H)
        shared = self.shared_locations
        offsets, attn = deform_heads(query + query_pos, self.sampling_offsets,
                                     self.attention_weights, H, 3,
                                     self.num_points, shared)
        norm = _normalizer(spatial_shapes, query.device)
        if shared:
            loc = ref_points[None] + offsets / norm[None, None, :, None, :]
        else:
            loc = ref_points[None, :, None] + \
                offsets / norm[None, None, None, :, None, :]
        out = ms_deform_attn(value, spatial_shapes, loc, attn, shared)
        out = dropout(self.output_proj(out), self.dropout_p, self.training,
                      generator, rows)
        return out + query


class BEVDeformableAttention(nn.Module):
    """Parameter holder named after the reference's
    ``deformable_attention`` submodule (``image_cross_attention.py:218-223``)."""

    def __init__(self, embed_dims: int, num_heads: int, num_levels: int,
                 num_points: int):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = (
            num_heads, num_levels, num_points)
        self.sampling_offsets = nn.Linear(
            embed_dims, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(
            embed_dims, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)

    def reset_parameters_like_jax(self, generator):
        _reset_deform_linears(self.sampling_offsets, self.attention_weights,
                              self.num_heads, self.num_levels,
                              self.num_points, False)
        _reset_xavier(self.value_proj, generator)


class BEVCrossAttention(nn.Module):
    """Image cross-attention for one TPV plane (``encoder.py:311-390``).

    Dense branch (``visible_capacity`` 1): deformable attention runs for
    every (camera, query) pair, hits are masked, summed over cameras and
    divided by the per-query hit count.

    Compact branch (``visible_capacity`` < 1, the reference's rebatch of
    visible queries): each camera runs MSDA on ``visible_rows(Q, capacity)``
    = M queries, taken in a visible-first stable order
    (``argsort(~hit, stable=True)``), each result weighted by its hit. The
    JAX package scatter-adds the contributions and hit counts into the
    slots; here each camera's rows are copied into a zeroed (cams, Q, C)
    buffer (its ``sel`` is a permutation, so no slot is written twice) and
    summed over cameras in the dense branch's order, and the counts come the
    same way from the selected hits. While no camera sees more than M
    queries the forward is therefore the dense branch's bit for bit; past
    that, both packages drop the same queries (the overflow, see
    ``TPVFormerEncoder.visible_overflow``). M is a Python int of static
    shapes: no host synchronisation.

    ``rows`` (a ``parallel.mesh.RowShard`` of the plane): ``query`` holds
    this rank's rows of the plane, ``ref_cams`` and ``masks`` the whole
    plane's. The dense branch runs on the rank's rows. The compact one
    gathers the plane's query and runs over the whole plane, since each
    camera's visible-first order is the whole plane's, then keeps the
    rank's rows: the one-process result either way."""

    def __init__(self, embed_dims: int, num_heads: int, num_levels: int,
                 num_points: int, dropout_p: float = 0.0,
                 shared_locations: bool = False,
                 visible_capacity: float = 1.0, value_bf16: bool = False):
        super().__init__()
        self.deformable_attention = BEVDeformableAttention(
            embed_dims, num_heads, num_levels, num_points)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.dropout_p = dropout_p
        self.shared_locations = shared_locations
        self.visible_capacity = visible_capacity
        self.value_bf16 = value_bf16

    def reset_parameters_like_jax(self, generator):
        _reset_xavier(self.output_proj, generator)

    def forward(self, query, value, ref_cams, masks, spatial_shapes,
                generator=None, rows=None):
        # query (1, Q, C); value (cams, L, C); ref_cams (cams, Q, P, 2);
        # masks (cams, Q, P)
        Q = query.shape[1] if rows is None else rows.n
        M = visible_rows(Q, self.visible_capacity)
        if rows is None:
            slots = self._slots(query, value, ref_cams, masks,
                                spatial_shapes, M)
        elif M < Q:
            slots = rows.take(self._slots(gather_rows(query, rows), value,
                                          ref_cams, masks, spatial_shapes, M))
        else:
            slots = self._slots(query, value, rows.take(ref_cams),
                                rows.take(masks), spatial_shapes, rows.count)
        slots = dropout(self.output_proj(slots), self.dropout_p,
                        self.training, generator, rows)
        return slots + query

    def _slots(self, query, value, ref_cams, masks, spatial_shapes, M):
        """Each query's image cross-attention, averaged over the cameras
        that see it, before the output projection: (1, Q, C); compacted
        to M rows a camera where M < Q."""
        da = self.deformable_attention
        _, Q, C = query.shape
        cams = value.shape[0]
        H = da.num_heads
        v = da.value_proj(value).reshape(cams, -1, H, C // H)
        if self.value_bf16:
            v = bf16_rounded(v)
        shared = self.shared_locations
        offsets, attn = deform_heads(query, da.sampling_offsets,
                                     da.attention_weights, H, da.num_levels,
                                     da.num_points, shared)
        norm = _normalizer(spatial_shapes, query.device)
        hit = masks.sum(-1) > 0                               # (cams, Q)
        if M < Q:
            sel = visible_first(hit, M)                       # (cams, M)
            hit, ref, off, attn_c = gather_visible(sel, hit, ref_cams,
                                                   offsets[0], attn[0])
        else:
            ref, off = ref_cams, offsets[0][None]
            attn_c = attn[0][None].expand((cams,) + attn.shape[1:])
        # the reference broadcasts the P pillar points against the
        # per-(head, level) offsets (image_cross_attention.py:323-328)
        if shared:
            loc = ref[:, :, None] + off / norm[None, None, :, None, :]
        else:
            loc = ref[:, :, None, None] + \
                off / norm[None, None, None, :, None, :]
        out = ms_deform_attn(v, spatial_shapes, loc, attn_c, shared)
        hitf = hit.to(out.dtype)
        contrib = out * hitf[..., None]                       # cams, M, C
        if M < Q:
            contrib, hitf = rows_to_slots(sel, Q, contrib, hitf)
        slots = contrib.sum(0)
        count = hitf.sum(0).clamp_min(1.0)
        return (slots / count[..., None])[None]


class TPVImageCrossAttention(nn.Module):
    """The three per-plane cross-attentions, named as the reference's
    ``attentions.1.attn_{hw,zh,wz}``. Per-plane point counts follow the
    reference: hw -> num_points_cross[2], zh -> [1], wz -> [0];
    ``visible_capacity`` is a scalar or one per plane (hw, zh, wz)."""

    PLANES = ("hw", "zh", "wz")

    def __init__(self, embed_dims, num_heads, num_levels, num_points_cross,
                 dropout_p: float = 0.0, shared_locations: bool = False,
                 visible_capacity=1.0, value_bf16: bool = False):
        super().__init__()
        caps = plane_capacities(visible_capacity)
        for i, plane in enumerate(self.PLANES):
            self.add_module(f"attn_{plane}", BEVCrossAttention(
                embed_dims, num_heads, num_levels, num_points_cross[2 - i],
                dropout_p, shared_locations, caps[i], value_bf16))

    def forward(self, planes, value, ref_cams_list, masks_list,
                spatial_shapes, generator=None,
                shard=None) -> List[torch.Tensor]:
        return [getattr(self, f"attn_{plane}")(
                    planes[i], value, ref_cams_list[i], masks_list[i],
                    spatial_shapes, generator,
                    None if shard is None else shard.planes[i])
                for i, plane in enumerate(self.PLANES)]


class FFN(nn.Module):
    """mmcv FFN (2 Linears, ReLU, dropout after each) with residual; keys
    ``layers.0.0`` and ``layers.1`` as in mmcv."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dropout_p: float = 0.0):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels),
                          nn.ReLU()),
            nn.Linear(feedforward_channels, embed_dims))
        self.dropout_p = dropout_p

    def forward(self, x, generator=None, rows=None):
        y = dropout(self.layers[0](x), self.dropout_p, self.training,
                    generator, rows)
        y = dropout(self.layers[1](y), self.dropout_p, self.training,
                    generator, rows)
        return y + x


class CameraAwareSE(nn.Module):
    """Camera-conditioned SE gating of the image features
    (``encoder.py:170-231``, reference ``camera_se_net.py:52-131``): per
    camera the 16 numbers [fx, fy, cx, cy, cam2ego[:3, :]] -> BatchNorm ->
    Linear, ReLU, Linear -> sigmoid gate; per level (the convs and the
    BatchNorm shared across levels) the reduce conv (3x3, BatchNorm, ReLU;
    only where ``in_channels != mid_channels``) -> gated -> 1x1 conv. The
    second Linear starts at zero weights and bias 10, so the gate starts
    near 1. BatchNorm is flax's (momentum 0.99): batch statistics in train
    mode. Features are (B, N, h, w, C) channel-last, in and out."""

    def __init__(self, in_channels: int, mid_channels: int,
                 out_channels: int):
        super().__init__()
        self.bn = BatchNorm2d(16, momentum=0.99)
        self.context_mlp_fc1 = nn.Linear(16, mid_channels)
        self.context_mlp_fc2 = nn.Linear(mid_channels, mid_channels)
        if in_channels != mid_channels:
            self.reduce_conv = nn.Conv2d(in_channels, mid_channels, 3,
                                         padding=1)
            self.reduce_bn = BatchNorm2d(mid_channels, momentum=0.99)
        else:
            self.reduce_conv = self.reduce_bn = None
        self.context_conv = nn.Conv2d(mid_channels, out_channels, 1)

    def reset_parameters_like_jax(self, generator):
        self.context_mlp_fc2.weight.data.zero_()
        self.context_mlp_fc2.bias.data.fill_(10.0)

    def forward(self, ms_img_feats, intrinsic, cam2ego):
        B, N = intrinsic.shape[:2]
        mlp_in = torch.cat([
            torch.stack([intrinsic[..., 0, 0], intrinsic[..., 1, 1],
                         intrinsic[..., 0, 2], intrinsic[..., 1, 2]], -1),
            cam2ego[..., :3, :].reshape(B, N, 12)], -1).float()
        mlp_in = self.bn(mlp_in.reshape(B * N, 16, 1, 1)).reshape(B * N, 16)
        h = torch.relu(self.context_mlp_fc1(mlp_in))
        gate = torch.sigmoid(self.context_mlp_fc2(h))[:, :, None, None]
        outputs = []
        for f in ms_img_feats:
            x = f.reshape((B * N,) + f.shape[2:]).permute(0, 3, 1, 2)
            if self.reduce_conv is not None:
                x = torch.relu(self.reduce_bn(self.reduce_conv(x)))
            x = self.context_conv(x * gate)
            outputs.append(x.permute(0, 2, 3, 1).reshape(
                (B, N) + x.shape[2:] + (x.shape[1],)))
        return outputs


class TPVFormerLayer(nn.Module):
    """``self_attn -> norm -> cross_attn -> norm -> ffn -> norm``
    (post-norm, reference ``tpvformer_encoder_layer.py:123-219``); with
    ``multi_plane`` (``multi_plane_ffn_norm``) each plane has its own
    LayerNorms (``norms.{j}.{plane}``) and FFN (``ffns.{plane}``).
    ``shard`` (a ``parallel.mesh.ModelShard``): ``planes`` and ``tpv_pos``
    hold this rank's rows of each plane (the model-parallel step); the
    norms and FFNs act row by row, the attentions take the shard."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points_cross,
                 num_points_self, feedforward_channels, tpv_size,
                 dropout_p: float = 0.0, shared_locations: bool = False,
                 visible_capacity=1.0, value_bf16: bool = False,
                 multi_plane: bool = False):
        super().__init__()
        self.tpv_size = tuple(tpv_size)
        self.multi_plane = multi_plane
        self.attentions = nn.ModuleList([
            CrossViewHybridAttention(embed_dims, num_heads, num_points_self,
                                     dropout_p, shared_locations, value_bf16),
            TPVImageCrossAttention(embed_dims, num_heads, num_levels,
                                   num_points_cross, dropout_p,
                                   shared_locations, visible_capacity,
                                   value_bf16)])
        n = 3 if multi_plane else 1
        self.ffns = nn.ModuleList(
            FFN(embed_dims, feedforward_channels, dropout_p)
            for _ in range(n))
        if multi_plane:
            self.norms = nn.ModuleList(
                nn.ModuleList(nn.LayerNorm(embed_dims, eps=LN_EPS)
                              for _ in range(3)) for _ in range(3))
        else:
            self.norms = nn.ModuleList(
                nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3))

    def forward(self, planes, value, tpv_pos, cross_view_ref, ref_cams_list,
                masks_list, img_spatial_shapes, generator=None, shard=None):
        H, W, D = self.tpv_size
        sizes = [p.shape[1] for p in planes]
        plane_shapes = ((H, W), (D, H), (W, D))
        seq, plane_rows = (None, (None,) * 3) if shard is None else \
            (shard.seq, shard.planes)
        q = self.attentions[0](torch.cat(planes, 1), torch.cat(tpv_pos, 1),
                               cross_view_ref, plane_shapes, generator, seq)
        if self.multi_plane:
            planes = [n(p) for n, p in zip(self.norms[0],
                                           q.split(sizes, dim=1))]
        else:
            planes = list(self.norms[0](q).split(sizes, dim=1))
        planes = self.attentions[1](planes, value, ref_cams_list, masks_list,
                                    img_spatial_shapes, generator, shard)
        if self.multi_plane:
            return [n3(ffn(n2(p), generator, r)) for n2, ffn, n3, p, r in zip(
                self.norms[1], self.ffns, self.norms[2], planes, plane_rows)]
        q = self.norms[1](torch.cat(planes, 1))
        q = self.norms[2](self.ffns[0](q, generator, seq))
        return list(q.split(sizes, dim=1))


class TPVFormerEncoder(nn.Module):
    """The full encoder (reference ``tpvformer_encoder.py:20-290``).

    ``shared_locations``, ``visible_capacity`` (a scalar or one per plane,
    hw, zh, wz) and ``attn_value_bf16``: see ``BEVCrossAttention``. Where a
    plane is compacted, each forward leaves ``visible_overflow``: per plane
    a 0-d tensor on the device, ``max(hits.max() - M, 0)`` with hits the
    visible queries of its busiest camera (``encoder.py:916-930``; the JAX
    package sows it as ``visible_overflow_i``); the compaction is exact
    while all three are 0. Nothing in the forward reads it back. None where
    no plane is compacted. ``plane_sizes``: the rows of hw, zh and wz.

    ``forward(..., shard=)`` (a ``parallel.mesh.ModelShard``) runs the
    model-parallel step's share of the encoder (the JAX package's
    ``maybe_shard`` at each layer's entry, ``encoder.py:457-462``): the
    lifter's planes and ``tpv_pos`` are cut to the rank's rows of each
    plane, every layer runs on those rows (``TPVFormerLayer``), and after
    the last layer ``gather_rows`` returns the whole planes on every rank.
    The geometry (``point_sampling``, ``visible_overflow``) is the whole
    planes'."""

    def __init__(self, mapping_args: Dict, embed_dims: int = 96,
                 num_heads: int = 6, num_cams: int = 6,
                 num_feature_levels: int = 4,
                 num_points_cross: Sequence[int] = (64, 64, 8),
                 num_points_self: int = 16, num_layers: int = 4,
                 feedforward_channels: int = 192,
                 pos_num_freqs: Sequence[int] = (12, 12, 12),
                 pc_range: Sequence[float] = (-40., -40., -1., 40., 40., 5.4),
                 dropout_p: float = 0.0, shared_locations: bool = False,
                 visible_capacity=1.0, attn_value_bf16: bool = False,
                 multi_plane_ffn_norm: bool = False,
                 camera_aware: bool = False,
                 camera_aware_mid_channels=None):
        super().__init__()
        self.visible_capacity = plane_capacities(visible_capacity)
        # the reference encoder's default mid width is embed_dims, which
        # skips CameraAwareSE's reduce conv (encoder.py:867-880)
        self.camera_se_net = CameraAwareSE(
            embed_dims, camera_aware_mid_channels or embed_dims,
            embed_dims) if camera_aware else None
        self.visible_overflow = None
        mapping = make_mapping(**mapping_args)
        self.tpv_size = (mapping.size_h, mapping.size_w, mapping.size_d)
        H, W, D = self.tpv_size
        self.plane_sizes = (H * W, D * H, W * D)
        self.positional_encoding = TPVPositionalEncoding(
            tuple(pos_num_freqs), embed_dims, tuple(pc_range), mapping)
        self.level_embeds = nn.Parameter(
            torch.zeros(num_feature_levels, embed_dims))
        self.cams_embeds = nn.Parameter(torch.zeros(num_cams, embed_dims))
        self.layers = nn.ModuleList(
            TPVFormerLayer(embed_dims, num_heads, num_feature_levels,
                           tuple(num_points_cross), num_points_self,
                           feedforward_channels, self.tpv_size, dropout_p,
                           shared_locations, visible_capacity,
                           attn_value_bf16, multi_plane_ffn_norm)
            for _ in range(num_layers))
        # geometry tables (the JAX package's 'consts' collection): derived
        # from the config alone, so not part of the state dict
        for name, ref in zip(("hw", "zh", "wz"),
                             tpv_ref_3d(mapping, tuple(num_points_cross))):
            self.register_buffer(f"ref_3d_{name}", ref, persistent=False)
        self.register_buffer(
            "cross_view_ref",
            torch.from_numpy(get_cross_view_ref_points(
                H, W, D, (num_points_self,) * 3)), persistent=False)

    def reset_parameters_like_jax(self, generator):
        normal_(self.level_embeds, 1.0, generator)
        normal_(self.cams_embeds, 1.0, generator)

    def forward(self, representation, ms_img_feats, lidar2img, img_shape,
                generator=None, focal_ratios_x=None, focal_ratios_y=None,
                intrinsic=None, cam2ego=None, shard=None):
        """representation: [hw (1,HW,C), zh (1,DH,C), wz (1,WD,C)];
        ms_img_feats: list of (1, N, h, w, C); lidar2img (1, N, 4, 4);
        img_shape: (H, W) of the network input; ``generator`` draws the
        train-mode dropout masks; ``focal_ratios_x/y``: optional (N,)
        scales of the projected reference points (``point_sampling``);
        ``intrinsic`` / ``cam2ego`` (1, N, 4, 4): the cameras that a
        camera-aware encoder gates the features by (required then);
        ``shard``: see the class."""
        if ms_img_feats[0].shape[0] != 1:
            raise ValueError("the TPV encoder runs batch size 1")
        tpv_pos = [p[None] for p in self.positional_encoding()]
        if self.camera_se_net is not None:
            if intrinsic is None or cam2ego is None:
                raise ValueError("camera_aware=True needs intrinsic/cam2ego "
                                 "in the batch")
            ms_img_feats = self.camera_se_net(ms_img_feats, intrinsic,
                                              cam2ego)
        feats, img_spatial_shapes = [], []
        for lvl, feat in enumerate(ms_img_feats):
            _, N, h, w, C = feat.shape
            f = feat.reshape(N, h * w, C) + self.cams_embeds[:, None, :]
            feats.append(f + self.level_embeds[lvl][None, None, :])
            img_spatial_shapes.append((h, w))
        value = torch.cat(feats, dim=1)                    # (N, L, C)
        ref_cams_list, masks_list = [], []
        for ref in (self.ref_3d_hw, self.ref_3d_zh, self.ref_3d_wz):
            rc, m = point_sampling(ref, lidar2img, img_shape, focal_ratios_x,
                                   focal_ratios_y)
            ref_cams_list.append(rc[:, 0])
            masks_list.append(m[:, 0])
        if min(self.visible_capacity) < 1.0:
            self.visible_overflow = tuple(
                ((m.sum(-1) > 0).sum(1).max()
                 - visible_rows(m.shape[1], cap)).clamp_min(0)
                for m, cap in zip(masks_list, self.visible_capacity))
        planes = list(representation)
        if shard is not None:
            planes = [r.take(p) for r, p in zip(shard.planes, planes)]
            tpv_pos = [r.take(p) for r, p in zip(shard.planes, tpv_pos)]
        for layer in self.layers:
            planes = layer(planes, value, tpv_pos, self.cross_view_ref,
                           ref_cams_list, masks_list,
                           tuple(img_spatial_shapes), generator, shard)
        if shard is not None:
            planes = list(gather_rows(torch.cat(planes, 1), shard.seq).split(
                self.plane_sizes, dim=1))
        return planes


# ------------------------------------------------------------------ BEV path
class DeformableSelfAttention(nn.Module):
    """Single-plane MSDA self-attention of the BEV path (``encoder.py:545-588``,
    mmcv ``MultiScaleDeformableAttention``): the value is projected from the
    query alone, the heads read query + pos; one level, offsets initialised
    scaled by point index; locations ``ref_2d + offsets / (w, h)``."""

    def __init__(self, embed_dims: int, num_heads: int, num_points: int,
                 dropout_p: float = 0.0, value_bf16: bool = False):
        super().__init__()
        self.num_heads, self.num_points = num_heads, num_points
        self.dropout_p, self.value_bf16 = dropout_p, value_bf16
        self.sampling_offsets = nn.Linear(embed_dims,
                                          num_heads * num_points * 2)
        self.attention_weights = nn.Linear(embed_dims, num_heads * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def reset_parameters_like_jax(self, generator):
        _reset_deform_linears(self.sampling_offsets, self.attention_weights,
                              self.num_heads, 1, self.num_points, True)
        _reset_xavier(self.value_proj, generator)
        _reset_xavier(self.output_proj, generator)

    def forward(self, query, query_pos, ref_2d, spatial_shape,
                generator=None):
        # query (B, Q, C); ref_2d (Q, 2) normalized; spatial_shape (h, w)
        B, Q, C = query.shape
        H = self.num_heads
        value = self.value_proj(query).reshape(B, Q, H, C // H)
        if self.value_bf16:
            value = bf16_rounded(value)
        offsets, attn = deform_heads(query + query_pos, self.sampling_offsets,
                                     self.attention_weights, H, 1,
                                     self.num_points)
        norm = _normalizer((spatial_shape,), query.device)
        loc = ref_2d[None, :, None, None, None, :] + \
            offsets / norm[None, None, None, :, None, :]
        out = ms_deform_attn(value, (spatial_shape,), loc, attn)
        out = dropout(self.output_proj(out), self.dropout_p, self.training,
                      generator)
        return out + query


class BEVFormerLayer(nn.Module):
    """``self_attn -> norm -> cross_attn -> norm -> ffn -> norm`` on the BEV
    plane (``encoder.py:591-639``, reference
    ``bevformer_encoder_layer.py``); the cross-attention is the TPV path's
    ``BEVCrossAttention`` (dense, or compacted by ``visible_capacity``)."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points_cross,
                 num_points_self, feedforward_channels, bev_size,
                 dropout_p: float = 0.0, visible_capacity: float = 1.0,
                 value_bf16: bool = False):
        super().__init__()
        self.bev_size = tuple(bev_size)
        self.attentions = nn.ModuleList([
            DeformableSelfAttention(embed_dims, num_heads, num_points_self,
                                    dropout_p, value_bf16),
            BEVCrossAttention(embed_dims, num_heads, num_levels,
                              num_points_cross, dropout_p, False,
                              visible_capacity, value_bf16)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       dropout_p)])
        self.norms = nn.ModuleList(
            nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3))

    def forward(self, q, value, bev_pos, ref_2d, ref_cams, masks,
                img_spatial_shapes, generator=None):
        q = self.norms[0](self.attentions[0](q, bev_pos, ref_2d,
                                             self.bev_size, generator))
        q = self.norms[1](self.attentions[1](q, value, ref_cams, masks,
                                             img_spatial_shapes, generator))
        return self.norms[2](self.ffns[0](q, generator))


class BEVPositionalEncoding(nn.Module):
    """Fourier features of the BEV cells' metric (x, y), normalised by
    ``pc_range``, through one Linear (reference
    ``bevformer_pos_embed.py:7-35``)."""

    def __init__(self, num_freqs: int, embed_dims: int, pc_range, mapping):
        super().__init__()
        hw, _, _ = tpv_plane_meters(mapping)
        x0, y0, _, x1, y1, _ = pc_range
        hw = torch.stack([(hw[..., 0] - x0) / (x1 - x0),
                          (hw[..., 1] - y0) / (y1 - y0)], dim=-1)
        feat = fourier_feat_from_meter(num_freqs, hw)
        self.register_buffer("fourier", feat, persistent=False)
        self.position_layer = nn.Linear(feat.shape[-1], embed_dims)

    def forward(self) -> torch.Tensor:
        return self.position_layer(self.fourier)


def bev_ref_3d(mapping, num_points_cross: int) -> torch.Tensor:
    """(P, H * W, 3) metric pillars over the BEV plane, ``num_points_cross``
    points along D (``encoder.py:709-718``)."""
    H, W, D = mapping.size_h, mapping.size_w, mapping.size_d
    ah = np.arange(H, dtype=np.float32)
    aw = np.arange(W, dtype=np.float32)
    ud = np.linspace(0, D - 1, num_points_cross, dtype=np.float32)
    grid = np.stack(np.broadcast_arrays(
        ah[:, None, None], aw[None, :, None], ud[None, None, :]), -1)
    m = mapping.grid2meter(torch.from_numpy(np.ascontiguousarray(grid)))
    return m.reshape(H * W, num_points_cross, 3).transpose(0, 1).contiguous()


def bev_ref_2d(H: int, W: int) -> torch.Tensor:
    """(H * W, 2) self-attention reference points, stored (h_norm, w_norm)
    as the reference stores them. MSDA reads ``[..., 0]`` as x, so the
    reference self-attends at transposed grid locations; kept for
    checkpoint parity (``encoder.py:724-735``)."""
    ah = np.arange(H, dtype=np.float32)
    aw = np.arange(W, dtype=np.float32)
    gh = np.repeat(ah / max(H - 1, 1), W)
    gw = np.tile(aw / max(W - 1, 1), H)
    return torch.from_numpy(np.stack([gh, gw], -1).astype(np.float32))


class BEVFormerEncoder(nn.Module):
    """The single-plane BEVFormer encoder (``encoder.py:642-763``, reference
    ``bevformer/bevformer_encoder.py:18-224``) of ``nuscenes_occ_bev``:
    positional encoding, level and camera embeddings, pillar reference
    points projected into the cameras, then ``num_layers`` layers. The JAX
    package's ``remat_layers`` (a TPU memory lever) is not copied."""

    def __init__(self, mapping_args: Dict, embed_dims: int = 96,
                 num_heads: int = 6, num_cams: int = 6,
                 num_feature_levels: int = 4, num_points_cross: int = 8,
                 num_points_self: int = 12, num_layers: int = 4,
                 feedforward_channels: int = 192,
                 pos_num_freqs: Sequence[int] = (12, 12, 12),
                 pc_range: Sequence[float] = (-40., -40., -1., 40., 40., 5.4),
                 dropout_p: float = 0.0, visible_capacity: float = 1.0,
                 attn_value_bf16: bool = False):
        super().__init__()
        self.visible_overflow = None
        mapping = make_mapping(**mapping_args)
        H, W = mapping.size_h, mapping.size_w
        self.positional_encoding = BEVPositionalEncoding(
            pos_num_freqs[0], embed_dims, tuple(pc_range), mapping)
        self.level_embeds = nn.Parameter(
            torch.zeros(num_feature_levels, embed_dims))
        self.cams_embeds = nn.Parameter(torch.zeros(num_cams, embed_dims))
        self.layers = nn.ModuleList(
            BEVFormerLayer(embed_dims, num_heads, num_feature_levels,
                           num_points_cross, num_points_self,
                           feedforward_channels, (H, W), dropout_p,
                           visible_capacity, attn_value_bf16)
            for _ in range(num_layers))
        # geometry tables (the JAX package's 'consts'), not in the state dict
        self.register_buffer("ref_3d", bev_ref_3d(mapping, num_points_cross),
                             persistent=False)
        self.register_buffer("ref_2d", bev_ref_2d(H, W), persistent=False)

    def reset_parameters_like_jax(self, generator):
        normal_(self.level_embeds, 1.0, generator)
        normal_(self.cams_embeds, 1.0, generator)

    def forward(self, representation, ms_img_feats, lidar2img, img_shape,
                generator=None, focal_ratios_x=None, focal_ratios_y=None):
        """representation: the BEV plane (1, H * W, C) (or a one-element
        list); the rest as ``TPVFormerEncoder.forward``. Returns the plane
        (1, H * W, C)."""
        if ms_img_feats[0].shape[0] != 1:
            raise ValueError("the BEV encoder runs batch size 1")
        bev_pos = self.positional_encoding()[None]
        feats, img_spatial_shapes = [], []
        for lvl, feat in enumerate(ms_img_feats):
            _, N, h, w, C = feat.shape
            f = feat.reshape(N, h * w, C) + self.cams_embeds[:, None, :]
            feats.append(f + self.level_embeds[lvl][None, None, :])
            img_spatial_shapes.append((h, w))
        value = torch.cat(feats, dim=1)                    # (N, L, C)
        rc, m = point_sampling(self.ref_3d, lidar2img, img_shape,
                               focal_ratios_x, focal_ratios_y)
        ref_cams, masks = rc[:, 0], m[:, 0]
        q = representation[0] if isinstance(representation, (list, tuple)) \
            else representation
        for layer in self.layers:
            q = layer(q, value, bev_pos, self.ref_2d, ref_cams, masks,
                      tuple(img_spatial_shapes), generator)
        return q

