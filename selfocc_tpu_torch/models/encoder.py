"""TPVFormer encoder, TPV path — counterpart of
``selfocc_tpu/models/encoder.py``.

Module names follow the reference tree so the state-dict keys are the
reference's ``encoder.*`` keys (``layers.{n}.attentions.0.*`` for the
cross-view hybrid self-attention, ``layers.{n}.attentions.1.attn_{hw,zh,wz}.*``
for the per-plane image cross-attention, ``ffns.0.layers.*``,
``norms.{0,1,2}``). The JAX package's ``nn.scan`` over layers becomes an
``nn.ModuleList``; its ``DeformHeads`` submodule becomes ``deform_heads``, a
function over the attention's own ``sampling_offsets``/``attention_weights``
Linears (the reference keeps those on the attention module).

Only the exact tier is ported: per-head sampling locations and the dense
image cross-attention (``cross_visible_capacity = 1.0``). The TPU layout
levers (bundling, point/query chunking, bf16 payloads) are fp reassociations
that the MSDA kernel stands in for. Dropout (p = ``EncoderConfig.dropout``)
sits where the JAX package has it (``encoder.py:270,387,404,406``): after the
self-attention's and each cross-attention's output projection and twice in
the FFN. It is active in train mode only and draws its masks from an explicit
``torch.Generator`` passed to ``forward``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..geometry.mappings import make_mapping
from ..geometry.projection import point_sampling
from ..ops.msda import ms_deform_attn
from .initializers import normal_, xavier_uniform_
from .lifter import (fourier_feat_from_meter, normalize_plane_meters,
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


def dropout(x, p: float, training: bool, generator):
    """flax ``nn.Dropout``: keep with probability 1 - p, scale by
    1 / (1 - p); the identity at eval or p = 0."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def deform_heads(query, sampling_offsets: nn.Linear,
                 attention_weights: nn.Linear, H: int, L: int, P: int):
    """Query -> sampling offsets (B, Q, H, L, P, 2) and softmaxed attention
    weights (B, Q, H, L, P) (the JAX package's ``DeformHeads``)."""
    B, Q, _ = query.shape
    offsets = sampling_offsets(query).reshape(B, Q, H, L, P, 2)
    attn = attention_weights(query).reshape(B, Q, H, L * P)
    attn = torch.softmax(attn, dim=-1).reshape(B, Q, H, L, P)
    return offsets, attn


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
    return torch.tensor([[w, h] for h, w in spatial_shapes],
                        dtype=torch.float32, device=device)


# ----------------------------------------------------------------- attention
class CrossViewHybridAttention(nn.Module):
    """TPV self-attention across the 3 planes (reference
    ``cross_view_hybrid_attention.py:12-124``): the planes are the 3 levels of
    a deformable attention over the concatenated plane sequence."""

    def __init__(self, embed_dims: int, num_heads: int, num_points: int,
                 dropout_p: float = 0.0):
        super().__init__()
        self.num_heads, self.num_points = num_heads, num_points
        self.dropout_p = dropout_p
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
                generator=None):
        # query (B, Qtot, C); ref_points (Qtot, 3, P, 2)
        B, Q, C = query.shape
        H = self.num_heads
        value = self.value_proj(query).reshape(B, Q, H, C // H)
        offsets, attn = deform_heads(query + query_pos, self.sampling_offsets,
                                     self.attention_weights, H, 3,
                                     self.num_points)
        norm = _normalizer(spatial_shapes, query.device)
        loc = ref_points[None, :, None] + \
            offsets / norm[None, None, None, :, None, :]
        out = ms_deform_attn(value, spatial_shapes, loc, attn)
        out = dropout(self.output_proj(out), self.dropout_p, self.training,
                      generator)
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
    """Image cross-attention for one TPV plane, dense branch
    (``encoder.py:366-383``): deformable attention runs for every
    (camera, query) pair, hits are masked, summed and divided by the
    per-query hit count."""

    def __init__(self, embed_dims: int, num_heads: int, num_levels: int,
                 num_points: int, dropout_p: float = 0.0):
        super().__init__()
        self.deformable_attention = BEVDeformableAttention(
            embed_dims, num_heads, num_levels, num_points)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.dropout_p = dropout_p

    def reset_parameters_like_jax(self, generator):
        _reset_xavier(self.output_proj, generator)

    def forward(self, query, value, ref_cams, masks, spatial_shapes,
                generator=None):
        # query (1, Q, C); value (cams, L, C); ref_cams (cams, Q, P, 2);
        # masks (cams, Q, P)
        da = self.deformable_attention
        _, Q, C = query.shape
        cams = value.shape[0]
        H = da.num_heads
        v = da.value_proj(value).reshape(cams, -1, H, C // H)
        offsets, attn = deform_heads(query, da.sampling_offsets,
                                     da.attention_weights, H, da.num_levels,
                                     da.num_points)
        norm = _normalizer(spatial_shapes, query.device)
        hit = masks.sum(-1) > 0                               # (cams, Q)
        loc = ref_cams[:, :, None, None, :, :] + \
            offsets[0][None] / norm[None, None, None, :, None, :]
        attn_c = attn[0][None].expand((cams,) + attn.shape[1:])
        out = ms_deform_attn(v, spatial_shapes, loc, attn_c)  # cams, Q, C
        hitf = hit.to(out.dtype)
        slots = (out * hitf[..., None]).sum(0)
        count = hitf.sum(0).clamp_min(1.0)
        slots = (slots / count[..., None])[None]
        slots = dropout(self.output_proj(slots), self.dropout_p,
                        self.training, generator)
        return slots + query


class TPVImageCrossAttention(nn.Module):
    """The three per-plane cross-attentions, named as the reference's
    ``attentions.1.attn_{hw,zh,wz}``. Per-plane point counts follow the
    reference: hw -> num_points_cross[2], zh -> [1], wz -> [0]."""

    PLANES = ("hw", "zh", "wz")

    def __init__(self, embed_dims, num_heads, num_levels, num_points_cross,
                 dropout_p: float = 0.0):
        super().__init__()
        for i, plane in enumerate(self.PLANES):
            self.add_module(f"attn_{plane}", BEVCrossAttention(
                embed_dims, num_heads, num_levels, num_points_cross[2 - i],
                dropout_p))

    def forward(self, planes, value, ref_cams_list, masks_list,
                spatial_shapes, generator=None) -> List[torch.Tensor]:
        return [getattr(self, f"attn_{plane}")(
                    planes[i], value, ref_cams_list[i], masks_list[i],
                    spatial_shapes, generator)
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

    def forward(self, x, generator=None):
        y = dropout(self.layers[0](x), self.dropout_p, self.training,
                    generator)
        y = dropout(self.layers[1](y), self.dropout_p, self.training,
                    generator)
        return y + x


class TPVFormerLayer(nn.Module):
    """``self_attn -> norm -> cross_attn -> norm -> ffn -> norm``
    (post-norm, reference ``tpvformer_encoder_layer.py:123-219``)."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points_cross,
                 num_points_self, feedforward_channels, tpv_size,
                 dropout_p: float = 0.0):
        super().__init__()
        self.tpv_size = tuple(tpv_size)
        self.attentions = nn.ModuleList([
            CrossViewHybridAttention(embed_dims, num_heads, num_points_self,
                                     dropout_p),
            TPVImageCrossAttention(embed_dims, num_heads, num_levels,
                                   num_points_cross, dropout_p)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       dropout_p)])
        self.norms = nn.ModuleList(
            nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3))

    def forward(self, planes, value, tpv_pos, cross_view_ref, ref_cams_list,
                masks_list, img_spatial_shapes, generator=None):
        H, W, D = self.tpv_size
        sizes = [H * W, D * H, W * D]
        plane_shapes = ((H, W), (D, H), (W, D))
        q = self.attentions[0](torch.cat(planes, 1), torch.cat(tpv_pos, 1),
                               cross_view_ref, plane_shapes, generator)
        planes = list(self.norms[0](q).split(sizes, dim=1))
        planes = self.attentions[1](planes, value, ref_cams_list, masks_list,
                                    img_spatial_shapes, generator)
        q = self.norms[1](torch.cat(planes, 1))
        q = self.norms[2](self.ffns[0](q, generator))
        return list(q.split(sizes, dim=1))


class TPVPositionalEncoding(nn.Module):
    """Fourier features of normalized plane meters -> per-plane Linear
    (reference ``tpvformer_pos_embed.py:17-58``)."""

    def __init__(self, num_freqs, embed_dims, tot_range, mapping):
        super().__init__()
        hw, zh, wz = tpv_plane_meters(mapping)
        hw, zh, wz = normalize_plane_meters(hw, zh, wz, list(tot_range))
        for name, f, m in zip(("hw", "zh", "wz"), num_freqs, (hw, zh, wz)):
            feat = fourier_feat_from_meter(f, m)
            self.register_buffer(f"fourier_{name}", feat, persistent=False)
            self.add_module(f"position_layer_{name}",
                            nn.Linear(feat.shape[-1], embed_dims))

    def forward(self) -> List[torch.Tensor]:
        return [getattr(self, f"position_layer_{n}")(
                    getattr(self, f"fourier_{n}"))
                for n in ("hw", "zh", "wz")]


class TPVFormerEncoder(nn.Module):
    """The full encoder (reference ``tpvformer_encoder.py:20-290``)."""

    def __init__(self, mapping_args: Dict, embed_dims: int = 96,
                 num_heads: int = 6, num_cams: int = 6,
                 num_feature_levels: int = 4,
                 num_points_cross: Sequence[int] = (64, 64, 8),
                 num_points_self: int = 16, num_layers: int = 4,
                 feedforward_channels: int = 192,
                 pos_num_freqs: Sequence[int] = (12, 12, 12),
                 pc_range: Sequence[float] = (-40., -40., -1., 40., 40., 5.4),
                 dropout_p: float = 0.0):
        super().__init__()
        mapping = make_mapping(**mapping_args)
        self.tpv_size = (mapping.size_h, mapping.size_w, mapping.size_d)
        H, W, D = self.tpv_size
        self.positional_encoding = TPVPositionalEncoding(
            tuple(pos_num_freqs), embed_dims, tuple(pc_range), mapping)
        self.level_embeds = nn.Parameter(
            torch.zeros(num_feature_levels, embed_dims))
        self.cams_embeds = nn.Parameter(torch.zeros(num_cams, embed_dims))
        self.layers = nn.ModuleList(
            TPVFormerLayer(embed_dims, num_heads, num_feature_levels,
                           tuple(num_points_cross), num_points_self,
                           feedforward_channels, self.tpv_size, dropout_p)
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
                generator=None):
        """representation: [hw (1,HW,C), zh (1,DH,C), wz (1,WD,C)];
        ms_img_feats: list of (1, N, h, w, C); lidar2img (1, N, 4, 4);
        img_shape: (H, W) of the network input; ``generator`` draws the
        train-mode dropout masks."""
        if ms_img_feats[0].shape[0] != 1:
            raise ValueError("the TPV encoder runs batch size 1")
        tpv_pos = [p[None] for p in self.positional_encoding()]
        feats, img_spatial_shapes = [], []
        for lvl, feat in enumerate(ms_img_feats):
            _, N, h, w, C = feat.shape
            f = feat.reshape(N, h * w, C) + self.cams_embeds[:, None, :]
            feats.append(f + self.level_embeds[lvl][None, None, :])
            img_spatial_shapes.append((h, w))
        value = torch.cat(feats, dim=1)                    # (N, L, C)
        ref_cams_list, masks_list = [], []
        for ref in (self.ref_3d_hw, self.ref_3d_zh, self.ref_3d_wz):
            rc, m = point_sampling(ref, lidar2img, img_shape)
            ref_cams_list.append(rc[:, 0])
            masks_list.append(m[:, 0])
        planes = list(representation)
        for layer in self.layers:
            planes = layer(planes, value, tpv_pos, self.cross_view_ref,
                           ref_cams_list, masks_list,
                           tuple(img_spatial_shapes), generator)
        return planes
