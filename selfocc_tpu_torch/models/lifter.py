"""TPV and BEV query lifters and the plane-coordinate helpers — counterpart
of ``selfocc_tpu/models/lifter.py`` (``TPVQueryLifter``,
``BEVQueryLifter``, ``TPVPositionLifter``, ``fourier_feat_from_meter``,
``tpv_plane_meters``, ``normalize_plane_meters``) and the encoder's
``TPVPositionalEncoding``, which the position lifter is."""
from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from ..geometry.mappings import make_mapping
from .initializers import normal_


class TPVQueryLifter(nn.Module):
    """Three learnable query planes (reference ``tpv_query_lifter.py:7-36``)."""

    def __init__(self, tpv_h: int, tpv_w: int, tpv_z: int, dim: int):
        super().__init__()
        self.tpv_hw = nn.Parameter(torch.zeros(1, tpv_h * tpv_w, dim))
        self.tpv_zh = nn.Parameter(torch.zeros(1, tpv_z * tpv_h, dim))
        self.tpv_wz = nn.Parameter(torch.zeros(1, tpv_w * tpv_z, dim))

    def reset_parameters_like_jax(self, generator):
        for p in (self.tpv_hw, self.tpv_zh, self.tpv_wz):
            normal_(p, 1.0, generator)

    def forward(self, ms_img_feats) -> List[torch.Tensor]:
        bs = ms_img_feats[0].shape[0]
        return [p.expand(bs, -1, -1)
                for p in (self.tpv_hw, self.tpv_zh, self.tpv_wz)]



class BEVQueryLifter(nn.Module):
    """One learnable BEV plane (reference ``bev_query_lifter.py:7-26``),
    normal(1.0) init, broadcast to the batch; its key is the reference's
    ``lifter.bev``."""

    def __init__(self, bev_h: int, bev_w: int, dim: int):
        super().__init__()
        self.bev = nn.Parameter(torch.zeros(1, bev_h * bev_w, dim))

    def reset_parameters_like_jax(self, generator):
        normal_(self.bev, 1.0, generator)

    def forward(self, ms_img_feats) -> torch.Tensor:
        return self.bev.expand(ms_img_feats[0].shape[0], -1, -1)

def fourier_feat_from_meter(num_freqs: int, meter: torch.Tensor):
    """freqs = pi * 2^[-1 .. num_freqs-2]; layout (coord, freq, sin/cos)
    flattened -> (HW, 4 * num_freqs)."""
    freqs = math.pi * (2.0 ** torch.arange(-1, num_freqs - 1,
                                           dtype=torch.float32))
    mf = meter[..., None] * freqs
    feat = torch.stack([torch.sin(mf), torch.cos(mf)], dim=-1)
    feat = feat.reshape(*feat.shape[:-3], -1)
    return feat.reshape(-1, feat.shape[-1])


def tpv_plane_meters(mapping):
    """Metric coordinates of each TPV plane's cells: hw->(x,y), zh->(y,z),
    wz->(x,z)."""
    H, W, D = mapping.size_h, mapping.size_w, mapping.size_d
    ah = torch.arange(H, dtype=torch.float32)
    aw = torch.arange(W, dtype=torch.float32)
    ad = torch.arange(D, dtype=torch.float32)
    hw_grid = torch.stack([ah[:, None].expand(H, W), aw[None, :].expand(H, W),
                           torch.zeros(H, W)], dim=-1)
    hw_meter = mapping.grid2meter(hw_grid)[..., [0, 1]]
    zh_grid = torch.stack([ah[None, :].expand(D, H), torch.zeros(D, H),
                           ad[:, None].expand(D, H)], dim=-1)
    zh_meter = mapping.grid2meter(zh_grid)[..., [1, 2]]
    wz_grid = torch.stack([torch.zeros(W, D), aw[:, None].expand(W, D),
                           ad[None, :].expand(W, D)], dim=-1)
    wz_meter = mapping.grid2meter(wz_grid)[..., [0, 2]]
    return hw_meter, zh_meter, wz_meter


def normalize_plane_meters(hw, zh, wz, pc_range):
    """Normalize plane meters into [0, 1] by the point-cloud range."""
    x0, y0, z0, x1, y1, z1 = pc_range
    hw = torch.stack([(hw[..., 0] - x0) / (x1 - x0),
                      (hw[..., 1] - y0) / (y1 - y0)], dim=-1)
    zh = torch.stack([(zh[..., 0] - y0) / (y1 - y0),
                      (zh[..., 1] - z0) / (z1 - z0)], dim=-1)
    wz = torch.stack([(wz[..., 0] - x0) / (x1 - x0),
                      (wz[..., 1] - z0) / (z1 - z0)], dim=-1)
    return hw, zh, wz


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


class TPVPositionLifter(TPVPositionalEncoding):
    """Queries from Fourier features of the plane cells' metric coordinates,
    no learned queries (reference ``tpv_pos_lifter.py:18-86``): the
    encoder's positional encoding over ``tot_range`` (per plane a Linear
    ``position_layer_{hw,zh,wz}``, the reference's keys), broadcast to the
    batch."""

    def __init__(self, embed_dims: int, tot_range, num_freqs, mapping_args):
        super().__init__(tuple(num_freqs), embed_dims, tuple(tot_range),
                         make_mapping(**mapping_args))

    def forward(self, ms_img_feats) -> List[torch.Tensor]:
        bs = ms_img_feats[0].shape[0]
        return [p[None].expand(bs, -1, -1) for p in super().forward()]
