"""TPV query lifter and the plane-coordinate helpers — counterpart of
``selfocc_tpu/models/lifter.py`` (``TPVQueryLifter``,
``fourier_feat_from_meter``, ``tpv_plane_meters``,
``normalize_plane_meters``)."""
from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

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
