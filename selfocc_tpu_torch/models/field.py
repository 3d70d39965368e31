"""TPV-decoded SDF field — counterpart of ``selfocc_tpu/models/field.py``
(``TPVSDFField.decode``, ``query_geo_grad``, ``color``, ``inv_s``).

State-dict keys follow the reference field: ``density_net.{2i+1}`` for the
Linears of ``Sequential([Softplus, Linear] x density_layers)``,
``color_proj`` and ``deviation_network.variance`` (shape (1,)).
The decoded volume is channel-first ``(B, C, H, W, D)`` with channels
``[sdf | SH coefficients | sem logits]``; everything is fp32.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..geometry import sh as sh_lib
from ..geometry.mappings import make_mapping
from ..ops.interp import trilinear_sample_cf_with_grad


class LearnedVariance(nn.Module):
    """NeuS deviation network: inv_s = clip(exp(10 * variance), 1e-6, 1e6)."""

    def __init__(self, beta_init: float = 0.1):
        super().__init__()
        self.beta_init = beta_init
        self.variance = nn.Parameter(torch.full((1,), beta_init))

    def reset_parameters_like_jax(self, generator):
        self.variance.data.fill_(self.beta_init)

    def forward(self):
        return torch.exp(10.0 * self.variance).clamp(1e-6, 1e6).reshape(())


class TPVSDFField(nn.Module):
    def __init__(self, mapping_args: Dict, embed_dims: int = 96,
                 color_dims: int = 0, sem_dims: int = 0,
                 density_layers: int = 2, sh_deg: int = 0,
                 sh_act: str = "relu", beta_init: float = 0.1):
        super().__init__()
        self.mapping = make_mapping(**mapping_args)
        self.embed_dims, self.color_dims, self.sem_dims = (
            embed_dims, color_dims, sem_dims)
        self.sh_deg, self.sh_act = sh_deg, sh_act
        out_dim = 1 + color_dims + sem_dims
        layers = []
        for _ in range(density_layers - 1):
            layers += [nn.Softplus(), nn.Linear(embed_dims, embed_dims)]
        layers += [nn.Softplus(), nn.Linear(embed_dims, out_dim)]
        self.density_net = nn.Sequential(*layers)
        n_sh = 3 * (sh_deg + 1) ** 2
        # SH projection folded into decode (linear, commutes with trilinear)
        self.color_proj = (nn.Linear(color_dims, n_sh)
                           if color_dims > 0 and color_dims != n_sh else None)
        self.deviation_network = LearnedVariance(beta_init)

    @property
    def n_sh(self) -> int:
        return 3 * (self.sh_deg + 1) ** 2 if self.color_dims > 0 else 0

    @property
    def grid_shape(self):
        m = self.mapping
        return (m.size_h, m.size_w, m.size_d)

    def decode(self, rep) -> torch.Tensor:
        """Plane features [hw, zh, wz] -> (B, C_out, H, W, D) fp32: the
        broadcast-sum of the three planes through the MLP."""
        H, W, D = self.grid_shape
        C = self.embed_dims
        tpv_hw, tpv_zh, tpv_wz = rep
        B = tpv_hw.shape[0]
        hw = tpv_hw.float().reshape(B, H, W, 1, C)
        zh = tpv_zh.float().reshape(B, D, H, 1, C).permute(0, 2, 3, 1, 4)
        wz = tpv_wz.float().reshape(B, W, D, C)[:, None]
        out = self.density_net(hw + zh + wz)                 # B,H,W,D,Cout
        if self.color_proj is not None:
            sh = self.color_proj(out[..., 1:1 + self.color_dims])
            out = torch.cat([out[..., :1], sh,
                             out[..., 1 + self.color_dims:]], dim=-1)
        return out.permute(0, 4, 1, 2, 3).contiguous()

    def _split(self, vals):
        return {"sdf": vals[..., 0],
                "color_feat": vals[..., 1:1 + self.n_sh],
                "sem_logits": vals[..., 1 + self.n_sh:]}

    def query_geo_grad(self, volume, xyz):
        """All channels of a (C, H, W, D) volume at metric points (..., 3),
        plus the metric-space SDF gradient (..., 3), from one trilinear pass.

        The grid-space gradient is chained through ``meter2grid``'s Jacobian.
        The linear mapping is separable (h <- y, w <- x, d <- z), so the
        Jacobian is a permuted diagonal, ``meter2grid_slope``; the JAX package
        takes three ``jax.jvp`` columns whose off-diagonal products are exact
        zeros, so the results agree, including the zero slope at a metric
        coordinate of exactly 0."""
        xyz = xyz.float()
        grid = self.mapping.meter2grid(xyz)
        slope = self.mapping.meter2grid_slope(xyz)
        vals, grad_grid = trilinear_sample_cf_with_grad(volume, grid, "zeros")
        # (x, y, z) <- (w, h, d)
        gs = grad_grid * slope
        grad = torch.stack([gs[..., 1], gs[..., 0], gs[..., 2]], dim=-1)
        return self._split(vals), grad

    def color(self, color_feat, viewdirs):
        """Interpolated SH coefficients + view directions -> RGB."""
        return sh_lib.sh_render(viewdirs, color_feat, self.sh_deg,
                                self.sh_act)

    def inv_s(self):
        return self.deviation_network()
