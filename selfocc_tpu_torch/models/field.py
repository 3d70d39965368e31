"""TPV-decoded SDF field — counterpart of ``selfocc_tpu/models/field.py``
(``TPVSDFField.decode``, ``query_geo``, ``query_geo_uniform``,
``query_geo_grad``, ``sdf``, ``second_grad``, ``second_grad_noncompact``,
``color``, ``inv_s``). The render's volume queries go through
``ops.interp.trilinear_sample_cf_with_grad``, the occupancy queries through
``trilinear_sample_cf`` (values only) or the separable lerps, so on the card
they run the trilinear kernels.

State-dict keys follow the reference field: ``density_net.{2i+1}`` for the
Linears of ``Sequential([Softplus, Linear] x density_layers)``,
``color_proj`` and ``deviation_network.variance`` (shape (1,)).
The decoded volume has the channel-first shape ``(B, C, H, W, D)`` with
channels ``[sdf | SH coefficients | sem logits]``, laid out channel-last in
memory (the layout the trilinear kernels read); everything is fp32.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..geometry import sh as sh_lib
from ..geometry.mappings import make_mapping
from ..ops.interp import (first_channel, separable_grid_resample_cf,
                          trilinear_sample_cf, trilinear_sample_cf_with_grad)


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
        broadcast-sum of the three planes through the MLP, returned as a
        permuted view of the MLP's channel-last output. The trilinear
        kernels read that layout as it is, and their channel-last volume
        gradient flows back through the permute without a transpose."""
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
        return out.permute(0, 4, 1, 2, 3)

    def _split(self, vals):
        return {"sdf": vals[..., 0],
                "color_feat": vals[..., 1:1 + self.n_sh],
                "sem_logits": vals[..., 1 + self.n_sh:]}

    def query_geo(self, volume, xyz):
        """All channels of a (C, H, W, D) volume at metric points (..., 3),
        split into ``sdf`` (...), ``color_feat`` (..., n_sh) and
        ``sem_logits`` (..., sem_dims): values only, no gradient (the
        occupancy query, ``field.py:150-170``). Each is a view of one
        (..., C) result."""
        grid = self.mapping.meter2grid(xyz.float())
        return self._split(trilinear_sample_cf(volume, grid, "zeros"))

    def query_geo_uniform(self, volume, xs, ys, zs):
        """``query_geo`` on the separable metric grid ``ys`` x ``xs`` x
        ``zs`` -> (H, W, D) outputs (``field.py:172-196``): ``meter2grid``
        maps each metric axis alone (h <- y, w <- x, d <- z), so the query
        is three per-axis lerps (``separable_grid_resample_cf``); the same
        interpolant as ``query_geo``, rounded in another order (~1 ulp)."""
        def axis(m, i):                  # metric points on one axis
            cols = [torch.zeros_like(m, dtype=torch.float32)] * 3
            cols[i] = m.float()
            return torch.stack(cols, -1)

        gh = self.mapping.meter2grid(axis(ys, 1))[..., 0]
        gw = self.mapping.meter2grid(axis(xs, 0))[..., 1]
        gd = self.mapping.meter2grid(axis(zs, 2))[..., 2]
        vals = separable_grid_resample_cf(volume.float(), gh, gw, gd)
        return self._split(vals.permute(1, 2, 3, 0))

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

    def sdf(self, volume, xyz):
        """SDF-only query (channel 0 of the volume) at metric points."""
        return self.query_geo_grad(first_channel(volume), xyz)[0]["sdf"]

    def second_grad(self, volume, xyz, delta: float, center=None):
        """Compact numerical second derivative along the 3 axes
        (``field.py:282-294``): ``(sdf(x+d) + sdf(x-d) - 2 sdf(x)) / d^2``;
        ``center`` is the SDF at ``xyz`` when the caller has it."""
        if center is None:
            center = self.sdf(volume, xyz)
        comps = []
        for axis in range(3):
            e = _axis_step(axis, delta, xyz)
            comps.append((self.sdf(volume, xyz + e) + self.sdf(volume, xyz - e)
                          - 2 * center) / (delta * delta))
        return torch.stack(comps, dim=-1)

    def second_grad_noncompact(self, volume, xyz, delta: float):
        """Non-compact second derivative, the flagship default
        (``field.py:296-313``): the central difference of the SDF gradient
        along each axis, ``(d_i sdf(x + d e_i) - d_i sdf(x - d e_i)) / 2d``.
        The JAX package takes ``jax.grad`` of a trilinear sample for the
        gradient; here it is the analytic ``query_geo_grad`` gradient on the
        sdf channel (equal up to rounding), so its backward runs through
        the trilinear backward as well."""
        comps = []
        sdf_vol = first_channel(volume)
        for axis in range(3):
            e = _axis_step(axis, delta, xyz)
            gp = self.query_geo_grad(sdf_vol, xyz + e)[1][..., axis]
            gm = self.query_geo_grad(sdf_vol, xyz - e)[1][..., axis]
            comps.append((gp - gm) / (2 * delta))
        return torch.stack(comps, dim=-1)

    def color(self, color_feat, viewdirs):
        """Interpolated SH coefficients + view directions -> RGB."""
        return sh_lib.sh_render(viewdirs, color_feat, self.sh_deg,
                                self.sh_act)

    def inv_s(self):
        return self.deviation_network()


def _axis_step(axis: int, delta: float, like: torch.Tensor) -> torch.Tensor:
    # a row of the identity times a Python scalar: writing the scalar into
    # a device tensor (e[axis] = delta) is a host-to-device copy that
    # blocks the stream
    return torch.eye(3, dtype=torch.float32, device=like.device)[axis] * delta
