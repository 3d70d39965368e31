"""Grid <-> metric-space mappings — counterpart of
``selfocc_tpu/geometry/mappings.py`` (``LinearMapping``,
``NonLinearMapping``, ``make_mapping``).

Conventions (identical to the JAX package and the reference): ``grid``
coordinates are fractional cell indices ``(h, w, d)``; ``meter`` coordinates
are metric ``(x, y, z)``; ``h`` maps to ``y``, ``w`` to ``x``, ``d`` to ``z``.

Derivative note: ``sign(x) * f(|x|)`` has derivative ``sign(x)^2 * f'(|x|)``
under JAX's autodiff (``sign`` has zero derivative, ``|x|`` has derivative
``sign(x)``), so the JAX field's ``jax.jvp`` columns are exactly 0 where a
metric coordinate is exactly 0. ``meter2grid_slope`` reproduces that. In
``NonLinearMapping`` JAX's ``minimum`` / ``maximum`` also give each side
half the tangent at a tie (``_balanced_eq``) and ``floor`` none; its slope
and its ``minimum`` / ``maximum`` ops (whose torch backward splits ties
alike) keep those rules.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


def _piecewise_fwd(ctr_abs, size, rng):
    """|grid-center| -> |meters| for a two-segment piecewise-linear axis."""
    if size[1] == 0:
        return ctr_abs / size[0] * rng[0]
    return torch.where(ctr_abs > size[0],
                       rng[0] + (ctr_abs - size[0]) / size[1] * rng[1],
                       ctr_abs / size[0] * rng[0])


def _piecewise_inv(m_abs, size, rng):
    """|meters| -> |grid-center|, inverse of :func:`_piecewise_fwd`."""
    if size[1] == 0:
        return m_abs / rng[0] * size[0]
    return torch.where(m_abs > rng[0],
                       size[0] + (m_abs - rng[0]) / rng[1] * size[1],
                       m_abs / rng[0] * size[0])


@dataclasses.dataclass(frozen=True)
class LinearMapping:
    """Piecewise-linear grid<->meter mapping (reference ``mappings.py:4-150``)."""

    h_size: Sequence[int] = (128, 32)
    h_range: Sequence[float] = (51.2, 28.8)
    h_half: bool = False
    w_size: Sequence[int] = (128, 32)
    w_range: Sequence[float] = (51.2, 28.8)
    w_half: bool = False
    d_size: Sequence[int] = (20, 10)
    d_range: Sequence[float] = (-4.0, 4.0, 12.0)

    @property
    def d_spans(self):
        return (self.d_range[1] - self.d_range[0],
                self.d_range[2] - self.d_range[1])

    @property
    def d_start(self):
        return self.d_range[0]

    @property
    def size_h(self) -> int:
        if self.h_half:
            return 1 + self.h_size[0] + self.h_size[1]
        return 1 + 2 * (self.h_size[0] + self.h_size[1])

    @property
    def size_w(self) -> int:
        if self.w_half:
            return 1 + self.w_size[0] + self.w_size[1]
        return 1 + 2 * (self.w_size[0] + self.w_size[1])

    @property
    def size_d(self) -> int:
        return 1 + self.d_size[0] + self.d_size[1]

    def grid2meter(self, grid: torch.Tensor) -> torch.Tensor:
        """``[..., (h, w, d)]`` fractional indices -> ``[..., (x, y, z)]``."""
        h, w = grid[..., 0], grid[..., 1]
        h_ctr = h if self.h_half else h - (self.h_size[0] + self.h_size[1])
        y = torch.sign(h_ctr) * _piecewise_fwd(h_ctr.abs(), self.h_size,
                                               self.h_range)
        w_ctr = w if self.w_half else w - (self.w_size[0] + self.w_size[1])
        x = torch.sign(w_ctr) * _piecewise_fwd(w_ctr.abs(), self.w_size,
                                               self.w_range)
        d_ctr = grid[..., 2]
        z = torch.sign(d_ctr) * _piecewise_fwd(d_ctr.abs(), self.d_size,
                                               self.d_spans)
        z = z + self.d_start
        return torch.stack([x, y, z], dim=-1)

    def meter2grid(self, meter: torch.Tensor) -> torch.Tensor:
        """``[..., (x, y, z)]`` meters -> ``[..., (h, w, d)]`` indices."""
        x, y, z = meter[..., 0], meter[..., 1], meter[..., 2]
        w_ctr = torch.sign(x) * _piecewise_inv(x.abs(), self.w_size,
                                               self.w_range)
        w = w_ctr if self.w_half else w_ctr + self.w_size[0] + self.w_size[1]
        h_ctr = torch.sign(y) * _piecewise_inv(y.abs(), self.h_size,
                                               self.h_range)
        h = h_ctr if self.h_half else h_ctr + self.h_size[0] + self.h_size[1]
        z_ctr = z - self.d_start
        d = torch.sign(z_ctr) * _piecewise_inv(z_ctr.abs(), self.d_size,
                                               self.d_spans)
        return torch.stack([h, w, d], dim=-1)

    def meter2grid_slope(self, meter: torch.Tensor) -> torch.Tensor:
        """``[..., (dh/dy, dw/dx, dd/dz)]``: the nonzero entries of
        ``meter2grid``'s Jacobian (the mapping is separable: h <- y, w <- x,
        d <- z). Written as the forward-mode JVP of ``meter2grid`` with a unit
        tangent, op for op, so it equals ``jax.jvp`` of the JAX mapping,
        including the zero at a coordinate of exactly 0."""
        x, y, z = meter[..., 0], meter[..., 1], meter[..., 2]

        def slope(m, size, rng):
            s = torch.sign(m)
            if size[1] == 0:
                return s * (s / rng[0] * size[0])
            return s * torch.where(m.abs() > rng[0], s / rng[1] * size[1],
                                   s / rng[0] * size[0])

        z_ctr = z - self.d_start
        return torch.stack([slope(y, self.h_size, self.h_range),
                            slope(x, self.w_size, self.w_range),
                            slope(z_ctr, self.d_size, self.d_spans)], dim=-1)


def _tie_share(a, ans, b: float):
    """JAX's ``_balanced_eq(a, ans, b)`` for ``ans = min(a, b)`` or
    ``max(a, b)`` with a constant ``b``: the share of ``a``'s tangent that
    ``ans`` gets, 1 where ``a`` won, 0 where it lost, 1/2 at a tie."""
    return torch.where(a == ans, 1.0, 0.0) / torch.where(ans == b, 2.0, 1.0)


@dataclasses.dataclass(frozen=True)
class NonLinearMapping:
    """Inner-uniform cells plus quadratically growing outer cells
    (reference ``mappings.py:199-287``): the h and w axes are one
    symmetric axis (``bev_inner`` cells over ``range_inner`` metres on
    each side of the centre, then ``bev_outer`` cells over ``range_outer``
    metres, each wider by ``increase_unit``); z the same, one-sided, from
    ``z_ranges[0]``."""

    bev_inner: int = 128
    bev_outer: int = 32
    range_inner: float = 51.2
    range_outer: float = 51.2
    z_inner: int = 20
    z_outer: int = 10
    z_ranges: Sequence[float] = (-5.0, 3.0, 11.0)

    @property
    def size_h(self) -> int:
        return 1 + 2 * (self.bev_inner + self.bev_outer)

    size_w = size_h

    @property
    def size_d(self) -> int:
        return 1 + self.z_inner + self.z_outer

    @property
    def hw_unit(self) -> float:
        return self.range_inner * 1.0 / self.bev_inner

    @property
    def increase_unit(self) -> float:
        return (self.range_outer - self.bev_outer * self.hw_unit) * 2.0 / \
            self.bev_outer / (self.bev_outer + 1)

    @property
    def z_unit(self) -> float:
        return (self.z_ranges[1] - self.z_ranges[0]) * 1.0 / self.z_inner

    @property
    def z_increase_unit(self) -> float:
        return (self.z_ranges[2] - self.z_ranges[1]
                - self.z_outer * self.z_unit) * 2.0 / self.z_outer / \
            (self.z_outer + 1)

    def grid2meter(self, grid: torch.Tensor) -> torch.Tensor:
        """``[..., (h, w[, d])]`` fractional indices -> ``[..., (x, y[,
        z])]``."""
        hw = grid[..., :2]
        hw_center = hw - (self.bev_inner + self.bev_outer)
        hw_abs = hw_center.abs()
        yx_base = hw_abs * self.hw_unit
        hw_outer = torch.clamp(hw_abs - self.bev_inner, min=0.0)
        hw_outer_int = torch.floor(hw_outer)
        yx_outer_base = hw_outer_int * (hw_outer_int + 1) / 2.0 * \
            self.increase_unit
        yx_outer_resi = (hw_outer - hw_outer_int) * (hw_outer_int + 1) * \
            self.increase_unit
        yx = torch.sign(hw_center) * (yx_base + yx_outer_base + yx_outer_resi)
        if grid.shape[-1] != 3:
            return yx.flip(-1)
        d_center = grid[..., 2]
        z_base = d_center * self.z_unit
        d_outer = torch.clamp(d_center - self.z_inner, min=0.0)
        d_outer_int = torch.floor(d_outer)
        z_outer_base = d_outer_int * (d_outer_int + 1) / 2.0 * \
            self.z_increase_unit
        z_outer_resi = (d_outer - d_outer_int) * (d_outer_int + 1) * \
            self.z_increase_unit
        z = z_base + z_outer_base + z_outer_resi + self.z_ranges[0]
        return torch.stack([yx[..., 1], yx[..., 0], z], dim=-1)

    def _axes(self, meter):
        """The two metric inputs of the ``meter2grid`` chain: ``xy`` and
        ``z_abs`` (z above ``z_ranges[0]``), and the constants of each
        axis: (unit, inner cells, inner metres, increase)."""
        return ((meter[..., :2], self.hw_unit, self.bev_inner,
                 self.range_inner, self.increase_unit),
                (meter[..., 2] - self.z_ranges[0], self.z_unit, self.z_inner,
                 self.z_ranges[1] - self.z_ranges[0], self.z_increase_unit))

    @staticmethod
    def _outer_base(outer, unit, inc):
        c = 0.5 + unit / inc
        return torch.floor(torch.sqrt(c * c + 2 * outer / inc) - c)

    def meter2grid(self, meter: torch.Tensor) -> torch.Tensor:
        """``[..., (x, y, z)]`` meters -> ``[..., (h, w, d)]`` indices. The
        clamps are ``torch.minimum`` / ``torch.maximum`` against a 0-d
        tensor, whose backward splits a tie as JAX's does."""
        (xy, unit, inner, rng, inc), (z_abs, zu, zi, zr, zinc) = \
            self._axes(meter)

        def cells(m_abs, unit, inner, rng, inc):
            base = torch.minimum(m_abs / unit, m_abs.new_full((), inner))
            outer = torch.maximum(m_abs - rng, m_abs.new_zeros(()))
            ob = self._outer_base(outer, unit, inc)
            resi = outer - ob * unit - inc * ob * (ob + 1) / 2
            return base + ob + resi / (unit + (ob + 1) * inc)

        wh = torch.sign(xy) * cells(xy.abs(), unit, inner, rng, inc) \
            + self.bev_inner + self.bev_outer
        d = cells(z_abs, zu, zi, zr, zinc)
        return torch.stack([wh[..., 1], wh[..., 0], d], dim=-1)

    def meter2grid_slope(self, meter: torch.Tensor) -> torch.Tensor:
        """``[..., (dh/dy, dw/dx, dd/dz)]``, the diagonal of
        ``meter2grid``'s Jacobian, written as ``jax.jvp`` of the JAX
        ``meter2grid`` with a unit tangent, op for op: ``|x|``'s tangent is
        +1 at x >= 0 and -1 below, ``minimum`` / ``maximum`` pass each side
        its share of the tangent (``_tie_share``: half at a tie), ``floor``
        and ``sign`` pass none, and the h and w entries end multiplied by
        ``sign(x)``, so they are 0 at a coordinate of exactly 0."""
        (xy, unit, inner, rng, inc), (z_abs, zu, zi, zr, zinc) = \
            self._axes(meter)

        def tangent(m_abs, t_abs, unit, inner, rng, inc):
            a = m_abs / unit
            t_base = (t_abs / unit) * _tie_share(
                a, torch.minimum(a, a.new_full((), inner)), inner)
            o = m_abs - rng
            outer = torch.maximum(o, o.new_zeros(()))
            t_outer = t_abs * _tie_share(o, outer, 0.0)
            ob = self._outer_base(outer, unit, inc)
            return t_base + t_outer / (unit + (ob + 1) * inc)

        t_abs = torch.where(xy >= 0, 1.0, -1.0)
        t_wh = torch.sign(xy) * tangent(xy.abs(), t_abs, unit, inner, rng,
                                        inc)
        t_d = tangent(z_abs, torch.ones_like(z_abs), zu, zi, zr, zinc)
        return torch.stack([t_wh[..., 1], t_wh[..., 0], t_d], dim=-1)


def make_mapping(nonlinear_mode: str = "linear_upscale", h_size=(128, 32),
                 h_range=(51.2, 28.8), h_half: bool = False,
                 w_size=(128, 32), w_range=(51.2, 28.8), w_half: bool = False,
                 d_size=(20, 10), d_range=(-4.0, 4.0, 12.0)):
    """Facade selecting the mapping mode (reference ``GridMeterMapping``)."""
    if nonlinear_mode == "linear":
        return LinearMapping(
            h_size=tuple(h_size), h_range=tuple(h_range), h_half=h_half,
            w_size=tuple(w_size), w_range=tuple(w_range), w_half=w_half,
            d_size=tuple(d_size), d_range=tuple(d_range))
    if nonlinear_mode == "linear_upscale":
        if tuple(h_size) != tuple(w_size) or \
                tuple(h_range) != tuple(w_range) or h_half or w_half:
            raise ValueError("linear_upscale needs equal h and w axes and "
                             "no half axis")
        return NonLinearMapping(
            bev_inner=h_size[0], bev_outer=h_size[1],
            range_inner=h_range[0], range_outer=h_range[1],
            z_inner=d_size[0], z_outer=d_size[1], z_ranges=tuple(d_range))
    raise ValueError(f"unknown nonlinear_mode: {nonlinear_mode}")
