"""Grid <-> metric-space mappings — counterpart of
``selfocc_tpu/geometry/mappings.py`` (``LinearMapping``, ``make_mapping``).

Conventions (identical to the JAX package and the reference): ``grid``
coordinates are fractional cell indices ``(h, w, d)``; ``meter`` coordinates
are metric ``(x, y, z)``; ``h`` maps to ``y``, ``w`` to ``x``, ``d`` to ``z``.

``NonLinearMapping`` (``nonlinear_mode="linear_upscale"``) is not on the
ported path yet; ``make_mapping`` raises for it.

Derivative note: ``sign(x) * f(|x|)`` has derivative ``sign(x)^2 * f'(|x|)``
under JAX's autodiff (``sign`` has zero derivative, ``|x|`` has derivative
``sign(x)``), so the JAX field's ``jax.jvp`` columns are exactly 0 where a
metric coordinate is exactly 0. ``meter2grid_slope`` reproduces that.
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
        raise NotImplementedError(
            "NonLinearMapping (linear_upscale) is not ported yet")
    raise ValueError(f"unknown nonlinear_mode: {nonlinear_mode}")
