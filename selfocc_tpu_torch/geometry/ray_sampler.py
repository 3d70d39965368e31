"""Pixel-ray sampler — counterpart of ``selfocc_tpu/geometry/ray_sampler.py``
(``fixed``, ``cellular`` and ``random`` modes).

The JAX sampler draws from a PRNG key; here the cellular grid and the
random pixels draw from an explicit ``torch.Generator`` on the target
device, or take the draws as given (``draws``), which is how the parity
tests feed both frameworks the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class RaySampler:
    """(R, 2) pixel (x, y) coordinates in the supervision image (reference
    ``ray_sampler.py:21-68``): ``fixed`` a uniform grid at stride
    img / ray_number (eval); ``cellular`` the ray_number grid randomly
    scaled (>= 1x) and offset inside the image (the training configs);
    ``random`` ray_number[0] * ray_number[1] uniform pixel positions over
    ``ray_img_size``."""

    ray_sample_mode: str = "fixed"
    ray_number: Sequence[int] = (192, 400)
    ray_img_size: Sequence[int] = (768, 1600)
    ray_upper_crop: int = 0
    ray_x_dsr_max: Optional[float] = None
    ray_y_dsr_max: Optional[float] = None

    def __post_init__(self):
        if self.ray_sample_mode not in ("fixed", "cellular", "random"):
            raise ValueError(
                f"unknown ray_sample_mode {self.ray_sample_mode!r}")

    @property
    def num_rays(self) -> int:
        return self.ray_number[0] * self.ray_number[1]

    def _base_grid(self, device) -> torch.Tensor:
        ny, nx = self.ray_number
        ry = torch.arange(ny, dtype=torch.float32, device=device)
        rx = torch.arange(nx, dtype=torch.float32, device=device)
        return torch.stack([rx[None, :].expand(ny, nx),
                            ry[:, None].expand(ny, nx)], dim=-1)

    def __call__(self, device=None, generator=None,
                 draws=None) -> torch.Tensor:
        """``draws``: the 4 uniforms of ``cellular`` (x scale, y scale,
        x offset, y offset) or the (R, 2) uniforms of ``random`` (x, y
        fractions of the image), else drawn from ``generator``."""
        if self.ray_sample_mode == "fixed":
            x_dsr = 1.0 * self.ray_img_size[1] / self.ray_number[1]
            y_dsr = 1.0 * self.ray_img_size[0] / self.ray_number[0]
            # python-scalar factors: no host-to-device copy per call
            grid = self._base_grid(device)
            return torch.stack([grid[..., 0] * x_dsr, grid[..., 1] * y_dsr],
                               dim=-1).reshape(-1, 2)

        if self.ray_sample_mode == "random":
            u = (torch.rand((self.num_rays, 2), generator=generator,
                            device=device) if draws is None else
                 torch.as_tensor(draws, dtype=torch.float32,
                                 device=device).reshape(self.num_rays, 2))
            # python-scalar scales: no host-to-device copy per call
            return torch.stack([u[:, 0] * float(self.ray_img_size[1]),
                                u[:, 1] * float(self.ray_img_size[0])], -1)
        if draws is None:
            u = torch.rand(4, generator=generator, device=device)
        else:
            u = torch.as_tensor(draws, dtype=torch.float32,
                                device=device).reshape(4)
        # cellular (reference ray_sampler.py:58-68)
        x_dsr_max = self.ray_x_dsr_max
        if x_dsr_max is None:
            x_dsr_max = 1.0 * self.ray_img_size[1] / self.ray_number[1]
        y_dsr_max = self.ray_y_dsr_max
        if y_dsr_max is None:
            y_dsr_max = (1.0 * (self.ray_img_size[0] - self.ray_upper_crop)
                         / self.ray_number[0])
        if not (x_dsr_max > 1 and y_dsr_max > 1):
            raise ValueError("cellular sampling needs image / ray_number > 1")
        x_dsr = u[0] * (x_dsr_max - 1) + 1
        y_dsr = u[1] * (y_dsr_max - 1) + 1
        x_emp_max = self.ray_img_size[1] - self.ray_number[1] * x_dsr
        y_emp_max = (self.ray_img_size[0] - self.ray_upper_crop
                     - self.ray_number[0] * y_dsr)
        x_emp = u[2] * x_emp_max
        y_emp = u[3] * y_emp_max
        grid = self._base_grid(device)
        rays = torch.stack([
            grid[..., 0] * x_dsr + x_emp,
            grid[..., 1] * y_dsr + y_emp + self.ray_upper_crop], dim=-1)
        return rays.reshape(-1, 2)
