"""Pixel-ray sampler — counterpart of ``selfocc_tpu/geometry/ray_sampler.py``
(``fixed`` and ``cellular`` modes; ``random`` is used by no config of the
port and is not ported).

The JAX sampler draws from a PRNG key; here the cellular grid draws from an
explicit ``torch.Generator`` on the target device, or takes the draws as
given (``draws``), which is how the parity tests feed both frameworks the
same numbers.
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
    scaled (>= 1x) and offset inside the image (the training configs)."""

    ray_sample_mode: str = "fixed"
    ray_number: Sequence[int] = (192, 400)
    ray_img_size: Sequence[int] = (768, 1600)
    ray_upper_crop: int = 0
    ray_x_dsr_max: Optional[float] = None
    ray_y_dsr_max: Optional[float] = None

    def __post_init__(self):
        if self.ray_sample_mode not in ("fixed", "cellular"):
            raise NotImplementedError(
                f"ray_sample_mode={self.ray_sample_mode!r} is not ported")

    def _base_grid(self, device) -> torch.Tensor:
        ny, nx = self.ray_number
        ry = torch.arange(ny, dtype=torch.float32, device=device)
        rx = torch.arange(nx, dtype=torch.float32, device=device)
        return torch.stack([rx[None, :].expand(ny, nx),
                            ry[:, None].expand(ny, nx)], dim=-1)

    def __call__(self, device=None, generator=None,
                 draws=None) -> torch.Tensor:
        """``draws``: the 4 uniforms of ``cellular`` (x scale, y scale,
        x offset, y offset), else drawn from ``generator``."""
        if self.ray_sample_mode == "fixed":
            x_dsr = 1.0 * self.ray_img_size[1] / self.ray_number[1]
            y_dsr = 1.0 * self.ray_img_size[0] / self.ray_number[0]
            scale = torch.tensor([x_dsr, y_dsr], dtype=torch.float32,
                                 device=device)
            return (self._base_grid(device) * scale).reshape(-1, 2)

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
