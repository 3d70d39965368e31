"""Pixel-ray sampler — counterpart of ``selfocc_tpu/geometry/ray_sampler.py``,
``"fixed"`` mode only (the eval grid). The training modes (``cellular``,
``random``) draw random numbers and come with the training slice."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class RaySampler:
    """(R, 2) pixel (x, y) coordinates on a uniform grid at stride
    img / ray_number (reference ``ray_sampler.py:21-68``)."""

    ray_sample_mode: str = "fixed"
    ray_number: Sequence[int] = (192, 400)
    ray_img_size: Sequence[int] = (768, 1600)

    def __post_init__(self):
        if self.ray_sample_mode != "fixed":
            raise NotImplementedError(
                f"ray_sample_mode={self.ray_sample_mode!r} is not ported yet "
                "(only the eval 'fixed' grid)")

    def __call__(self, device=None) -> torch.Tensor:
        ny, nx = self.ray_number
        x_dsr = 1.0 * self.ray_img_size[1] / nx
        y_dsr = 1.0 * self.ray_img_size[0] / ny
        ry = torch.arange(ny, dtype=torch.float32, device=device)
        rx = torch.arange(nx, dtype=torch.float32, device=device)
        grid = torch.stack([rx[None, :].expand(ny, nx),
                            ry[:, None].expand(ny, nx)], dim=-1)
        scale = torch.tensor([x_dsr, y_dsr], dtype=torch.float32,
                             device=device)
        return (grid * scale).reshape(-1, 2)
