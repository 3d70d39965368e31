"""SSIM dissimilarity (monodepth2-style) — counterpart of
``selfocc_tpu/ops/ssim.py``: reflection-pad 1, 3x3 mean pooling,
C1 = 0.01^2, C2 = 0.03^2, output ``clip((1 - SSIM) / 2, 0, 1)``. Plain
PyTorch (XLA in the JAX package, not a kernel)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg_pool3(x):
    """3x3 / stride-1 mean pooling of (B, C, H, W), valid padding."""
    return F.avg_pool2d(x, 3, stride=1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM dissimilarity of channel-last (B, H, W, C) images ->
    (B, H, W, C)."""
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    out = torch.clamp((1 - ssim_n / ssim_d) / 2, 0.0, 1.0)
    return out.permute(0, 2, 3, 1)
