"""FPN neck (mmdet semantics) — counterpart of ``selfocc_tpu/models/fpn.py``.

State-dict keys follow mmdet: ``lateral_convs.{i}.conv.*`` and
``fpn_convs.{i}.conv.*``. Only ``num_outs == len(in_channels)`` (every shipped
config) is ported: no extra output levels. Modules take and return NCHW.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/activation: a named ``conv``."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=padding)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 96):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            # nearest 2x upsample + add; the crop guards odd sizes
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest")
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[..., :h, :w]
        return [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
