"""FPN neck (mmdet semantics) — counterpart of ``selfocc_tpu/models/fpn.py``.

State-dict keys follow mmdet: ``lateral_convs.{i}.conv.*`` and
``fpn_convs.{i}.conv.*``. Only ``num_outs == len(in_channels)`` (every shipped
config) is ported: no extra output levels. Modules take and return NCHW.
``IdentityNeck`` is the passthrough of ``neck_type="identity"``.
``FPN(dtype=torch.bfloat16)`` computes in bf16 on fp32 parameters, as the
JAX package's ``dtype=`` (``fpn.py:31-48``): the inputs are cast, the
convolutions and the top-down adds run in bf16.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import conv_at_input_dtype


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/activation: a named ``conv``."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=padding)

    def forward(self, x):
        return conv_at_input_dtype(self.conv, x)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 96, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.dtype is not None:
            inputs = [x.to(self.dtype) for x in inputs]
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            # nearest 2x upsample + add; the crop guards odd sizes
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest")
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[..., :h, :w]
        return [conv(x) for conv, x in zip(self.fpn_convs, laterals)]


class IdentityNeck(nn.Module):
    """Passthrough neck (reference ``model/neck/identity_neck.py:6-13``),
    for backbones that already emit the encoder's ``embed_dims`` channels
    (UNet2D with ``out_feature=embed_dims``); no parameters."""

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return list(inputs)
