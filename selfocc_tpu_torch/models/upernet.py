"""UperNet semantic-segmentation head over the Swin backbone — counterpart
of ``selfocc_tpu/models/upernet.py``: with ``models/swin.py`` the online
semantic teacher that stands in for the reference's OpenSeeD
(``utils/openseed_utils.py:12-62``).

The module tree is HF ``UperNetForSemanticSegmentation``'s main branch
(``backbone.*``, ``decode_head.{psp_modules.{i}.1, bottleneck,
lateral_convs.{i}, fpn_convs.{i}, fpn_bottleneck}.{conv, batch_norm}``,
``decode_head.classifier``); the auxiliary FCN head is a training branch
and is left out. The teacher runs in ``eval()`` mode: BatchNorm from the
running statistics, as the JAX module's always does. The resizes are
``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``:
``jax.image.resize``'s "linear" widens its filter when it downsamples (a
pyramid pool of 6 over a map smaller than 6), and the antialiased mode
does the same; upsampling, both are torch's plain half-pixel bilinear.
NCHW throughout.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm2d
from .swin import SwinBackbone, SwinConfig


def resize_bilinear(x, size):
    """(B, C, h, w) -> (B, C, *size), ``jax.image.resize(..., "linear")``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def adaptive_avg_pool(x, out: int):
    """torch ``AdaptiveAvgPool2d`` bins on NCHW: [floor(i*H/S),
    ceil((i+1)*H/S))."""
    return F.adaptive_avg_pool2d(x, out)


class ConvModule(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU (HF ``UperNetConvModule``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2,
                              bias=False)
        self.batch_norm = BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.batch_norm(self.conv(x)))


class _PoolingBlock(nn.Module):
    """HF ``UperNetPyramidPoolingBlock``: its ``0`` is the pool (no
    parameters), its ``1`` the ConvModule."""

    def __init__(self, scale: int, cin: int, cout: int):
        super().__init__()
        self.scale = scale
        self.add_module("1", ConvModule(cin, cout, 1))

    def forward(self, x):
        return getattr(self, "1")(adaptive_avg_pool(x, self.scale))


class UperNetHead(nn.Module):
    """PSP + FPN decode head (HF ``UperNetHead``,
    ``modeling_upernet.py:120-203``); ``in_channels`` of the backbone maps,
    finest first."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6)):
        super().__init__()
        top = in_channels[-1]
        self.psp_modules = nn.ModuleList(
            _PoolingBlock(s, top, channels) for s in pool_scales)
        self.bottleneck = ConvModule(top + len(pool_scales) * channels,
                                     channels, 3)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(channels, channels, 3) for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels,
                                         channels, 3)
        self.classifier = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """feats: backbone maps at strides 4..32, finest first; returns
        logits at the finest map's resolution."""
        top = feats[-1]
        psp = [top] + [resize_bilinear(m(top), top.shape[-2:])
                       for m in self.psp_modules]
        lats = [conv(f) for conv, f in zip(self.lateral_convs, feats[:-1])]
        lats.append(self.bottleneck(torch.cat(psp, dim=1)))
        for i in range(len(lats) - 1, 0, -1):
            lats[i - 1] = lats[i - 1] + resize_bilinear(
                lats[i], lats[i - 1].shape[-2:])
        outs = [conv(x) for conv, x in zip(self.fpn_convs, lats[:-1])]
        outs.append(lats[-1])
        outs = [outs[0]] + [resize_bilinear(o, outs[0].shape[-2:])
                            for o in outs[1:]]
        return self.classifier(self.fpn_bottleneck(torch.cat(outs, dim=1)))


class SwinUperNet(nn.Module):
    """The teacher: Swin backbone -> UperNet head -> per-pixel logits at
    the input resolution (HF ``UperNetForSemanticSegmentation``'s main
    head)."""

    def __init__(self, num_classes: int, swin: SwinConfig = SwinConfig(),
                 channels: int = 512):
        super().__init__()
        self.backbone = SwinBackbone(swin)
        self.decode_head = UperNetHead(
            [swin.embed_dim * 2 ** i for i in range(len(swin.depths))],
            num_classes, channels)

    def forward(self, images) -> torch.Tensor:
        """images (B, 3, H, W) normalised -> (B, num_classes, H, W)."""
        logits = self.decode_head(self.backbone(images))
        return resize_bilinear(logits, images.shape[-2:])
