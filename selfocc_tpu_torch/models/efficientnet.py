"""EfficientNet encoder, the UNet2D backbone's — counterpart of
``selfocc_tpu/models/efficientnet.py`` (the reference wraps
``tf_efficientnet_b7_ns`` from torch.hub,
``model/backbone/unet2d.py:166-180``).

Modules take and return NCHW tensors. The module tree is HF
``EfficientNetModel``'s (``embeddings.{convolution, batchnorm}``,
``encoder.blocks.{n}.{expansion, depthwise_conv, squeeze_excite,
projection}``, ``encoder.top_{conv, bn}``), so an HF state dict loads by
name (``utils/effnet_import.py``). The stride-2 depthwise convolutions pad
TF-style ("same", asymmetric: ``k // 2 - 1`` before, ``k // 2`` after) and
the stem pads (0, 1, 0, 1), as HF's explicit ``ZeroPad2d`` + VALID
convolutions do. BatchNorm is flax's with EfficientNet's constants
(momentum 0.99, eps 1e-3; ``models/resnet.BatchNorm2d``): batch statistics
and a running update from the biased variance in ``train()``, running
statistics in ``eval()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm2d

BN_MOMENTUM = 0.99


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    """HF ``EfficientNetConfig`` equivalents; defaults are the base (B0)
    stage table — B7 is ``width_coefficient=2.0, depth_coefficient=3.1``
    (the variant the reference's UNet2D wraps)."""
    width_coefficient: float = 1.0
    depth_coefficient: float = 1.0
    depth_divisor: int = 8
    kernel_sizes: Tuple[int, ...] = (3, 3, 5, 3, 5, 5, 3)
    in_channels: Tuple[int, ...] = (32, 16, 24, 40, 80, 112, 192)
    out_channels: Tuple[int, ...] = (16, 24, 40, 80, 112, 192, 320)
    strides: Tuple[int, ...] = (1, 2, 2, 2, 1, 2, 1)
    num_block_repeats: Tuple[int, ...] = (1, 2, 2, 3, 3, 4, 1)
    expand_ratios: Tuple[int, ...] = (1, 6, 6, 6, 6, 6, 6)
    squeeze_expansion_ratio: float = 0.25
    top_channels: int = 1280
    batch_norm_eps: float = 1e-3

    def round_filters(self, c: int) -> int:
        """HF ``round_filters`` (``modeling_efficientnet.py:33-49``)."""
        d = self.depth_divisor
        c = c * self.width_coefficient
        new = max(d, int(c + d / 2) // d * d)
        if new < 0.9 * c:
            new += d
        return int(new)

    def round_repeats(self, r: int) -> int:
        return int(math.ceil(self.depth_coefficient * r))


B7 = EfficientNetConfig(width_coefficient=2.0, depth_coefficient=3.1)


def _pad_asym(x, k: int, adjust: bool = True):
    """TF 'same' pad of a stride-2 conv on NCHW: (k//2 - 1, k//2) on each
    spatial dim when ``adjust`` (HF ``correct_pad``), else k//2 each side."""
    c = k // 2
    lo = c - 1 if adjust else c
    return F.pad(x, (lo, c, lo, c))


def _bn(cfg: EfficientNetConfig, c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=cfg.batch_norm_eps, momentum=BN_MOMENTUM)


class _Expansion(nn.Module):
    def __init__(self, cfg, cin, dim):
        super().__init__()
        self.expand_conv = nn.Conv2d(cin, dim, 1, bias=False)
        self.expand_bn = _bn(cfg, dim)

    def forward(self, x):
        return F.silu(self.expand_bn(self.expand_conv(x)))


class _Depthwise(nn.Module):
    def __init__(self, cfg, dim, kernel, stride, adjust_padding):
        super().__init__()
        self.stride, self.kernel, self.adjust = stride, kernel, adjust_padding
        self.depthwise_conv = nn.Conv2d(
            dim, dim, kernel, stride=stride,
            padding=0 if stride == 2 else kernel // 2, groups=dim,
            bias=False)
        self.depthwise_norm = _bn(cfg, dim)

    def forward(self, x):
        if self.stride == 2:
            x = _pad_asym(x, self.kernel, self.adjust)
        return F.silu(self.depthwise_norm(self.depthwise_conv(x)))


class _SqueezeExcite(nn.Module):
    def __init__(self, dim, se_dim):
        super().__init__()
        self.reduce = nn.Conv2d(dim, se_dim, 1)
        self.expand = nn.Conv2d(se_dim, dim, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.expand(F.silu(self.reduce(s))))
        return x * s


class _Projection(nn.Module):
    def __init__(self, cfg, dim, cout):
        super().__init__()
        self.project_conv = nn.Conv2d(dim, cout, 1, bias=False)
        self.project_bn = _bn(cfg, cout)

    def forward(self, x):
        return self.project_bn(self.project_conv(x))


class MBConv(nn.Module):
    """One MBConv block (HF ``EfficientNetBlock``): expand 1x1 -> depthwise
    (TF-same) -> SE -> project 1x1 (+residual when stride 1 and not the
    stage's first block)."""

    def __init__(self, cfg: EfficientNetConfig, in_dim: int, out_dim: int,
                 stride: int, kernel: int, expand_ratio: int, id_skip: bool,
                 adjust_padding: bool = True):
        super().__init__()
        dim = in_dim * expand_ratio
        self.residual = stride == 1 and not id_skip
        self.expansion = _Expansion(cfg, in_dim, dim) \
            if expand_ratio != 1 else None
        self.depthwise_conv = _Depthwise(cfg, dim, kernel, stride,
                                         adjust_padding)
        # squeeze-excite: the reduction is sized from the pre-expansion dim
        self.squeeze_excite = _SqueezeExcite(
            dim, max(1, int(in_dim * cfg.squeeze_expansion_ratio)))
        self.projection = _Projection(cfg, dim, out_dim)

    def forward(self, x):
        inp = x
        if self.expansion is not None:
            x = self.expansion(x)
        x = self.projection(self.squeeze_excite(self.depthwise_conv(x)))
        return x + inp if self.residual else x   # drop-connect: eval identity


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg.round_filters(32)
        self.convolution = nn.Conv2d(3, c, 3, stride=2, bias=False)
        self.batchnorm = _bn(cfg, c)

    def forward(self, x):
        # stem: pad (0, 1, 0, 1) + 3x3/2 VALID (HF EfficientNetEmbeddings)
        return F.silu(self.batchnorm(self.convolution(F.pad(x, (0, 1, 0, 1)))))


class _Blocks(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        blocks, self.stage_ends = [], []
        for i in range(len(cfg.in_channels)):
            for j in range(cfg.round_repeats(cfg.num_block_repeats[i])):
                blocks.append(MBConv(
                    cfg,
                    in_dim=cfg.round_filters(
                        cfg.in_channels[i] if j == 0 else
                        cfg.out_channels[i]),
                    out_dim=cfg.round_filters(cfg.out_channels[i]),
                    stride=cfg.strides[i] if j == 0 else 1,
                    kernel=cfg.kernel_sizes[i],
                    expand_ratio=cfg.expand_ratios[i], id_skip=(j == 0)))
            self.stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)
        top = cfg.round_filters(cfg.top_channels)
        self.top_conv = nn.Conv2d(cfg.round_filters(cfg.out_channels[-1]),
                                  top, 1, bias=False)
        self.top_bn = _bn(cfg, top)


class EfficientNetEncoder(nn.Module):
    """Stem + 7 MBConv stages + top conv. Returns ``(stem, stages, top)``,
    ``stages`` the 7 stage outputs — the taps UNet2D reads (reference
    ``unet2d.py:97-103``: stages 0, 1, 2, 4 + conv_head)."""

    def __init__(self, cfg: EfficientNetConfig = EfficientNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Blocks(cfg)

    def forward(self, x):
        stem = h = self.embeddings(x)
        stages: List[torch.Tensor] = []
        for n, block in enumerate(self.encoder.blocks):
            h = block(h)
            if n + 1 in self.encoder.stage_ends:
                stages.append(h)
        e = self.encoder
        top = F.silu(e.top_bn(e.top_conv(h)))
        return stem, stages, top
