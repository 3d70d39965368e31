"""Image backbones — counterpart of ``selfocc_tpu/models/resnet.py``.

``ResNet50`` keeps torchvision/mmdet naming (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1,2,3}``, ``downsample.{0,1}``) so its state-dict keys
are the reference's ``img_backbone.*`` keys. BatchNorm is flax's
(``selfocc_tpu/models/resnet.py:30,65``): batch statistics in train mode,
running statistics in eval mode, and no ``num_batches_tracked`` buffer, which
the reference export does not have either. Modules take and return NCHW
tensors.

``ResNet50(dtype=torch.bfloat16)`` is the JAX package's ``dtype=`` (bf16
compute, the reference's AMP analog; ``resnet.py:25-85``): the input is cast
at the stem, each convolution runs at its input's dtype on its fp32
weights rounded to it, and BatchNorm normalises in fp32 and returns its
input's dtype, as flax's does. Parameters and gradients stay fp32.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW: in train
    mode it normalises with the batch statistics and updates
    ``running = 0.9 * running + 0.1 * batch`` with the biased batch variance
    (torch's ``BatchNorm2d`` takes the unbiased one); in eval mode it
    normalises with the running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters_like_jax(self, generator):
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if x.dtype != self.weight.dtype:
            # flax: statistics and normalisation in fp32, the result in the
            # compute dtype
            return self.forward(x.float()).to(x.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # batch statistics for the output (one fused op), the biased
        # variance again for the running update
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var, alpha=1 - m)
        return out


def conv_at_input_dtype(conv: nn.Conv2d, x):
    """``conv(x)`` computed in ``x``'s dtype: the weights (and bias) are
    rounded to it, as flax's ``nn.Conv(dtype=)`` does."""
    if x.dtype == conv.weight.dtype:
        return conv(x)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return conv._conv_forward(x, conv.weight.to(x.dtype), bias)


class Bottleneck(nn.Module):
    """'pytorch'-style bottleneck: stride on conv2."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        conv = conv_at_input_dtype
        out = F.relu(self.bn1(conv(self.conv1, x)))
        out = F.relu(self.bn2(conv(self.conv2, out)))
        out = self.bn3(conv(self.conv3, out))
        identity = x if self.downsample is None else \
            self.downsample[1](conv(self.downsample[0], x))
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """Four stage features (C2..C5), channels 256/512/1024/2048, in
    ``dtype`` (None: the input's)."""

    STAGE_BLOCKS = (3, 4, 6, 3)

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes, planes = 64, 64
        for stage, blocks in enumerate(self.STAGE_BLOCKS):
            layer = []
            for blk in range(blocks):
                stride = 2 if (stage > 0 and blk == 0) else 1
                layer.append(Bottleneck(inplanes, planes, stride,
                                        downsample=(blk == 0)))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
            planes *= 2

    def forward(self, x) -> List[torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.bn1(conv_at_input_dtype(self.conv1, x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(len(self.STAGE_BLOCKS)):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs


def _same_pad(x, kernel: int, stride: int):
    """flax ``padding="SAME"``: output ceil(n / stride), the odd pixel of
    padding goes after (asymmetric on even sizes)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):          # F.pad order: W, then H
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TinyBackbone(nn.Module):
    """4-level strided-conv stub with ResNet-shaped pyramids (test/CI
    stand-in; the JAX twin uses ``padding="SAME"`` with strides 4, 2, 2, 2)."""

    def __init__(self, channels: Sequence[int] = (256, 512, 1024, 2048)):
        super().__init__()
        cin = 3
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3))
            cin = ch
        self.num_levels = len(channels)

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for i in range(self.num_levels):
            stride = 4 if i == 0 else 2
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv2d(_same_pad(x, 3, stride), conv.weight,
                                conv.bias, stride=stride))
            outs.append(x)
        return outs
