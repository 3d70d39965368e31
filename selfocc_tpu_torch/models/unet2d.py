"""UNet2D backbone (AdaBins encoder/decoder) — counterpart of
``selfocc_tpu/models/unet2d.py`` (reference ``model/backbone/unet2d.py``).

An EfficientNet encoder (``models/efficientnet.py``, B7 by default) feeds
the AdaBins ``DecoderBN``: per level a bilinear ``align_corners=True``
upsample, a skip concat and two conv-BN-LeakyReLU blocks (``UpSampleBN``),
emitting ``out_feature``-channel maps at strides 1/2, 1/4, 1/8, 1/16.
Modules take and return NCHW tensors.

The reference's quirks are kept: ``conv2`` is a 1x1 convolution with
``padding=1`` (it grows the bottleneck map by a one-pixel ring that the
first upsample blends in); the encoder taps are stage outputs 0/1/2/4 and
the top conv (strides 2/4/8/16/32); the decoder halves its channels from
``features // 2`` at 1/16 to ``features // 16`` at 1/2. State-dict keys are
the reference's: ``decoder.conv2``, ``decoder.up{16,8,4,2}._net.{0,1,3,4}``
(conv, BatchNorm, conv, BatchNorm), ``decoder.resize_output_{1_2, 1_4,
1_8, 1_16}``, and the encoder's HF keys under ``encoder.``. The decoder's
BatchNorm is flax's at momentum 0.9, eps 1e-5.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .efficientnet import B7, EfficientNetConfig, EfficientNetEncoder
from .resnet import BatchNorm2d


def resize_bilinear_ac(x, h: int, w: int):
    """NCHW bilinear resize with torch ``align_corners=True`` semantics."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class UpSampleBN(nn.Module):
    """Upsample (align_corners=True) + skip concat + 2x (conv-BN-LeakyReLU)
    (reference ``unet2d.py:11-33``)."""

    def __init__(self, skip_input: int, output_features: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, output_features, 3, padding=1),
            BatchNorm2d(output_features), nn.LeakyReLU(),
            nn.Conv2d(output_features, output_features, 3, padding=1),
            BatchNorm2d(output_features), nn.LeakyReLU())

    def forward(self, x, concat_with):
        up = resize_bilinear_ac(x, *concat_with.shape[-2:])
        return self._net(torch.cat([up, concat_with], dim=1))


class DecoderBN(nn.Module):
    """AdaBins decoder (reference ``DecoderBN``, ``unet2d.py:36-142``).
    ``tap_channels``: the channels of the four skip taps (strides 2, 4, 8,
    16), ``num_features`` the top map's."""

    def __init__(self, out_feature: int, num_features: int,
                 tap_channels: Sequence[int]):
        super().__init__()
        f = num_features
        c0, c1, c2, c3 = tap_channels
        self.conv2 = nn.Conv2d(f, f, 1, padding=1)
        self.up16 = UpSampleBN(f + c3, f // 2)
        self.up8 = UpSampleBN(f // 2 + c2, f // 4)
        self.up4 = UpSampleBN(f // 4 + c1, f // 8)
        self.up2 = UpSampleBN(f // 8 + c0, f // 16)
        for name, c in (("1_2", f // 16), ("1_4", f // 8), ("1_8", f // 4),
                        ("1_16", f // 2)):
            self.add_module(f"resize_output_{name}",
                            nn.Conv2d(c, out_feature, 1))

    def forward(self, taps) -> List[torch.Tensor]:
        """taps: 5 NCHW maps at strides 2/4/8/16/32 (stages 0/1/2/4 + top)."""
        b0, b1, b2, b3, b4 = taps
        x_1_16 = self.up16(self.conv2(b4), b3)
        x_1_8 = self.up8(x_1_16, b2)
        x_1_4 = self.up4(x_1_8, b1)
        x_1_2 = self.up2(x_1_4, b0)
        return [self.resize_output_1_2(x_1_2), self.resize_output_1_4(x_1_4),
                self.resize_output_1_8(x_1_8),
                self.resize_output_1_16(x_1_16)]


class UNet2D(nn.Module):
    """EfficientNet encoder + AdaBins decoder emitting a 4-level pyramid at
    strides 1/2 .. 1/16 with ``out_feature`` channels each."""

    TAPS = (0, 1, 2, 4)   # reference features[4, 5, 6, 8] (+ conv_head)

    def __init__(self, out_feature: int = 128,
                 encoder_cfg: EfficientNetConfig = B7):
        super().__init__()
        self.encoder = EfficientNetEncoder(encoder_cfg)
        c = encoder_cfg
        self.decoder = DecoderBN(
            out_feature, c.round_filters(c.top_channels),
            [c.round_filters(c.out_channels[i]) for i in self.TAPS])

    def forward(self, x) -> List[torch.Tensor]:
        _, stages, top = self.encoder(x)
        return self.decoder([stages[i] for i in self.TAPS] + [top])
