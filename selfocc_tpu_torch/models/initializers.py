"""Seeded initialisers that mirror the flax ones of the JAX package.

Flax's defaults differ from PyTorch's: ``nn.Dense``/``nn.Conv`` kernels are
LeCun-normal (truncated normal, std sqrt(1/fan_in) / 0.8796) with zero bias;
attention projections use Xavier-uniform; embeddings use normal(1.0).
``init_weights`` applies those distributions to a port model from an explicit
``torch.Generator``. A module with its own rule defines
``reset_parameters_like_jax(generator)``; parents are visited after their
children so a parent's rule wins over the default one for its sub-layers.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(std)
    return t


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator):
    return nn.init.xavier_uniform_(t, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    return nn.init.normal_(t, 0.0, std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in reversed(list(model.modules())):
        if hasattr(m, "reset_parameters_like_jax"):
            m.reset_parameters_like_jax(generator)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
