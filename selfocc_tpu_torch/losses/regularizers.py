"""SDF regularizers — counterpart of ``EikonalLoss`` and ``SecondGradLoss``
of ``selfocc_tpu/losses/regularizers.py``."""
from __future__ import annotations

import torch

from .base import BaseLoss, register


@register
class EikonalLoss(BaseLoss):
    """``((|grad sdf| - 1)^2).mean()`` (reference ``eikonal_loss.py:19-22``)."""

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"eik_grad": "eik_grad"}

    def loss_func(self, eik_grad):
        norm = torch.linalg.norm(eik_grad, dim=-1)
        return torch.mean((norm - 1.0) ** 2)


@register
class SecondGradLoss(BaseLoss):
    """``|second derivative|.mean()`` (reference
    ``second_grad_loss.py:19-20``)."""

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"second_grad": "second_grad"}

    def loss_func(self, second_grad):
        return second_grad.abs().mean()
