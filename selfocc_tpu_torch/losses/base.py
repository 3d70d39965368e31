"""Loss registry and base class — counterpart of
``selfocc_tpu/losses/base.py`` (the reference's ``OPENOCC_LOSS`` registry,
``base_loss.py`` and ``multi_loss.py``). A loss is a callable
``loss(inputs: dict) -> scalar tensor``; ``input_dict`` remaps the inputs as
the reference configs do."""
from __future__ import annotations

from typing import Callable, Dict

OPENOCC_LOSS: Dict[str, Callable] = {}


def register(cls):
    OPENOCC_LOSS[cls.__name__] = cls
    return cls


def build_loss(cfg: dict):
    cfg = dict(cfg)
    name = cfg.pop("type")
    if name not in OPENOCC_LOSS:
        raise NotImplementedError(f"selfocc_tpu_torch: loss {name!r} is not "
                                  "ported")
    return OPENOCC_LOSS[name](**cfg)


class BaseLoss:
    """Remaps ``inputs`` through ``input_dict`` then calls ``loss_func``
    (reference ``base_loss.py:8-39``)."""

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        self.weight = weight
        self.input_dict = input_dict or {"input": "input"}

    def loss_func(self, **kwargs):  # pragma: no cover - overridden
        raise NotImplementedError

    def __call__(self, inputs):
        actual = {k: inputs[v] for k, v in self.input_dict.items()}
        return self.weight * self.loss_func(**actual)


@register
class MultiLoss:
    """Weighted sum (reference ``loss/multi_loss.py:10-44``): returns
    ``(total, {loss class name: weighted value})``."""

    def __init__(self, loss_cfgs):
        if not isinstance(loss_cfgs, (list, tuple)):
            raise TypeError("MultiLoss takes a list of loss configs")
        self.losses = [build_loss(c) for c in loss_cfgs]

    def __call__(self, inputs):
        tot = 0.0
        loss_dict = {}
        for fn in self.losses:
            val = fn(inputs)
            tot = tot + val
            loss_dict[type(fn).__name__] = val
        return tot, loss_dict
