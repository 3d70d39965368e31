"""HF EfficientNet checkpoints into the port's encoder — counterpart of
``selfocc_tpu/utils/effnet_import.py`` (``convert_hf_efficientnet``).

The port's ``models/efficientnet.EfficientNetEncoder`` is named as HF
``EfficientNetModel`` is (``google/efficientnet-b*``), and its convolutions
are torch's, so the conversion moves nothing: it strips a prefix
(``efficientnet.`` of ``EfficientNetForImageClassification``, ``module.``),
drops ``num_batches_tracked`` (the port's BatchNorm is flax's, which has
none) and what the encoder does not have (the classifier).
"""
from __future__ import annotations

from typing import Dict

import torch

_PREFIXES = ("module.", "efficientnet.")
_ENCODER_KEYS = ("embeddings.", "encoder.")


def convert_hf_efficientnet(state_dict) -> Dict[str, torch.Tensor]:
    """HF ``EfficientNetModel`` state dict -> the port's encoder state dict
    (``load_state_dict(strict=True)`` takes it)."""
    out = {}
    for key, val in state_dict.items():
        for p in _PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
        if key.endswith("num_batches_tracked") or \
                not key.startswith(_ENCODER_KEYS):
            continue
        out[key] = torch.as_tensor(val)
    return out
