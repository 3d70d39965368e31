"""What the port's drivers (``eval_depth``, ``train``) share: the device
flag, the dataset factory, the logger and host-to-device batches."""
from __future__ import annotations

import logging
import sys
from typing import Dict

import numpy as np
import torch

from ..data.synthetic import SyntheticDataset


def add_device_arg(ap):
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")


def resolve_device(name: str) -> torch.device:
    """``cuda`` -> the first card, with fp32 (no TF32) convolutions and
    matmuls; exits non-zero when there is none. ``cpu`` -> the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit("selfocc_tpu_torch: --device cuda (the default) but no CUDA "
                 "device is available; pass --device cpu to run the plain "
                 "PyTorch versions on the CPU")
    # the exact tier is fp32: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def get_dataset(cfg, synthetic: bool, length: int = 64):
    """The synthetic scene. The real nuScenes loaders are not ported yet:
    without ``synthetic`` this raises instead of substituting data."""
    if not synthetic:
        raise NotImplementedError(
            "selfocc_tpu_torch has no real-data loaders yet (the nuScenes "
            "loaders come with a later slice of the port); pass --synthetic")
    n_sem = max(cfg.num_classes, cfg.model.head.sem_dims or 0)
    return SyntheticDataset(
        num_cams=cfg.num_cams, input_size=cfg.input_size,
        img_size=cfg.img_size, num_classes=n_sem, length=length)


def to_device(item, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in item.items() if not isinstance(v, (str, dict))}


def get_logger() -> logging.Logger:
    logger = logging.getLogger("selfocc_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(h)
    return logger
