"""Checkpoints of the port's ``train.py`` and the ImageNet backbone import —
counterpart of ``selfocc_tpu/utils/checkpoint.py``.

A checkpoint is one ``torch.save`` file: ``model``, ``optimizer``, ``step``
(optimizer steps taken), ``epoch`` and ``last_iter``, the number of items
of ``epoch`` already trained on (0 at an epoch's end), which a resume with
``--iter-resume`` skips (the reference's ``iter.pth``, ``train.py:273-301``).
``load_torch_resnet50`` loads torchvision's ResNet-50 weights
(``resnet50-0676ba61.pth``) into the model's ``img_backbone``.
"""
from __future__ import annotations

import glob
import os
import shutil
from typing import Dict

import torch

KEEP_ITER_CHECKPOINTS = 3


def save_checkpoint(ckpt_dir: str, name: str, state: Dict) -> str:
    """Write ``state`` to ``<ckpt_dir>/<name>.pt`` and make ``latest.pt``
    the same file (a hard link, or a copy where the file system has none);
    keeps the newest ``KEEP_ITER_CHECKPOINTS`` ``iter_*.pt``. Returns the
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.pt")
    torch.save(state, path)
    latest = os.path.join(ckpt_dir, "latest.pt")
    if os.path.lexists(latest):
        os.remove(latest)
    try:
        os.link(path, latest)
    except OSError:
        shutil.copyfile(path, latest)
    iters = sorted(glob.glob(os.path.join(ckpt_dir, "iter_*.pt")),
                   key=lambda p: int(p.rsplit("_", 1)[1][:-3]))
    for old in iters[:-KEEP_ITER_CHECKPOINTS]:
        os.remove(old)
    return path


def load_torch_resnet50(model: torch.nn.Module, pth_path: str) -> int:
    """Load a torchvision ResNet-50 state dict (``conv1``, ``bn1``,
    ``layer{1..4}.*``; ``fc.*`` and ``num_batches_tracked`` dropped, a
    ``state_dict`` entry unwrapped) into ``model.img_backbone``, whose keys
    are torchvision's. Refuses a missing key, an unknown key or a shape
    that differs, before anything is loaded. Returns the number of tensors
    loaded."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    sd = {k: v for k, v in sd.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    own = model.img_backbone.state_dict()
    missing = sorted(set(own) - set(sd))
    unknown = sorted(set(sd) - set(own))
    wrong = sorted(k for k in set(own) & set(sd)
                   if tuple(own[k].shape) != tuple(sd[k].shape))
    if missing or unknown or wrong:
        raise RuntimeError(
            f"{pth_path}: not a torchvision ResNet-50 state dict: "
            f"{len(missing)} keys missing (first: {missing[:3]}), "
            f"{len(unknown)} unknown (first: {unknown[:3]}), "
            f"{len(wrong)} of another shape (first: {wrong[:3]})")
    model.img_backbone.load_state_dict(sd, strict=True)
    return len(sd)
