"""What the port's drivers (``eval_depth``, ``eval_iou``,
``eval_iou_kitti``, ``eval_novel_depth``, ``eval_novel_depth_kitti``,
``train``, ``vis_pics``, ``vis_3d``, ``vis_3d_scene``) share:
the device flag, the weights flags, the dataset factory, the logger (the
JAX package's ``utils/logging_util``, copied: stdout plus
``<work-dir>/<time>.log``) and host-to-device batches."""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional
from typing import Dict

import numpy as np
import torch

from ..data.synthetic import SyntheticDataset
from . import logging_util


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


def checkpoint_path(path: str) -> str:
    """A ``train.py`` checkpoint: the file itself, or a work dir's
    ``ckpts/latest.pt``."""
    return os.path.join(path, "ckpts", "latest.pt") if os.path.isdir(path) \
        else path


def add_weights_args(ap):
    ap.add_argument("--ckpt-path", default="",
                    help="the port's own train.py checkpoint (a file, or a "
                         "work dir holding ckpts/latest.pt): its model entry")
    ap.add_argument("--torch-ckpt", default="",
                    help="a reference-SelfOcc .pth state dict")


# keys a reference checkpoint may lack: the reference's colour head is not
# this projection, so an authentic checkpoint keeps the seeded one
_OPTIONAL_KEYS = ("head.model.field.color_proj.",
                  "head.radiance_field.color_proj.")


def rename_keys(sd, extra) -> Dict:
    """``sd`` with the keys of ``extra`` renamed: ``{fork_key: port_key}``
    or ``{fork_key: (port_key, transform)}``, ``transform`` applied to the
    value (the port's counterpart of the JAX package's
    ``convert_reference_state_dict(extra=)``, ``ref_import.py:184-216``,
    whose entries name a flax path and a layout transform; the port's keys
    and layouts are the reference's, so most entries are a rename)."""
    out = {}
    for k, v in sd.items():
        if k in extra:
            to = extra[k]
            k, v = (to, v) if isinstance(to, str) else (to[0], to[1](v))
        out[k] = v
    return out


def load_weights(model, ckpt_path: str = "", torch_ckpt: str = "",
                 logger=None, extra=None):
    """Load ``--ckpt-path`` or ``--torch-ckpt`` into ``model`` (seeded
    weights stay where neither is given). A reference ``.pth`` (the JAX
    package's ``ref_import`` steps, ``restore_eval_variables``): the
    ``state_dict`` entry when there is one, ``module.`` prefixes stripped,
    ``num_batches_tracked`` dropped, then the keys of ``extra`` renamed to
    the port's (``rename_keys``: a fork that names a module otherwise);
    the port's keys are the reference's, so nothing else is transposed. A
    checkpoint without ``color_proj`` keeps the seeded one; keys the model
    does not have are logged; any other model key that the checkpoint lacks
    is an error."""
    if ckpt_path and torch_ckpt:
        raise SystemExit("give --ckpt-path or --torch-ckpt, not both")
    if ckpt_path:
        path = checkpoint_path(ckpt_path)
        model.load_state_dict(torch.load(path, map_location="cpu")["model"])
        if logger is not None:
            logger.info(f"weights from {path}")
        return
    if not torch_ckpt:
        return
    sd = torch.load(torch_ckpt, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    if extra:
        sd = rename_keys(sd, extra)
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd
                     and not k.startswith(_OPTIONAL_KEYS))
    if missing:
        raise RuntimeError(f"{torch_ckpt}: {len(missing)} model keys missing "
                           f"(first: {missing[:5]})")
    unmatched = sorted(k for k in sd if k not in own)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()
                           if k in own}, strict=False)
    if logger is not None:
        kept = sorted(k for k in own if k not in sd)
        logger.info(f"weights from {torch_ckpt}; seeded {kept}" if kept
                    else f"weights from {torch_ckpt}")
        if unmatched:
            logger.warning(f"{torch_ckpt}: {len(unmatched)} keys not "
                           f"imported (first: {unmatched[:5]})")


def get_dataset(cfg, synthetic: bool, phase: str = "train",
                length: int = 64):
    """The dataset a driver reads: with ``synthetic`` the procedural scene,
    else ``data.build_dataset(cfg, phase)`` (the nuScenes, SemanticKITTI
    and KITTI-raw loaders; phases ``train``, ``val`` and ``novel_eval``).
    When the real files are absent (KITTI-raw: its split file; it has no
    ``novel_eval``) it exits non-zero with an error that names the missing
    path: unlike the JAX ``train.get_dataloader``, it never substitutes
    synthetic data. A dataset type the port does not load raises
    NotImplementedError."""
    if not synthetic:
        from ..data import build_dataset
        try:
            return build_dataset(cfg, phase=phase)
        except FileNotFoundError as e:
            sys.exit(f"selfocc_tpu_torch: the real-data loaders found no "
                     f"data ({e}); put the {cfg.dataset_type} files there, "
                     "set the config's dataset args, or pass --synthetic")
    n_sem = max(cfg.num_classes, cfg.model.head.sem_dims or 0)
    return SyntheticDataset(
        num_cams=cfg.num_cams, input_size=cfg.input_size,
        img_size=cfg.img_size, num_classes=n_sem, length=length)


def host_arrays(item) -> Dict[str, np.ndarray]:
    """An item's numeric entries as numpy arrays: strings, tuples of
    strings (a KITTI-raw item's ``sequence``) and dicts are dropped."""
    out = {}
    for k, v in item.items():
        if isinstance(v, (str, dict)):
            continue
        a = np.asarray(v)
        if a.dtype.kind not in "USO":
            out[k] = a
    return out


def to_device(item, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device)
            for k, v in host_arrays(item).items()}


def get_logger(work_dir: Optional[str] = None) -> logging.Logger:
    """The drivers' logger: stdout, and with ``work_dir`` also a run log
    ``<work_dir>/<time>.log`` (``logging_util.get_logger``; a later
    driver in the same process adds its own work dir's file)."""
    return logging_util.get_logger(work_dir, name="selfocc_tpu_torch")
