"""The semantic teacher — counterpart of
``selfocc_tpu/utils/openseed_utils.py``: a copy of its jax-free part
(``apply_label_lut``, ``SemTeacher``) and ``TorchSemTeacher``, the
counterpart of its ``JaxSemTeacher``.

The reference runs OpenSeeD online as a frozen teacher producing 21-class
maps (``utils/openseed_utils.py:12-62``, ``train.py:98-100,213-215``). The
JAX package reads them precomputed, per-image ``.npy`` label maps in a
directory (``wrapper_args=dict(sem_from=DIR)``), which ``SemTeacher``
streams, remapped to nuScenes classes with ``sem_apply_lut``; or computes
them online with a Swin + UperNet teacher from an HF checkpoint
(``train.py --teacher-ckpt``, ``tools/precompute_sem_jax.py``). The port
does both: ``SemTeacher`` reads the same maps, ``TorchSemTeacher`` runs
the port's Swin + UperNet (``models/swin.py``, ``models/upernet.py``) on
the card (``selfocc_tpu_torch/train.py --teacher-ckpt``,
``selfocc_tpu_torch/tools/precompute_sem.py``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import openseed2nuscenes

NUSCENES_CLASSES = [
    "barrier", "bicycle", "bus", "car", "construction_vehicle", "crane",
    "motorcycle", "person", "traffic_cone", "trailer", "trailer_truck",
    "truck", "road", "other_flat", "sidewalk", "terrain", "grass",
    "building", "wall", "tree", "sky"]


def apply_label_lut(sem: np.ndarray, lut) -> np.ndarray:
    """Remap a label map through a user LUT: an int array indexed by class
    (out-of-range ids clamp to the last entry, matching np.take 'clip'), or
    any callable. The wiring point for teachers in a non-OpenSeeD label
    space (docs/PARITY.md teacher caveat)."""
    if callable(lut):
        return lut(sem)
    lut = np.asarray(lut)
    return lut[np.clip(np.asarray(sem, np.int64), 0, len(lut) - 1)]


class SemTeacher:
    """Streams precomputed OpenSeeD label maps, remapped to nuScenes classes.

    ``lut`` overrides the default openseed->nuscenes remap for teachers in
    another label space (array indexed by teacher class, or callable);
    ``apply_lut=False`` keeps the teacher space (sem_space="openseed"
    training)."""

    def __init__(self, sem_dir: str, apply_lut: bool = True, lut=None):
        self.sem_dir = sem_dir
        self.apply_lut = apply_lut
        self.lut = lut if lut is not None else openseed2nuscenes

    def available(self) -> bool:
        return bool(self.sem_dir) and os.path.isdir(self.sem_dir)

    def load_sem_map(self, img_path: str) -> Optional[np.ndarray]:
        """Map an image path to its precomputed ``.npy`` semantic map."""
        if not self.available():
            return None
        rel = os.path.basename(img_path) + ".npy"
        path = os.path.join(self.sem_dir, rel)
        if not os.path.exists(path):
            return None
        sem = np.load(path)
        if self.apply_lut:
            sem = apply_label_lut(sem, self.lut)
        return sem

    def load_batch(self, img_paths) -> Optional[np.ndarray]:
        maps = [self.load_sem_map(p) for p in img_paths]
        if any(m is None for m in maps):
            return None
        return np.stack(maps)


class TorchSemTeacher:
    """The frozen Swin + UperNet semantic teacher (``JaxSemTeacher``), with
    the reference's ``forward_openseed_model`` contract
    (``utils/openseed_utils.py:55-62``): resize the batch to height 512
    (aspect kept), normalise with ImageNet's mean and std, forward, upsample
    the logits to the requested size, argmax into uint8 class maps, then
    the optional ``lut``.

    The resizes are ``jax.image.resize``'s: the image's "cubic" is
    ``F.interpolate(mode="bicubic", align_corners=False, antialias=True)``
    (Keys' cubic at a = -0.5, widened when it downsamples; without
    ``antialias`` torch's bicubic is a = -0.75 and unfiltered, up to 127
    apart on [0, 255] at 768x1600 -> 512x1067), the logits' "linear" the
    antialiased bilinear. The reference resizes bicubic with
    ``align_corners=True``; the JAX package keeps half-pixel, and so does
    the port. Runs in fp32 under ``torch.no_grad()`` on the model's device
    and returns a tensor there."""

    IMAGENET_MEAN = (123.675, 116.28, 103.53)
    IMAGENET_STD = (58.395, 57.12, 57.375)

    def __init__(self, state_dict, num_classes: int = 21, swin_cfg=None,
                 channels: int = 512, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 lut=None, device=None):
        from ..models.swin import SwinConfig
        from ..models.upernet import SwinUperNet
        self.model = SwinUperNet(num_classes, swin_cfg or SwinConfig(),
                                 channels)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval().to(device)
        self.device = next(self.model.parameters()).device
        self.mean = torch.tensor(mean, device=self.device).view(1, 3, 1, 1)
        self.std = torch.tensor(std, device=self.device).view(1, 3, 1, 1)
        self.lut = None if lut is None else torch.as_tensor(
            np.asarray(lut), device=self.device).long()

    @classmethod
    def from_checkpoint(cls, path: str, **kw):
        """The teacher of an HF UperNet (Swin) checkpoint (``.pt``,
        ``.bin``, ``.safetensors``), its architecture read from the
        parameter shapes."""
        import re
        from ..models.swin import SwinConfig
        from .swin_import import load_teacher_checkpoint
        sd = load_teacher_checkpoint(path)
        cls_w = sd["decode_head.classifier.weight"]
        kw.setdefault("num_classes", int(cls_w.shape[0]))
        kw.setdefault("channels", int(cls_w.shape[1]))
        if kw.get("swin_cfg") is None:
            depths, heads, window = {}, {}, None
            for k, v in sd.items():
                m = re.match(r"backbone\.encoder\.layers\.(\d+)\.blocks\."
                             r"(\d+)\.", k)
                if m:
                    i, j = int(m.group(1)), int(m.group(2))
                    depths[i] = max(depths.get(i, 0), j + 1)
                    if k.endswith("relative_position_bias_table"):
                        heads[i] = int(v.shape[1])
                        window = (int(round(v.shape[0] ** 0.5)) + 1) // 2
            proj = sd["backbone.embeddings.patch_embeddings.projection.weight"]
            kw["swin_cfg"] = SwinConfig(
                patch_size=int(proj.shape[-1]), embed_dim=int(proj.shape[0]),
                depths=tuple(depths[i] for i in sorted(depths)),
                num_heads=tuple(heads[i] for i in sorted(heads)),
                window_size=window)
        return cls(sd, **kw)

    @torch.no_grad()
    def logits(self, imgs, size=None) -> torch.Tensor:
        """imgs (B, H, W, 3) RGB in [0, 255] (numpy or tensor) -> (B, C,
        *size) fp32 logits (``size`` defaults to the input's)."""
        x = torch.as_tensor(np.asarray(imgs) if not torch.is_tensor(imgs)
                            else imgs).to(self.device, torch.float32)
        b, h, w, _ = x.shape
        size = tuple(size) if size is not None else (h, w)
        rh, rw = 512, int(round(512 * w / h))
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(rh, rw),
                          mode="bicubic", align_corners=False,
                          antialias=True)
        logits = self.model((x - self.mean) / self.std)
        return F.interpolate(logits, size=size, mode="bilinear",
                             align_corners=False, antialias=True)

    @torch.no_grad()
    def __call__(self, imgs, size=None) -> torch.Tensor:
        """imgs (B, H, W, 3) RGB in [0, 255] -> (B, *size) uint8 class maps
        on the teacher's device, remapped through ``lut`` when the
        checkpoint's label space differs from the training space."""
        maps = self.logits(imgs, size).argmax(dim=1)
        if self.lut is not None:
            maps = self.lut[maps.clamp(0, len(self.lut) - 1)]
        return maps.to(torch.uint8)
