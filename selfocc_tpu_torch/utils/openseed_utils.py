"""The offline OpenSeeD teacher maps — the port's copy of the jax-free part
of ``selfocc_tpu/utils/openseed_utils.py`` (``apply_label_lut``,
``SemTeacher``).

The reference runs OpenSeeD online as a frozen teacher producing 21-class
maps (``utils/openseed_utils.py:12-62``, ``train.py:98-100,213-215``). The
JAX package also reads them precomputed: per-image ``.npy`` label maps in a
directory (``wrapper_args=dict(sem_from=DIR)``), which ``SemTeacher``
streams, remapped to nuScenes classes with ``sem_apply_lut``. The port
reads the same maps; the JAX package's online teacher (``JaxSemTeacher``,
Swin + UperNet) is not ported.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

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
