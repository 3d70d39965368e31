"""SemanticKITTI voxel-label IO + class remapping — the port's copy of
``selfocc_tpu/data/semantic_kitti_io.py``.

Behavioral rewrite of ``dataset/kitti/io_data.py``: bit unpack/pack of the
occupancy bins, label/invalid readers, and the 34->20-class remap LUT. The
``LEARNING_MAP`` values come from the public semantic-kitti dataset config
(vendored as ``dataset/kitti/semantic-kitti.yaml`` in the reference).
"""
from __future__ import annotations

import numpy as np

# semantic-kitti.yaml learning_map (public dataset config)
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5}
LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72, 18: 80,
    19: 81}
LABELS_20 = ["unlabeled", "car", "bicycle", "motorcycle", "truck",
             "other-vehicle", "person", "bicyclist", "motorcyclist", "road",
             "parking", "sidewalk", "other-ground", "building", "fence",
             "vegetation", "trunk", "terrain", "pole", "traffic-sign"]


def unpack(compressed: np.ndarray) -> np.ndarray:
    """uint8 bitfield -> uint8 {0,1} array, 8x longer
    (reference ``io_data.py:10-23``)."""
    return np.unpackbits(compressed.astype(np.uint8))


def pack(array: np.ndarray) -> np.ndarray:
    """Inverse of :func:`unpack` (reference ``io_data.py:33-43``)."""
    return np.packbits(array.astype(bool))


def get_remap_lut() -> np.ndarray:
    """Completion remap: raw label -> 20 classes; 0 stays 'empty', unknown
    raw labels -> 255 invalid (reference ``io_data.py:77-97,173-194``)."""
    maxkey = max(LEARNING_MAP.keys())
    lut = np.zeros((maxkey + 100), dtype=np.int32)
    lut[list(LEARNING_MAP.keys())] = list(LEARNING_MAP.values())
    lut[lut == 0] = 255
    lut[0] = 0
    return lut


def get_inv_map() -> np.ndarray:
    inv = np.zeros(20, dtype=np.int32)
    inv[list(LEARNING_MAP_INV.keys())] = list(LEARNING_MAP_INV.values())
    return inv


def read_label(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.uint16).astype(np.float32)


def read_invalid(path: str) -> np.ndarray:
    return unpack(np.fromfile(path, dtype=np.uint8)).astype(np.float32)


def read_occupancy(path: str) -> np.ndarray:
    return unpack(np.fromfile(path, dtype=np.uint8)).astype(np.float32)


def read_semantic_kitti_voxels(label_path: str, invalid_path: str) -> np.ndarray:
    """Voxel labels remapped to 20 classes, invalids -> 255, reshaped to the
    256x256x32 grid (reference ``eval_iou_kitti.py:24-42``)."""
    lut = get_remap_lut()
    label = lut[read_label(label_path).astype(np.uint16)].astype(np.float32)
    invalid = read_invalid(invalid_path)
    label[np.isclose(invalid, 1)] = 255
    return label.reshape(256, 256, 32)
