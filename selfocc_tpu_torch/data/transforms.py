"""Multi-view image transforms (host-side numpy/cv2 pipeline) — the port's
copy of ``selfocc_tpu/data/transforms.py``.

Behavioral rewrite of ``dataset/transform_3d.py``: photometric distortion,
ImageNet normalization (BGR->RGB), random per-camera scaling with
focal-ratio bookkeeping, padding, random flip. Images are HWC float32 BGR on
entry (the reference loads with mmcv ``imread`` = cv2 BGR).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import cv2
import numpy as np

IMG_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)


class PadMultiViewImage:
    """Pad to a fixed size or to a multiple (reference ``transform_3d.py:8-76``)."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        assert size is not None or size_divisor is not None
        if size is not None:
            size_divisor = None
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def _pad(self, img):
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = -(-h // d) * d, -(-w // d) * d
        out = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
        out[:h, :w] = img
        return out

    def __call__(self, results):
        results["img"] = [self._pad(i) for i in results["img"]]
        return results


class NormalizeMultiviewImage:
    """mean/std normalize, optional BGR->RGB (``transform_3d.py:79-112``)."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def _norm(self, img):
        img = img.astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        return (img - self.mean) / self.std

    def __call__(self, results):
        results["img"] = [self._norm(i) for i in results["img"]]
        return results


class RandomFlip:
    """Horizontal flip of all views (``transform_3d.py:114-124``)."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, results):
        flip = np.random.random() < self.prob
        if flip:
            results["img"] = [np.ascontiguousarray(i[:, ::-1])
                              for i in results["img"]]
        results["flip"] = flip
        return results


class PhotoMetricDistortionMultiViewImage:
    """Brightness/contrast/saturation/hue jitter (``transform_3d.py:126-230``),
    applied per view in BGR float space via cv2 HSV round trips."""

    def __init__(self, brightness_delta=32, contrast_range=(0.8, 1.2),
                 saturation_range=(0.8, 1.2), hue_delta=18,
                 use_swap_channel=True):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta
        self.use_swap_channel = use_swap_channel

    def _distort(self, img):
        rnd = np.random
        if rnd.randint(2):
            img = img + rnd.uniform(-self.brightness_delta,
                                    self.brightness_delta)
        mode = rnd.randint(2)
        if mode == 1 and rnd.randint(2):
            img = img * rnd.uniform(self.contrast_lower, self.contrast_upper)
        hsv = cv2.cvtColor(img.astype(np.float32), cv2.COLOR_BGR2HSV)
        if rnd.randint(2):
            hsv[..., 1] *= rnd.uniform(self.saturation_lower,
                                       self.saturation_upper)
        if rnd.randint(2):
            hsv[..., 0] += rnd.uniform(-self.hue_delta, self.hue_delta)
            hsv[..., 0][hsv[..., 0] > 360] -= 360
            hsv[..., 0][hsv[..., 0] < 0] += 360
        img = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
        if mode == 0 and rnd.randint(2):
            img = img * rnd.uniform(self.contrast_lower, self.contrast_upper)
        # NB: the randint is drawn BEFORE the use_swap_channel check, like
        # the reference (transform_3d.py:216 `if random.randint(2) and
        # self.use_swap_channel`) — keeps the host RNG draw sequence
        # identical so seeded goldens match bit-for-bit
        if rnd.randint(2) and self.use_swap_channel:
            img = img[..., rnd.permutation(3)]
        return img

    def __call__(self, results):
        results["img"] = [self._distort(i.astype(np.float32))
                          for i in results["img"]]
        return results


class RandomScaleImageMultiViewImage:
    """Per-camera resize, records ``focal_ratios_x/y`` consumed by
    ``point_sampling`` (``transform_3d.py:323-377``)."""

    def __init__(self, scales=(), ref_focal_len=None, random_scale=None,
                 pad_scale_rate=None):
        self.scales = list(scales)
        assert len(self.scales) == 1
        self.ref_focal_len = ref_focal_len
        self.random_scale = random_scale
        if pad_scale_rate is None:
            pad_scale_rate = [self.scales[0]] * 2
        self.pad_scale_rate = pad_scale_rate

    def __call__(self, results):
        imgs = results["img"]
        if self.ref_focal_len is not None:
            focal_lens = results["metas"]["intrinsic"][:, 0, 0]
            ratios = [self.ref_focal_len * 1.0 / f for f in focal_lens]
            scales = [self.scales[0] * r for r in ratios]
            results["focal_ratios"] = ratios
        elif self.random_scale is not None:
            lo, hi = self.random_scale
            ratios = np.random.rand(len(imgs)) * (hi - lo) + lo
            scales = [self.scales[0] * r for r in ratios]
            results["focal_ratios"] = ratios.tolist()
        else:
            scales = self.scales * len(imgs)
        results["focal_ratios_x"] = [s / self.pad_scale_rate[1] for s in scales]
        results["focal_ratios_y"] = [s / self.pad_scale_rate[0] for s in scales]
        results["img"] = [
            cv2.resize(img, (int(img.shape[1] * s), int(img.shape[0] * s)),
                       interpolation=cv2.INTER_LINEAR)
            for img, s in zip(imgs, scales)]
        return results


def forward_aug(imgs: List[np.ndarray], metas: dict, transforms):
    """Run a transform pipeline (``dataset_wrapper_temporal.py:191-199``)."""
    results = {"img": imgs, "metas": metas}
    for t in transforms:
        results = t(results)
    return results["img"], results
