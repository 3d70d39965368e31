"""Dataset wrapper: augmentation pipeline + canonical array batch assembly —
the port's copy of ``selfocc_tpu/data/wrapper.py``.

Behavioral rewrite of ``dataset/dataset_wrapper_temporal.py``: PhotoMetric ->
Normalize(ImageNet) -> RandomScale -> Pad(div 32) [+ RandomFlip] on the input
images; supervision images divided by 256 (reference ``:166-170``); instead of
the reference's 9-tuple + dict-metas collate, the output is one flat dict of
numpy arrays (the canonical batch layout, NHWC, bs=1 leading), with the
offline teacher maps (``sem_from``) as ``sem_gt`` where they exist.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Dict, Optional

import numpy as np

from .transforms import (IMG_NORM, NormalizeMultiviewImage, PadMultiViewImage,
                         PhotoMetricDistortionMultiViewImage, RandomFlip,
                         RandomScaleImageMultiViewImage, forward_aug)


def _resize_align_corners(img: np.ndarray, size_hw) -> np.ndarray:
    """Bilinear HWC resize with torch ``align_corners=True`` semantics
    (src = dst * (in-1)/(out-1)), matching the reference's supervision-image
    ``F.interpolate`` (dataset_wrapper_temporal.py:152-154)."""
    h, w = img.shape[:2]
    th, tw = size_hw
    ys = (np.arange(th, dtype=np.float64) * ((h - 1) / (th - 1))
          if th > 1 else np.zeros(th))
    xs = (np.arange(tw, dtype=np.float64) * ((w - 1) / (tw - 1))
          if tw > 1 else np.zeros(tw))
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    fy = (ys - y0).astype(np.float32)[:, None, None]
    fx = (xs - x0).astype(np.float32)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


class TemporalDatasetWrapper:
    """Wraps a raw dataset emitting ``([input, curr, prev, next] imgs, metas)``
    into canonical batches."""

    def __init__(self, in_dataset, phase="train", scale_rate=1.0,
                 photometric_aug=None, img_norm_cfg=None, use_flip=False,
                 ref_focal_len=None, pad_img_size=None, random_scale=None,
                 pad_scale_rate=None, sem_from=None, sem_apply_lut=False,
                 supervision_img_size=None):
        self.dataset = in_dataset
        self.scale_rate = scale_rate
        norm = img_norm_cfg or IMG_NORM
        photometric = PhotoMetricDistortionMultiViewImage(
            **(photometric_aug or {}))
        train_t = [photometric, NormalizeMultiviewImage(**norm),
                   PadMultiViewImage(size_divisor=32, size=pad_img_size)]
        val_t = [NormalizeMultiviewImage(**norm),
                 PadMultiViewImage(size_divisor=32, size=pad_img_size)]
        if scale_rate != 1 or ref_focal_len is not None or \
                random_scale is not None or pad_scale_rate is not None:
            train_t.insert(2, RandomScaleImageMultiViewImage(
                [scale_rate], ref_focal_len, random_scale, pad_scale_rate))
            val_t.insert(1, RandomScaleImageMultiViewImage(
                [scale_rate], ref_focal_len, pad_scale_rate=pad_scale_rate))
        if use_flip:
            train_t.append(RandomFlip(0.5))
        self.transforms = train_t if phase == "train" else val_t
        # optional precomputed OpenSeeD teacher maps (offline analog of the
        # reference's on-line OpenSeeD forward, train.py:213-215); with
        # sem_apply_lut the maps are remapped to nuScenes classes at load
        # (sem_space="nuscenes"), otherwise kept in OpenSeeD space.
        self.sem_teacher = None
        if sem_from:
            from ..utils.openseed_utils import SemTeacher
            self.sem_teacher = SemTeacher(sem_from, apply_lut=sem_apply_lut)
        # optional bilinear resize of the supervision images (reference
        # dataset_wrapper_temporal.py:151-154, align_corners interpolate)
        self.supervision_img_size = supervision_img_size

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        imgs, metas = self.dataset[index]
        input_imgs, curr_imgs, prev_imgs, next_imgs = imgs
        color_imgs = deepcopy(curr_imgs)

        input_imgs, aug = forward_aug(input_imgs, metas, self.transforms)

        def stack(ims):
            return np.stack(ims).astype(np.float32)[None]  # 1, N, H, W, 3

        def stack_sup(ims):
            # supervision images optionally resized with ALIGN_CORNERS
            # bilinear (reference dataset_wrapper_temporal.py:151-154 uses
            # F.interpolate(align_corners=True), which is NOT cv2.resize's
            # half-pixel convention)
            if self.supervision_img_size is not None:
                ims = [_resize_align_corners(im, self.supervision_img_size)
                       for im in ims]
            return stack(ims)

        batch = {
            "imgs": stack(input_imgs),
            "curr_imgs": stack_sup(curr_imgs) / 256.0,
            "prev_imgs": stack_sup(prev_imgs) / 256.0,
            "next_imgs": stack_sup(next_imgs) / 256.0,
            # color_imgs are NOT resized (reference interpolates only
            # curr/prev/next, dataset_wrapper_temporal.py:151-154)
            "color_imgs": stack(color_imgs) / 256.0,
            "lidar2img": metas["lidar2img"][None].astype(np.float32),
            "img2lidar": metas["img2lidar"][None].astype(np.float32),
            "temImg2lidar": metas["temImg2lidar"][None].astype(np.float32),
            "img2prevImg": metas["img2prevImg"][None].astype(np.float32),
            "img2nextImg": metas["img2nextImg"][None].astype(np.float32),
            "ego2lidar": metas["ego2lidar"][None].astype(np.float32),
            "flip": np.asarray(aug.get("flip", False)),
        }
        # camera parameters for CameraAwareSE (reference camera_se_net.py
        # consumes metas['intrinsic']/['cam2ego'])
        if "intrinsic" in metas:
            batch["intrinsic"] = np.asarray(metas["intrinsic"],
                                            np.float32)[None]
        if "cam2ego" in metas:
            batch["cam2ego"] = np.asarray(metas["cam2ego"], np.float32)[None]
        if "focal_ratios_x" in aug:
            batch["focal_ratios_x"] = np.asarray(aug["focal_ratios_x"],
                                                 np.float32)
            batch["focal_ratios_y"] = np.asarray(aug["focal_ratios_y"],
                                                 np.float32)
        if "depth_loc" in metas:
            batch["depth_loc"] = metas["depth_loc"].astype(np.float32)
            batch["depth_gt"] = metas["depth_gt"].astype(np.float32)
            batch["depth_mask"] = metas["depth_mask"]
        if "sem" in metas:
            batch["sem_gt"] = np.asarray(metas["sem"])[None]
        elif self.sem_teacher is not None and "curr_imgs_path" in metas:
            maps = self.sem_teacher.load_batch(metas["curr_imgs_path"])
            if maps is not None:
                batch["sem_gt"] = maps[None]
        # occupancy GT label paths + sample identifiers (strings, host-side
        # eval only; "sequence" is what eval_iou_kitti resolves the
        # SemanticKITTI voxel label path with)
        for k in ("occ3d_label_path", "openocc_label_path", "token",
                  "sequence"):
            if k in metas:
                batch[k] = metas[k]
        return batch
