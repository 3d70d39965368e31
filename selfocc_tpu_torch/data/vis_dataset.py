"""Scene-walk visualization dataset + wrapper — the port's copy of
``selfocc_tpu/data/vis_dataset.py``.

Behavioral rewrite of ``dataset/dataset_one_frame_sweeps_dist_vis.py:43-170``
and ``dataset/dataset_wrapper_vis.py`` (SURVEY §2.8 ``*_vis`` variants): walks
ONE scene's keyframes in order (no temporal neighbor sampling, no
supervision frames), returning per frame the network input batch plus the
raw surround images and camera/focal positions the 3D visualizers need for
camera placement (reference ``vis_3d.py`` mayavi view setup). The
wrapper's items stay on the host: numpy arrays, as the JAX wrapper's
(the port's ``prep_input_imgs`` gives a CPU tensor, taken as an array).
"""
from __future__ import annotations

import os
import pickle
from copy import deepcopy
from typing import Dict, Optional

import numpy as np

from .nuscenes_dataset import (SENSOR_TYPES, get_img2global, get_lidar2global,
                               quaternion_to_rotmat)

# focal-point offset along the optical axis used for the vis camera pose
# (reference dataset_one_frame_sweeps_dist_vis.py:118 ``f = 0.0055``)
FOCAL_F = 0.0055


class nuScenes_Scene_Vis:
    """All keyframes of one scene, in order (reference
    ``nuScenes_One_Frame_Sweeps_Dist_Vis``)."""

    def __init__(self, data_path, imageset, scene_token=None,
                 crop_size=(768, 1600), ego_centric=False, num_cams=None,
                 **kwargs):
        # num_cams limits the camera rig (reference always uses all 6; the
        # subset supports reduced-rig configs/tests)
        self.sensor_types = SENSOR_TYPES[:num_cams] if num_cams \
            else SENSOR_TYPES
        with open(imageset, "rb") as f:
            data = pickle.load(f)
        self.scene_infos = data["infos"]
        if scene_token is None:
            scene_token = sorted(self.scene_infos)[0]
        assert scene_token in self.scene_infos, \
            f"scene {scene_token!r} not in pkl ({sorted(self.scene_infos)[:3]}...)"
        self.infos = self.scene_infos[scene_token]
        self.scene_token = scene_token
        self.data_path = data_path
        self.crop_size = tuple(crop_size)
        self.ego_centric = ego_centric

    def __len__(self):
        return len(self.infos)

    def _get_data_info(self, info):
        """Matrix assembly (reference ``:117-170``): per camera lidar2img /
        img2lidar via the global chain, plus cam/focal positions in the lidar
        frame for the visualizer's camera path."""
        image_paths, l2i, i2l, intr, c2e = [], [], [], [], []
        cam_positions, focal_positions = [], []
        lidar_calib = info["data"]["LIDAR_TOP"]["calib"]
        lidar2ego = np.eye(4)
        lidar2ego[:3, :3] = quaternion_to_rotmat(lidar_calib["rotation"])
        lidar2ego[:3, 3] = np.asarray(lidar_calib["translation"]).T
        ego2lidar = np.linalg.inv(lidar2ego)
        lidar2global = get_lidar2global(lidar_calib,
                                        info["data"]["LIDAR_TOP"]["pose"])
        for cam in self.sensor_types:
            d = info["data"][cam]
            image_paths.append(os.path.join(self.data_path, d["filename"]))
            img2global = get_img2global(d["calib"], d["pose"])
            lidar2img = np.linalg.inv(img2global) @ lidar2global
            img2lidar = np.linalg.inv(lidar2global) @ img2global
            cam2ego = np.eye(4)
            cam2ego[:3, :3] = quaternion_to_rotmat(d["calib"]["rotation"])
            cam2ego[:3, 3] = np.asarray(d["calib"]["translation"]).T
            viewpad = np.eye(4)
            viewpad[:3, :3] = np.asarray(d["calib"]["camera_intrinsic"])
            cam_positions.append(
                (img2lidar @ viewpad @ np.array([0., 0., 0., 1.]))[:3])
            focal_positions.append(
                (img2lidar @ viewpad @ np.array([0., 0., FOCAL_F, 1.]))[:3])
            l2i.append(lidar2img)
            i2l.append(img2lidar)
            intr.append(viewpad)
            c2e.append(cam2ego)
        return dict(
            img_filename=image_paths, lidar2img=np.asarray(l2i),
            img2lidar=np.asarray(i2l), cam_intrinsic=np.asarray(intr),
            ego2lidar=ego2lidar, cam2ego=np.asarray(c2e),
            lidar2global=lidar2global,
            cam_positions=np.asarray(cam_positions),
            focal_positions=np.asarray(focal_positions))

    def __getitem__(self, index):
        info = deepcopy(self.infos[index])
        ii = self._get_data_info(info)
        metas = {
            "input_imgs_path": ii["img_filename"],
            "lidar2img": ii["lidar2img"], "img2lidar": ii["img2lidar"],
            "intrinsic": ii["cam_intrinsic"], "cam2ego": ii["cam2ego"],
            "ego2lidar": ii["ego2lidar"], "lidar2global": ii["lidar2global"],
            "timestamp": info.get("timestamp"), "token": info.get("token"),
            "cam_positions": ii["cam_positions"],
            "focal_positions": ii["focal_positions"],
        }
        if self.ego_centric:
            ego2lidar = metas["ego2lidar"]
            lidar2ego = np.linalg.inv(ego2lidar)
            metas["lidar2img"] = metas["lidar2img"] @ ego2lidar[None]
            metas["img2lidar"] = lidar2ego[None] @ metas["img2lidar"]
        imgs = self._read_imgs(metas["input_imgs_path"])
        return imgs, metas

    def _read_imgs(self, paths):
        import cv2
        imgs = []
        for p in paths:
            im = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            if im is None:
                raise FileNotFoundError(p)
            imgs.append(im[:self.crop_size[0], :self.crop_size[1]]
                        .astype(np.float32))
        return imgs


class VisDatasetWrapper:
    """Vis analog of :class:`TemporalDatasetWrapper` (reference
    ``dataset_wrapper_vis.py``): val-pipeline the inputs for the network and
    keep the RAW images + metas for drawing/video tiling."""

    def __init__(self, in_dataset, cfg):
        self.dataset = in_dataset
        self.cfg = cfg

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index) -> Dict:
        from ..utils.eval_lib import prep_input_imgs
        imgs, metas = self.dataset[index]
        batch = {
            "imgs": np.asarray(prep_input_imgs(imgs, self.cfg)),
            "raw_imgs": np.stack(imgs),
            "lidar2img": metas["lidar2img"][None].astype(np.float32),
            "img2lidar": metas["img2lidar"][None].astype(np.float32),
            "temImg2lidar": metas["img2lidar"][None].astype(np.float32),
            "ego2lidar": metas["ego2lidar"][None].astype(np.float32),
            "lidar2global": metas["lidar2global"][None].astype(np.float32),
            "intrinsic": metas["intrinsic"][None].astype(np.float32),
            "cam2ego": metas["cam2ego"][None].astype(np.float32),
            "cam_positions": metas["cam_positions"].astype(np.float32),
            "focal_positions": metas["focal_positions"].astype(np.float32),
        }
        if metas.get("token") is not None:
            batch["token"] = metas["token"]
        return batch
