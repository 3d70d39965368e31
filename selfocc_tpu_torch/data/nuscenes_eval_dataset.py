"""nuScenes novel-view evaluation dataset — the port's copy of
``selfocc_tpu/data/nuscenes_eval_dataset.py``.

Behavioral rewrite of ``dataset/dataset_one_frame_eval.py`` (249 LoC): for
each keyframe, returns the input surround images + per-temporal-neighbor
``temImg2lidars`` and lidar depth GT (projected into the *current* cameras),
with neighbor ego-displacement distances for the per-distance error buckets of
``eval_novel_depth.py``. Consumes the ``*_temporal_v1``-style infos pkl with
``nice_neighbor_prev/next`` neighbor lists.
"""
from __future__ import annotations

import pickle
from copy import deepcopy

import cv2
import numpy as np

from .nuscenes_dataset import quaternion_to_rotmat


class nuScenes_One_Frame_Eval:

    def __init__(self, data_path, imageset, crop_size=(768, 1600),
                 cam_types=None, eval_depth=80, scene_name=None, **kwargs):
        with open(imageset, "rb") as f:
            data = pickle.load(f)
        self.nusc_infos = data["infos"]
        if scene_name is not None:
            lo, hi = data["scene_info"][scene_name]
            self.selected_indices = list(range(lo, hi + 1))
        else:
            self.selected_indices = list(range(len(self.nusc_infos)))
        self.data_path = data_path
        self.crop_size = list(crop_size)
        self.eval_depth = eval_depth

    def __len__(self):
        return len(self.selected_indices)

    def get_depth_from_lidar(self, lidar_path, lidar2img, image_size):
        scan = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 5)[:, :4]
        scan[:, 3] = 1.0
        pts = np.expand_dims(scan.T, 0)
        img_points = np.transpose(lidar2img @ pts, (0, 2, 1))
        depth = img_points[..., 2]
        img_points = img_points[..., :2] / np.expand_dims(depth, 2)
        img_points[..., 0] /= image_size[1]
        img_points[..., 1] /= image_size[0]
        mask = (depth < self.eval_depth) & (depth > 1e-3)
        mask &= (img_points[..., 0] > 0) & (img_points[..., 1] > 0) & \
            (img_points[..., 0] < 1) & (img_points[..., 1] < 1)
        return img_points, depth, mask

    def get_data_info(self, info):
        """reference ``dataset_one_frame_eval.py:211-249`` (mmdet3d-style
        infos with sensor2lidar rotations)."""
        lidar2ego = np.eye(4)
        lidar2ego[:3, :3] = quaternion_to_rotmat(info["lidar2ego_rotation"])
        lidar2ego[:3, 3] = np.asarray(info["lidar2ego_translation"]).T
        ego2lidar = np.linalg.inv(lidar2ego)

        paths, l2i, i2l, intr, c2e = [], [], [], [], []
        for cam_info in info["cams"].values():
            paths.append(cam_info["data_path"])
            # cam2ego for CameraAwareSE conditioning (camera_kwargs)
            s2e = np.eye(4)
            s2e[:3, :3] = quaternion_to_rotmat(
                cam_info["sensor2ego_rotation"])
            s2e[:3, 3] = np.asarray(cam_info["sensor2ego_translation"]).T
            c2e.append(s2e)
            lidar2cam_r = np.linalg.inv(cam_info["sensor2lidar_rotation"])
            lidar2cam_t = cam_info["sensor2lidar_translation"] @ lidar2cam_r.T
            rt = np.eye(4)
            rt[:3, :3] = lidar2cam_r.T
            rt[3, :3] = -lidar2cam_t
            viewpad = np.eye(4)
            K = cam_info["cam_intrinsic"]
            viewpad[:K.shape[0], :K.shape[1]] = K
            mat = viewpad @ rt.T
            l2i.append(mat)
            i2l.append(np.linalg.inv(mat))
            intr.append(viewpad)
        return dict(img_filename=paths, lidar2img=np.asarray(l2i),
                    img2lidar=np.asarray(i2l), cam_intrinsic=np.asarray(intr),
                    cam2ego=np.asarray(c2e), ego2lidar=ego2lidar)

    def get_data_info_temporal(self, info, info_tem):
        """reference ``:163-209``."""
        lidar2ego = np.eye(4)
        lidar2ego[:3, :3] = quaternion_to_rotmat(info["lidar2ego_rotation"])
        lidar2ego[:3, 3] = np.asarray(info["lidar2ego_translation"]).T
        ego2global = np.eye(4)
        ego2global[:3, :3] = quaternion_to_rotmat(info["ego2global_rotation"])
        ego2global[:3, 3] = np.asarray(info["ego2global_translation"]).T
        global2lidar = np.linalg.inv(ego2global @ lidar2ego)

        paths, mats = [], []
        for cam in info_tem["cams"].values():
            paths.append(cam["data_path"])
            temImg2temSensor = np.eye(4)
            temImg2temSensor[:3, :3] = cam["cam_intrinsic"]
            temImg2temSensor = np.linalg.inv(temImg2temSensor)
            s2e = np.eye(4)
            s2e[:3, :3] = quaternion_to_rotmat(cam["sensor2ego_rotation"])
            s2e[:3, 3] = np.asarray(cam["sensor2ego_translation"]).T
            e2g = np.eye(4)
            e2g[:3, :3] = quaternion_to_rotmat(cam["ego2global_rotation"])
            e2g[:3, 3] = np.asarray(cam["ego2global_translation"]).T
            mats.append(global2lidar @ e2g @ s2e @ temImg2temSensor)
        return dict(image_paths=paths, temImg2lidar=np.asarray(mats))

    def read_surround_imgs(self, paths):
        imgs = []
        for p in paths:
            img = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32)
            imgs.append(img[:self.crop_size[0], :self.crop_size[1], :])
        return imgs

    def __getitem__(self, index):
        while True:
            idx = self.selected_indices[index]
            info = deepcopy(self.nusc_infos[idx])
            if not info["nice_neighbor_prev"] and not info["nice_neighbor_next"]:
                index = np.random.randint(len(self))
                continue
            break

        imgs_info = self.get_data_info(info)
        img_metas = {
            "input_imgs_path": imgs_info["img_filename"],
            "lidar2img": imgs_info["lidar2img"],
            "img2lidar": imgs_info["img2lidar"],
            "ego2lidar": imgs_info["ego2lidar"],
            "token": info["token"], "timestamp": info["timestamp"],
            "intrinsic": imgs_info["cam_intrinsic"],
            "cam2ego": imgs_info["cam2ego"]}

        anchor_imgs, locs, gts, masks, temImg2lidars = [], [], [], [], []
        frame_dists = list(info["prev_dists"]) + list(info["next_dists"])
        for anchor in info["nice_neighbor_prev"] + info["nice_neighbor_next"]:
            anchor_info = deepcopy(self.nusc_infos[anchor])
            a = self.get_data_info_temporal(info, anchor_info)
            anchor_imgs.append(self.read_surround_imgs(a["image_paths"]))
            loc, gt, mask = self.get_depth_from_lidar(
                anchor_info["lidar_path"], img_metas["lidar2img"],
                self.crop_size)
            locs.append(loc)
            gts.append(gt)
            masks.append(mask)
            temImg2lidars.append(a["temImg2lidar"])

        img_metas.update({
            "depth_loc": locs, "depth_gt": gts, "depth_mask": masks,
            "temImg2lidars": temImg2lidars, "frame_dists": frame_dists})
        input_imgs = self.read_surround_imgs(img_metas["input_imgs_path"])
        return (input_imgs, anchor_imgs, img_metas)
