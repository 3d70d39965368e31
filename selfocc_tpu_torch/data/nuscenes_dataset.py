"""nuScenes sweep-synchronized temporal dataset — the port's copy of
``selfocc_tpu/data/nuscenes_dataset.py``.

Behavioral rewrite of ``dataset/dataset_one_frame_sweeps_dist.py`` (547 LoC):
ego-displacement neighbor lists, temporal anchor sampling, per-sensor
Gaussian-over-distance prev/next compositing, camera-matrix assembly
(lidar2img / img2lidar / temImg2lidar / img2prevImg / img2nextImg), ego-centric
rebase, lidar-projected sparse depth GT. Consumes the same
``nuscenes_infos_{train,val}_sweeps.pkl`` index files (built offline by
``examine_sweeps.py``).

Dependencies: numpy + cv2 only (quaternion math inlined). Images are decoded
by the port's native C++ decoder (``selfocc_tpu_torch/native``) when it
built, with cv2 otherwise, as in the JAX package.
"""
from __future__ import annotations

import math
import os
import pickle
import random
from copy import deepcopy
from typing import Dict, List

import cv2
import numpy as np

SENSOR_TYPES = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]


def quaternion_to_rotmat(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation (pyquaternion convention)."""
    w, x, y, z = [float(v) for v in q]
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def get_xyz(pose_dict):
    return np.asarray(pose_dict["translation"])


def get_img2global(calib_dict, pose_dict):
    """reference ``dataset_one_frame_sweeps_dist.py:18-33``."""
    cam2img = np.eye(4)
    cam2img[:3, :3] = np.asarray(calib_dict["camera_intrinsic"])
    img2cam = np.linalg.inv(cam2img)
    cam2ego = np.eye(4)
    cam2ego[:3, :3] = quaternion_to_rotmat(calib_dict["rotation"])
    cam2ego[:3, 3] = np.asarray(calib_dict["translation"]).T
    ego2global = np.eye(4)
    ego2global[:3, :3] = quaternion_to_rotmat(pose_dict["rotation"])
    ego2global[:3, 3] = np.asarray(pose_dict["translation"]).T
    return ego2global @ cam2ego @ img2cam


def get_lidar2global(calib_dict, pose_dict):
    """reference ``dataset_one_frame_sweeps_dist.py:35-46``."""
    lidar2ego = np.eye(4)
    lidar2ego[:3, :3] = quaternion_to_rotmat(calib_dict["rotation"])
    lidar2ego[:3, 3] = np.asarray(calib_dict["translation"]).T
    ego2global = np.eye(4)
    ego2global[:3, :3] = quaternion_to_rotmat(pose_dict["rotation"])
    ego2global[:3, 3] = np.asarray(pose_dict["translation"]).T
    return ego2global @ lidar2ego


class nuScenes_One_Frame_Sweeps_Dist:
    """Main nuScenes train/val dataset (reference ``:49-303``)."""

    def __init__(self, data_path, imageset, crop_size=(768, 1600),
                 input_img_crop_size=None, min_dist=0.4, max_dist=10.0,
                 strict=True, return_depth=False, eval_depth=80,
                 cur_prob=1.0, prev_prob=0.5, choose_nearest=False,
                 ref_sensor="CAM_FRONT", composite_prev_next=False,
                 sensor_mus=(3.0, 0.5), sensor_sigma=0.5, ego_centric=False,
                 occ3d_root="", openocc_root="", **kwargs):
        with open(imageset, "rb") as f:
            data = pickle.load(f)
        self.scene_infos = data["infos"]
        self.keyframes = data["metadata"]
        self.data_path = data_path
        self.crop_size = list(crop_size)
        self.input_img_crop_size = list(input_img_crop_size or crop_size)
        self.strict = strict
        self.return_depth = return_depth
        self.eval_depth = eval_depth
        self.cur_prob = cur_prob
        self.prev_prob = prev_prob
        self.choose_nearest = choose_nearest
        self.composite_prev_next = composite_prev_next
        self.sensor_mus = {
            "CAM_FRONT": sensor_mus[0], "CAM_FRONT_RIGHT": sensor_mus[1],
            "CAM_FRONT_LEFT": sensor_mus[1], "CAM_BACK": sensor_mus[0],
            "CAM_BACK_LEFT": sensor_mus[1], "CAM_BACK_RIGHT": sensor_mus[1]}
        self.sensor_sigma = sensor_sigma
        self.sensor_types = SENSOR_TYPES
        self.ego_centric = ego_centric
        # Occupancy GT roots: the reference resolves label files through the
        # nuScenes devkit at eval time (eval_iou.py:26-41) — Occ3D by scene
        # NAME (data/occ3d/gts/{scene_name}/{token}/labels.npz), OpenOccupancy
        # by scene TOKEN (scene_{scene_token}/occupancy/{lidar_sd_token}.npy).
        # The pkl stores scene_name per keyframe (examine_sweeps.py) and is
        # keyed by scene token; each resolves with its correct identifier.
        self.occ3d_root = occ3d_root
        self.openocc_root = openocc_root
        self._label_hits = {"occ3d": 0, "openocc": 0}
        self._label_miss_warned = set()
        self._build_neighbor_lists(ref_sensor, min_dist, max_dist, strict)

    def _warn_label_miss(self, kind, path):
        """Loud (once per kind) instead of the silent skip: a configured
        label root that never matches is a mis-keyed directory, not an
        absent dataset (ADVICE r2: scene-name vs scene-token mixups fail
        invisibly otherwise)."""
        if kind not in self._label_miss_warned:
            self._label_miss_warned.add(kind)
            import warnings
            warnings.warn(
                f"{kind} label root configured but no file at e.g. {path!r};"
                " if this repeats for every sample the root is mis-keyed"
                " (occ3d uses scene NAME, openocc uses scene TOKEN)")

    def _build_neighbor_lists(self, ref_sensor, min_dist, max_dist, strict):
        """Ego-displacement-windowed neighbor lists
        (reference ``:114-151``)."""
        for scene_token, scene_samples in self.scene_infos.items():
            length = len(scene_samples)
            for i, sample in enumerate(scene_samples):
                curr_xyz = get_xyz(sample["data"][ref_sensor]["pose"])
                prev_samples, prev_dists = [], []
                next_samples, next_dists = [], []
                for j in range(i - 1, -1, -1):
                    d = np.linalg.norm(curr_xyz - get_xyz(
                        scene_samples[j]["data"][ref_sensor]["pose"]))
                    if d > max_dist:
                        break
                    if d > min_dist:
                        prev_samples.append((scene_token, j))
                        prev_dists.append(d)
                for j in range(i + 1, length):
                    d = np.linalg.norm(curr_xyz - get_xyz(
                        scene_samples[j]["data"][ref_sensor]["pose"]))
                    if d > max_dist:
                        break
                    if d > min_dist:
                        next_samples.append((scene_token, j))
                        next_dists.append(d)
                if not strict:
                    prev_samples.append((scene_token, i))
                    prev_dists.append(0.0)
                    next_samples.append((scene_token, i))
                    next_dists.append(0.0)
                sample.update({
                    "prev_samples": prev_samples, "prev_dists": prev_dists,
                    "next_samples": next_samples, "next_dists": next_dists})

    def __len__(self):
        return len(self.keyframes)

    # ----------------------------------------------------------- geometry
    def get_depth_from_lidar(self, lidar_path, lidar2img, image_size):
        """Project the lidar sweep into all cameras (reference ``:158-181``)."""
        scan = np.fromfile(os.path.join(self.data_path, lidar_path),
                           dtype=np.float32).reshape(-1, 5)[:, :4]
        scan[:, 3] = 1.0
        pts = np.expand_dims(scan.T, 0)                       # 1, 4, n
        img_points = np.transpose(lidar2img @ pts, (0, 2, 1))  # N, n, 4
        depth = img_points[..., 2]
        img_points = img_points[..., :2] / np.expand_dims(depth, 2)
        img_points[..., 0] /= image_size[1]
        img_points[..., 1] /= image_size[0]
        mask = (depth < self.eval_depth) & (depth > 1.0)
        mask &= (img_points[..., 0] > 0) & (img_points[..., 1] > 0) & \
            (img_points[..., 0] < 1) & (img_points[..., 1] < 1)
        return img_points, depth, mask

    def composite_dict(self, anchor_info):
        """Per-sensor Gaussian-over-distance neighbor compositing
        (reference ``:183-197``)."""
        datas = []
        for prefix in ("prev_", "next_"):
            data = {}
            dists = np.asarray(anchor_info[prefix + "dists"])
            for sensor in self.sensor_types:
                mu, sigma = self.sensor_mus[sensor], self.sensor_sigma
                probs = np.exp(-((dists - mu) ** 2) / (2 * sigma * sigma))
                probs = probs / (math.sqrt(2 * math.pi) * sigma)
                probs = probs / probs.sum()
                idx = np.random.choice(len(dists), p=probs)
                token, sample_idx = anchor_info[prefix + "samples"][idx]
                data[sensor] = self.scene_infos[token][sample_idx]["data"][sensor]
            datas.append(data)
        return {"data": datas[0]}, {"data": datas[1]}

    def get_data_info(self, info):
        """Current-frame matrices (reference ``:358-403``)."""
        lidar_calib = info["data"]["LIDAR_TOP"]["calib"]
        lidar2ego = np.eye(4)
        lidar2ego[:3, :3] = quaternion_to_rotmat(lidar_calib["rotation"])
        lidar2ego[:3, 3] = np.asarray(lidar_calib["translation"]).T
        ego2lidar = np.linalg.inv(lidar2ego)
        lidar2global = get_lidar2global(
            lidar_calib, info["data"]["LIDAR_TOP"]["pose"])

        paths, l2i, i2l, intr, c2e = [], [], [], [], []
        for cam in self.sensor_types:
            d = info["data"][cam]
            paths.append(os.path.join(self.data_path, d["filename"]))
            img2global = get_img2global(d["calib"], d["pose"])
            l2i.append(np.linalg.inv(img2global) @ lidar2global)
            i2l.append(np.linalg.inv(lidar2global) @ img2global)
            cam2ego = np.eye(4)
            cam2ego[:3, :3] = quaternion_to_rotmat(d["calib"]["rotation"])
            cam2ego[:3, 3] = np.asarray(d["calib"]["translation"]).T
            c2e.append(cam2ego)
            viewpad = np.eye(4)
            viewpad[:3, :3] = d["calib"]["camera_intrinsic"]
            intr.append(viewpad)
        return dict(img_filename=paths, lidar2img=np.asarray(l2i),
                    img2lidar=np.asarray(i2l), cam_intrinsic=np.asarray(intr),
                    ego2lidar=ego2lidar, cam2ego=np.asarray(c2e))

    def get_data_info_anchor(self, info, info_tem):
        """Anchor-frame img->lidar matrices (reference ``:337-356``)."""
        lidar2global = get_lidar2global(
            info["data"]["LIDAR_TOP"]["calib"],
            info["data"]["LIDAR_TOP"]["pose"])
        paths, mats = [], []
        for cam in self.sensor_types:
            d = info_tem["data"][cam]
            paths.append(os.path.join(self.data_path, d["filename"]))
            temImg2global = get_img2global(d["calib"], d["pose"])
            mats.append(np.linalg.inv(lidar2global) @ temImg2global)
        return dict(image_paths=paths, temImg2lidar=np.asarray(mats))

    def get_data_info_temporal(self, info, info_tem):
        """Anchor->neighbor reprojection matrices (reference ``:316-335``)."""
        paths, mats = [], []
        for cam in self.sensor_types:
            dt, d = info_tem["data"][cam], info["data"][cam]
            paths.append(os.path.join(self.data_path, dt["filename"]))
            temImg2global = get_img2global(dt["calib"], dt["pose"])
            img2global = get_img2global(d["calib"], d["pose"])
            mats.append(np.linalg.inv(temImg2global) @ img2global)
        return dict(image_paths=paths, img2temImg=np.asarray(mats))

    def read_surround_imgs(self, paths, crop_size):
        # batched decode on the native C++ thread pool when built
        # (selfocc_tpu_torch/native/loader.cpp); cv2 fallback otherwise
        from ..native import get_shared_loader
        loader = get_shared_loader()
        if loader is not None:
            return list(loader.decode_batch(
                paths, crop_hw=(crop_size[0], crop_size[1])))
        imgs = []
        for p in paths:
            img = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32)
            imgs.append(img[:crop_size[0], :crop_size[1], :])
        return imgs

    # ----------------------------------------------------------- sampling
    def __getitem__(self, index):
        if random.random() < self.cur_prob:
            temporal_supervision = "curr"
        elif random.random() < self.prev_prob:
            temporal_supervision = "prev"
        else:
            temporal_supervision = "next"

        while True:
            scene_token, idx = self.keyframes[index]
            info = deepcopy(self.scene_infos[scene_token][idx])
            if temporal_supervision == "curr":
                anchor_info = deepcopy(info)
            elif temporal_supervision == "prev":
                if not info["prev_samples"]:
                    index = np.random.randint(len(self))
                    continue
                _, aid = info["prev_samples"][
                    np.random.randint(len(info["prev_samples"]))]
                anchor_info = deepcopy(self.scene_infos[scene_token][aid])
            else:
                if not info["next_samples"]:
                    index = np.random.randint(len(self))
                    continue
                _, aid = info["next_samples"][
                    np.random.randint(len(info["next_samples"]))]
                anchor_info = deepcopy(self.scene_infos[scene_token][aid])

            if not anchor_info["prev_samples"] or not anchor_info["next_samples"]:
                index = np.random.randint(len(self))
                continue

            if self.composite_prev_next:
                anchor_prev, anchor_next = self.composite_dict(anchor_info)
            else:
                if self.choose_nearest:
                    _, pi = anchor_info["prev_samples"][0]
                    _, ni = anchor_info["next_samples"][0]
                else:
                    _, pi = anchor_info["prev_samples"][
                        np.random.randint(len(anchor_info["prev_samples"]))]
                    _, ni = anchor_info["next_samples"][
                        np.random.randint(len(anchor_info["next_samples"]))]
                anchor_prev = deepcopy(self.scene_infos[scene_token][pi])
                anchor_next = deepcopy(self.scene_infos[scene_token][ni])
            break

        imgs_info = self.get_data_info(info)
        anchor_dict = self.get_data_info_anchor(info, anchor_info)
        prev_dict = self.get_data_info_temporal(anchor_info, anchor_prev)
        next_dict = self.get_data_info_temporal(anchor_info, anchor_next)

        img_metas = {
            "input_imgs_path": imgs_info["img_filename"],
            "curr_imgs_path": anchor_dict["image_paths"],
            "prev_imgs_path": prev_dict["image_paths"],
            "next_imgs_path": next_dict["image_paths"],
            "lidar2img": imgs_info["lidar2img"],
            "img2lidar": imgs_info["img2lidar"],
            "intrinsic": imgs_info["cam_intrinsic"],
            "cam2ego": imgs_info["cam2ego"],
            "temImg2lidar": anchor_dict["temImg2lidar"],
            "ego2lidar": imgs_info["ego2lidar"],
            "token": info["token"],
            "timestamp": info["timestamp"],
            "img2prevImg": prev_dict["img2temImg"],
            "img2nextImg": next_dict["img2temImg"]}

        if self.occ3d_root:
            # Occ3D is laid out by scene NAME (reference eval_iou.py:26-32)
            scene_name = info.get("scene_name", str(scene_token))
            p = os.path.join(self.occ3d_root, scene_name,
                             str(info["token"]), "labels.npz")
            if os.path.exists(p):
                img_metas["occ3d_label_path"] = p
                self._label_hits["occ3d"] += 1
            else:
                self._warn_label_miss("occ3d", p)
        if self.openocc_root:
            # OpenOccupancy is laid out by scene TOKEN + LIDAR_TOP
            # sample_data token (reference eval_iou.py:34-39)
            lidar_token = info["data"]["LIDAR_TOP"].get("token", "")
            p = os.path.join(self.openocc_root, f"scene_{scene_token}",
                             "occupancy", f"{lidar_token}.npy")
            if os.path.exists(p):
                img_metas["openocc_label_path"] = p
                self._label_hits["openocc"] += 1
            else:
                self._warn_label_miss("openocc", p)

        if self.return_depth:
            loc, gt, mask = self.get_depth_from_lidar(
                info["data"]["LIDAR_TOP"]["filename"],
                img_metas["lidar2img"], self.crop_size)
            img_metas.update({"depth_loc": loc, "depth_gt": gt,
                              "depth_mask": mask})

        if self.ego_centric:
            # rebase all matrices into the ego frame (reference :283-293)
            ego2lidar = img_metas["ego2lidar"]
            lidar2ego = np.linalg.inv(ego2lidar)
            img_metas.update({
                "lidar2img": img_metas["lidar2img"] @ ego2lidar[None],
                "img2lidar": lidar2ego[None] @ img_metas["img2lidar"],
                "temImg2lidar": lidar2ego[None] @ img_metas["temImg2lidar"],
                "ego2lidar": np.eye(4)})

        input_imgs = self.read_surround_imgs(
            img_metas["input_imgs_path"], self.input_img_crop_size)
        curr_imgs = self.read_surround_imgs(
            img_metas["curr_imgs_path"], self.crop_size)
        prev_imgs = self.read_surround_imgs(
            img_metas["prev_imgs_path"], self.crop_size)
        next_imgs = self.read_surround_imgs(
            img_metas["next_imgs_path"], self.crop_size)
        return ([input_imgs, curr_imgs, prev_imgs, next_imgs], img_metas)
