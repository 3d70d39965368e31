"""KITTI-raw monocular/stereo temporal dataset (eigen splits, ORB-SLAM poses)
— the port's copy of ``selfocc_tpu/data/kitti_raw_dataset.py``; images are
decoded by the port's native C++ decoder (``selfocc_tpu_torch/native``) when
it built, with cv2 otherwise, as in the JAX package.

Behavioral rewrite of ``dataset/kitti_raw/kitti_raw_dataset_stereo.py``
(625 LoC; ``Kitti_Raw`` is its monocular subset): per-day cam/velo calib
parsing, per-sequence pose files, metric-distance neighbor walks over raw
frame indices, stereo-pair substitution of the prev/next supervision
(``target_sign`` 'ps'/'ns', reference ``:563-584``), eigen-crop lidar depth.
"""
from __future__ import annotations

import os
import random
from copy import deepcopy
from pathlib import Path

import cv2
import numpy as np

from .kitti_dataset import TRANSXY

BASE_SIZES = {
    "2011_09_26": (375, 1242),
    "2011_09_28": (370, 1224),
    "2011_09_29": (374, 1238),
    "2011_09_30": (370, 1226),
    "2011_10_03": (376, 1241),
}
# eigen evaluation crop (reference :356-360)
EIGEN_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)


def load_raw_calibs(data_path):
    """Per-day calib (reference ``:249-305``)."""
    calibs = {}
    for day in BASE_SIZES:
        day_dir = Path(data_path) / day
        if not day_dir.is_dir():
            continue

        def parse(path):
            out = {}
            with open(path) as f:
                for line in f:
                    key, value = line.split(":", 1)
                    try:
                        out[key] = np.array(
                            [float(x) for x in value.split()], np.float32)
                    except ValueError:
                        pass
            return out

        cam = parse(day_dir / "calib_cam_to_cam.txt")
        velo = parse(day_dir / "calib_velo_to_cam.txt")
        P_l = np.vstack([cam["P_rect_02"].reshape(3, 4), [0, 0, 0, 1.0]])
        P_r = np.vstack([cam["P_rect_03"].reshape(3, 4), [0, 0, 0, 1.0]])
        R_rect = np.eye(4, dtype=np.float32)
        R_rect[:3, :3] = cam["R_rect_00"].reshape(3, 3)
        T_v2c = np.vstack([np.hstack([velo["R"].reshape(3, 3),
                                      velo["T"][:, None]]), [0, 0, 0, 1.0]])
        P_v2c0 = R_rect @ T_v2c
        T02 = np.eye(4)
        T02[0, 3] = P_l[0, 3] / P_l[0, 0]
        T03 = np.eye(4)
        T03[0, 3] = P_r[0, 3] / P_r[0, 0]
        calibs[day] = {
            "P_v2c0": P_v2c0, "P_v2cl": P_l @ P_v2c0, "P_v2cr": P_r @ P_v2c0,
            "T_cam0_2_cam2": T02, "T_cam0_2_cam3": T03,
            "P_2": P_l[:3, :3], "P_3": P_r[:3, :3]}
    return calibs


class Kitti_Raw_Stereo:
    """reference ``kitti_raw_dataset_stereo.py:20-604``."""

    def __init__(self, root="data/kitti_raw", pose_path="", split_path="",
                 frames_interval=0.4, sequence_distance=10, eval_depth=80,
                 eigen_depth=True, cur_prob=1.0, crop_size=(370, 1220),
                 strict=True, return_depth=False, prev_prob=0.5,
                 choose_nearest=False, include_stereo=True, data_path=None,
                 imageset=None, **kwargs):
        self.root = data_path or root
        self.eval_depth = eval_depth
        self.eigen_depth = eigen_depth
        assert cur_prob == 1.0, "reference supports curr supervision only"
        self.cur_prob = cur_prob
        self.prev_prob = prev_prob
        self.return_depth = return_depth
        self.choose_nearest = choose_nearest
        self.include_stereo = include_stereo
        self.strict = strict
        self.img_H, self.img_W = crop_size[0], crop_size[1]
        self.transxy = TRANSXY

        self._sequences = self._get_sequences(self.root)
        self._calibs = load_raw_calibs(self.root)
        self._poses = self._load_poses(pose_path, self._sequences)
        self._datapoints = self._load_split(split_path) if split_path else None
        self.scans = []
        self.frame2scan = {}
        self._index(frames_interval, sequence_distance)
        if self._datapoints is None:
            self._datapoints = [
                (s["sequence"][0], s["sequence"][1], s["frame_id"],
                 s["is_right"]) for s in self.scans]
        self.length = len(self._datapoints)

    @staticmethod
    def _get_sequences(data_path):
        seqs = []
        for day in sorted(Path(data_path).iterdir()):
            if not day.is_dir() or day.name not in BASE_SIZES:
                continue
            for seq in sorted(day.iterdir()):
                if seq.is_dir():
                    n = len(list((seq / "image_02" / "data").iterdir()))
                    seqs.append((day.name, seq.name, n))
        return seqs

    @staticmethod
    def _load_split(split_path):
        with open(split_path) as f:
            lines = f.readlines()

        def parse(l):
            seg = l.split(" ")
            day, seq = seg[0].split("/")
            return day, seq, int(seg[1]), seg[2].strip() == "r"
        return [parse(l) for l in lines]

    @staticmethod
    def _load_poses(pose_path, sequences):
        poses = {}
        for day, seq, _ in sequences:
            path = Path(pose_path) / day / f"{seq}.txt"
            seq_poses = []
            try:
                with open(path) as f:
                    for line in f:
                        T = np.fromstring(line, dtype=float, sep=" ")
                        seq_poses.append(
                            np.vstack([T.reshape(3, 4), [0, 0, 0, 1]]))
            except FileNotFoundError:
                pass
            poses[(day, seq)] = np.array(seq_poses, np.float32)
        return poses

    def _index(self, frames_interval, sequence_distance):
        for day, seq, length in self._sequences:
            if len(self._poses[(day, seq)]) == 0:
                continue
            for frame_id in range(length):
                for is_right in (False, True):
                    folder = "image_03" if is_right else "image_02"
                    img = os.path.join(self.root, day, seq, folder, "data",
                                       f"{frame_id:010d}.png")
                    lid = os.path.join(self.root, day, seq, "velodyne_points",
                                       "data", f"{frame_id:010d}.bin")
                    pose = self._poses[(day, seq)][frame_id]
                    xyz = pose[:3, 3]
                    calib = self._calibs[day]
                    P = calib["P_3"] if is_right else calib["P_2"]
                    T02 = calib["T_cam0_2_cam3"] if is_right else \
                        calib["T_cam0_2_cam2"]
                    T03 = calib["T_cam0_2_cam2"] if is_right else \
                        calib["T_cam0_2_cam3"]
                    Tvi = calib["P_v2cr"] if is_right else calib["P_v2cl"]

                    def walk(step):
                        ids, imgs, lids, ps, ds = [], [], [], [], []
                        cnt = 0
                        while True:
                            cnt += step
                            rid = frame_id + cnt
                            p = os.path.join(self.root, day, seq, folder,
                                             "data", f"{rid:010d}.png")
                            if rid < 0 or not os.path.exists(p):
                                break
                            tp = self._poses[(day, seq)][rid]
                            dist = float(np.linalg.norm(tp[:3, 3] - xyz))
                            if dist < frames_interval:
                                continue
                            if dist > sequence_distance:
                                break
                            ids.append(rid)
                            imgs.append(p)
                            lids.append(os.path.join(
                                self.root, day, seq, "velodyne_points",
                                "data", f"{rid:010d}.bin"))
                            ps.append(tp)
                            ds.append(dist)
                        return ids, imgs, lids, ps, ds

                    prev = walk(-1)
                    nxt = walk(1)
                    sign = "r" if is_right else "l"
                    self.frame2scan[f"{day}/{seq}_{frame_id}_{sign}"] = \
                        len(self.scans)
                    scan = {
                        "frame_id": frame_id, "sequence": (day, seq),
                        "img_path": img, "lid_path": lid, "pose": pose,
                        "is_right": is_right,
                        "prev_frame_ids": prev[0], "prev_img_paths": prev[1],
                        "prev_lid_paths": prev[2], "prev_poses": prev[3],
                        "prev_dists": prev[4],
                        "next_frame_ids": nxt[0], "next_img_paths": nxt[1],
                        "next_lid_paths": nxt[2], "next_poses": nxt[3],
                        "next_dists": nxt[4],
                        "T_velo_2_img": Tvi, "T_velo_2_cam0": calib["P_v2c0"],
                        "T_velo_2_cam": T02 @ calib["P_v2c0"], "P": P,
                        "T_cam0_2_cam2": T02,
                        "T_cam2_2_cam0": np.linalg.inv(T02),
                        "T_cam0_2_cam3": T03,
                    }
                    if not self.strict:
                        for flag in ("prev", "next"):
                            scan[flag + "_img_paths"].append(img)
                            scan[flag + "_lid_paths"].append(lid)
                            scan[flag + "_poses"].append(pose)
                            scan[flag + "_dists"].append(0.0)
                            scan[flag + "_frame_ids"].append(frame_id)
                    self.scans.append(scan)

    def __len__(self):
        return self.length

    # ----------------------------------------------------------- geometry
    def prepare_img_metas(self, scan, anchor_scan, anchor_prev, anchor_next):
        """reference ``:417-479``."""
        intrinsic = np.eye(4)
        intrinsic[:3, :3] = scan["P"][:3, :3]
        lidar2img = scan["T_velo_2_img"] @ np.linalg.inv(self.transxy)
        img2lidar = np.linalg.inv(lidar2img)

        def chain(pose_tem):
            return intrinsic @ anchor_scan["T_cam0_2_cam2"] @ \
                np.linalg.inv(pose_tem) @ anchor_scan["pose"] @ \
                anchor_scan["T_cam2_2_cam0"] @ np.linalg.inv(intrinsic)

        img2prevImg = chain(anchor_scan["prev_poses"][anchor_prev])
        img2nextImg = chain(anchor_scan["next_poses"][anchor_next])
        temImg2lidar = self.transxy @ np.linalg.inv(scan["T_velo_2_cam"]) @ \
            scan["T_cam0_2_cam2"] @ np.linalg.inv(scan["pose"]) @ \
            anchor_scan["pose"] @ anchor_scan["T_cam2_2_cam0"] @ \
            np.linalg.inv(intrinsic)

        return {
            "input_imgs_path": [scan["img_path"]],
            "curr_imgs_path": [anchor_scan["img_path"]],
            "prev_imgs_path": [anchor_scan["prev_img_paths"][anchor_prev]],
            "next_imgs_path": [anchor_scan["next_img_paths"][anchor_next]],
            "lidar2img": lidar2img[None], "img2lidar": img2lidar[None],
            "img2prevImg": img2prevImg[None], "img2nextImg": img2nextImg[None],
            "temImg2lidar": temImg2lidar[None], "ego2lidar": np.eye(4),
            "token": scan["frame_id"], "sequence": scan["sequence"],
            "intrinsic": intrinsic,
        }

    def get_depth_from_lidar(self, lidar_path, lidar2img, image_size):
        """reference ``:335-362`` incl. the eigen normalized-coordinate crop."""
        scan = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 4)
        scan[:, 3] = 1.0
        pts = np.expand_dims(self.transxy @ scan.T, 0)
        img_points = np.transpose(lidar2img @ pts, (0, 2, 1))
        depth = img_points[..., 2]
        img_points = img_points[..., :2] / np.expand_dims(depth, 2)
        img_points[..., 0] /= image_size[1]
        img_points[..., 1] /= image_size[0]
        mask = (depth < self.eval_depth) & (depth > 0.1)
        mask &= (img_points[..., 0] > 0) & (img_points[..., 1] > 0) & \
            (img_points[..., 0] < 1) & (img_points[..., 1] < 1)
        if self.eigen_depth:
            y0, y1, x0, x1 = EIGEN_CROP
            mask &= (img_points[..., 0] > x0) & (img_points[..., 0] < x1) & \
                (img_points[..., 1] > y0) & (img_points[..., 1] < y1)
        return img_points, depth, mask

    def read_surround_imgs(self, paths):
        from ..native import get_shared_loader
        loader = get_shared_loader()
        if loader is not None:
            return list(loader.decode_batch(
                paths, crop_hw=(self.img_H, self.img_W)))
        imgs = []
        for p in paths:
            img = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32)
            imgs.append(img[:self.img_H, :self.img_W, :])
        return imgs

    def _stereo_substitute(self, metas, anchor_scan, sign, which):
        """Swap the prev/next supervision for the stereo pair
        (reference ``:563-584``)."""
        anchor_img = metas["curr_imgs_path"][0]
        swap = ("image_02", "image_03") if sign == "l" else \
            ("image_03", "image_02")
        metas[f"{which}_imgs_path"] = [anchor_img.replace(*swap)]
        K = metas["intrinsic"]
        mat = K @ anchor_scan["T_cam0_2_cam3"] @ \
            anchor_scan["T_cam2_2_cam0"] @ np.linalg.inv(K)
        metas[f"img2{which}Img"] = mat[None]
        return metas

    def __getitem__(self, index):
        while True:
            day, seq, frame_id, is_right = self._datapoints[index]
            sign = "r" if is_right else "l"
            scan = deepcopy(
                self.scans[self.frame2scan[f"{day}/{seq}_{frame_id}_{sign}"]])
            anchor_scan = deepcopy(scan)   # cur_prob == 1.0

            if not anchor_scan["prev_frame_ids"] and \
                    not anchor_scan["next_frame_ids"]:
                index = np.random.randint(len(self))
                continue

            def append_self(flag):
                anchor_scan[flag + "_img_paths"].append(scan["img_path"])
                anchor_scan[flag + "_lid_paths"].append(scan["lid_path"])
                anchor_scan[flag + "_poses"].append(scan["pose"])
                anchor_scan[flag + "_dists"].append(0.0)
                anchor_scan[flag + "_frame_ids"].append(frame_id)

            if not anchor_scan["prev_frame_ids"]:
                append_self("prev")
                target_sign = "ns"
            elif not anchor_scan["next_frame_ids"]:
                append_self("next")
                target_sign = "ps"
            elif not self.include_stereo:
                target_sign = "pn"
            else:
                r = random.random()
                target_sign = "pn" if r < 0.333 else (
                    "ps" if random.random() < 0.5 else "ns")

            anchor_prev = 0 if self.choose_nearest else \
                np.random.randint(len(anchor_scan["prev_frame_ids"]))
            anchor_next = 0 if self.choose_nearest else \
                np.random.randint(len(anchor_scan["next_frame_ids"]))
            break

        metas = self.prepare_img_metas(scan, anchor_scan, anchor_prev,
                                       anchor_next)
        if self.include_stereo and target_sign == "ns":
            metas = self._stereo_substitute(metas, anchor_scan, sign, "prev")
        elif self.include_stereo and target_sign == "ps":
            metas = self._stereo_substitute(metas, anchor_scan, sign, "next")

        if self.return_depth:
            loc, gt, mask = self.get_depth_from_lidar(
                scan["lid_path"], metas["lidar2img"],
                [self.img_H, self.img_W])
            metas.update({"depth_loc": loc, "depth_gt": gt,
                          "depth_mask": mask})

        input_imgs = self.read_surround_imgs(metas["input_imgs_path"])
        curr_imgs = self.read_surround_imgs(metas["curr_imgs_path"])
        prev_imgs = self.read_surround_imgs(metas["prev_imgs_path"])
        next_imgs = self.read_surround_imgs(metas["next_imgs_path"])
        return ([input_imgs, curr_imgs, prev_imgs, next_imgs], metas)


class Kitti_Raw(Kitti_Raw_Stereo):
    """Monocular KITTI-raw variant (reference ``kitti_raw_dataset.py``):
    identical indexing without the stereo supervision substitution."""

    def __init__(self, *args, **kwargs):
        kwargs["include_stereo"] = False
        super().__init__(*args, **kwargs)
