"""SemanticKITTI monocular temporal dataset — the port's copy of
``selfocc_tpu/data/kitti_dataset.py``.

Behavioral rewrite of ``dataset/kitti/kitti_dataset_one_frame.py`` (462 LoC) +
the ``helpers.py`` calib/pose readers: pose-distance neighbor walks (1-frame
train / 5-frame val steps), cam0/cam2 chain matrices with the axis-swap
``transxy`` that maps KITTI camera axes into the front-only lidar grid frame,
lidar depth GT, optional precomputed 2D semantic maps.

Images are decoded by the port's native C++ decoder
(``selfocc_tpu_torch/native``) when it built, with cv2 otherwise, as in the
JAX package.
"""
from __future__ import annotations

import glob
import os
import random
from copy import deepcopy
from typing import List, Optional

import cv2
import numpy as np

# frames with broken poses in sequence 08 (reference dataset/kitti/params.py
# ``val_error_frames``). The JAX package reads that list from a checkout of
# the reference when one is present and is otherwise empty; the port keeps
# no copy of the reference tree, so the list is empty and both packages
# index the same frames wherever the reference is absent.
VAL_ERROR_FRAMES = set()

TRANSXY = np.array([[0, -1., 0, 0], [1., 0, 0, 0],
                    [0, 0, 1., 0], [0, 0, 0, 1.]])

SPLITS = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}


def dump_xyz(P):
    return P[0:3, 3]


def read_poses(path) -> List[np.ndarray]:
    poses = []
    with open(path) as f:
        for line in f:
            T = np.fromstring(line, dtype=float, sep=" ").reshape(3, 4)
            poses.append(np.vstack([T, [0, 0, 0, 1]]))
    return poses


def read_calib(calib_path):
    """KITTI odometry calib parser (reference ``helpers.py:55-80``)."""
    calib_all = {}
    with open(calib_path) as f:
        for line in f:
            if line == "\n":
                break
            key, value = line.split(":", 1)
            calib_all[key] = np.array([float(x) for x in value.split()])
    out = {"P2": calib_all["P2"].reshape(3, 4), "Tr": np.identity(4)}
    out["Tr"][:3, :4] = calib_all["Tr"].reshape(3, 4)
    T2 = np.eye(4)
    T2[0, 3] = out["P2"][0, 3] / out["P2"][0, 0]
    out["T_cam0_2_cam2"] = T2
    return out


class Kitti_One_Frame:
    """reference ``kitti_dataset_one_frame.py:21-448``."""

    def __init__(self, split="train", root="data/kitti", preprocess_root="",
                 frames_interval=0.4, sequence_distance=10, eval_depth=80,
                 sequences=None, selected_frames=None, cur_prob=1.0,
                 crop_size=(370, 1220), strict=True, return_depth=False,
                 prev_prob=0.5, choose_nearest=False, return_sem=False,
                 sem_path=None, data_path=None, imageset=None, **kwargs):
        self.root = data_path or root
        self.eval_depth = eval_depth
        self.cur_prob = cur_prob
        self.prev_prob = prev_prob
        self.choose_nearest = choose_nearest
        self.return_depth = return_depth
        self.return_sem = return_sem
        self.sem_path = sem_path
        self.strict = strict
        self.split = split
        self.img_H, self.img_W = crop_size[0], crop_size[1]
        self.transxy = TRANSXY
        if not isinstance(sequence_distance, list):
            sequence_distance = [sequence_distance] * 2
        self.sequences = sequences or SPLITS[split]
        self.scans = []
        self.frame2scan = {}
        self._index_sequences(frames_interval, sequence_distance,
                              selected_frames)

    # ------------------------------------------------------------- indexing
    def _seq_path(self, sequence, *parts):
        return os.path.join(self.root, "dataset", "sequences", sequence, *parts)

    def _index_sequences(self, frames_interval, sequence_distance,
                         selected_frames):
        for sequence in self.sequences:
            pose_path = os.path.join(self.root, "dataset", "poses",
                                     sequence + ".txt")
            poses = read_poses(pose_path)
            calib = read_calib(self._seq_path(sequence, "calib.txt"))
            P = calib["P2"]
            T_cam0_2_cam2 = calib["T_cam0_2_cam2"]
            T_cam2_2_cam0 = np.linalg.inv(T_cam0_2_cam2)
            T_velo_2_cam = T_cam0_2_cam2 @ calib["Tr"]

            if self.split == "val":
                glob_path = self._seq_path(sequence, "voxels", "*.bin")
            else:
                glob_path = self._seq_path(sequence, "image_2", "*.png")
            seq_paths = sorted(glob.glob(glob_path))
            dist_step = 1 if self.split == "train" else 5

            # pairwise ground-plane distances to the previous kept frame
            paired_dists = {}
            for p in seq_paths:
                fid = os.path.splitext(os.path.basename(p))[0]
                prev_fid = "{:06d}".format(int(fid) - dist_step)
                prev_img = self._seq_path(sequence, "image_2", prev_fid + ".png")
                if not os.path.exists(prev_img):
                    paired_dists[fid] = 0.0
                else:
                    a = dump_xyz(poses[int(fid)])
                    b = dump_xyz(poses[int(prev_fid)])
                    paired_dists[fid] = float(np.hypot(a[0] - b[0], a[2] - b[2]))

            pos_step = 1 if self.split == "train" else 5
            neg_step = -pos_step
            for p in seq_paths:
                fid = os.path.splitext(os.path.basename(p))[0]
                curr_img = self._seq_path(sequence, "image_2", fid + ".png")
                curr_lid = self._seq_path(sequence, "velodyne", fid + ".bin")

                def walk(step):
                    ids, img_paths, lid_paths, ps, dists = [], [], [], [], []
                    cnt, dist = 0, 0.0
                    while True:
                        cnt += step
                        rid = "{:06d}".format(int(fid) + cnt)
                        img_path = self._seq_path(sequence, "image_2",
                                                  rid + ".png")
                        if not os.path.exists(img_path):
                            break
                        if step < 0:
                            dist += paired_dists.get(
                                "{:06d}".format(int(rid) + pos_step), 0.0)
                        else:
                            dist += paired_dists.get(rid, 0.0)
                        if dist < frames_interval:
                            continue
                        if dist > sequence_distance[0 if step < 0 else 1]:
                            break
                        if self.split == "val" and rid in VAL_ERROR_FRAMES:
                            continue
                        ids.append(rid)
                        img_paths.append(img_path)
                        lid_paths.append(self._seq_path(
                            sequence, "velodyne", rid + ".bin"))
                        ps.append(poses[int(rid)])
                        dists.append(dist)
                    return ids, img_paths, lid_paths, ps, dists

                prev = walk(neg_step)
                nxt = walk(pos_step)
                if self.split == "val" and fid in VAL_ERROR_FRAMES:
                    continue
                if selected_frames is not None and fid not in selected_frames:
                    continue

                scan = {
                    "frame_id": fid, "sequence": sequence,
                    "img_path": curr_img, "lid_path": curr_lid,
                    "pose": poses[int(fid)],
                    "prev_frame_ids": prev[0], "prev_img_paths": prev[1],
                    "prev_lid_paths": prev[2], "prev_poses": prev[3],
                    "prev_dists": prev[4],
                    "next_frame_ids": nxt[0], "next_img_paths": nxt[1],
                    "next_lid_paths": nxt[2], "next_poses": nxt[3],
                    "next_dists": nxt[4],
                    "T_velo_2_cam": T_velo_2_cam, "P": P,
                    "T_cam0_2_cam2": T_cam0_2_cam2,
                    "T_cam2_2_cam0": T_cam2_2_cam0,
                }
                if not self.strict:
                    for pref, ref in (("prev_", scan), ("next_", scan)):
                        scan[pref + "img_paths"].append(curr_img)
                        scan[pref + "lid_paths"].append(curr_lid)
                        scan[pref + "poses"].append(poses[int(fid)])
                        scan[pref + "dists"].append(0.0)
                        scan[pref + "frame_ids"].append(fid)
                self.frame2scan[f"{sequence}_{fid}"] = len(self.scans)
                self.scans.append(scan)

    def __len__(self):
        return len(self.scans)

    # ------------------------------------------------------------- geometry
    def prepare_img_metas(self, scan, anchor_scan, anchor_prev, anchor_next):
        """Camera-matrix chains (reference ``:328-374``). The ``transxy``
        axis swap maps KITTI cam coords into the front-only grid frame."""
        intrinsic = np.eye(4)
        intrinsic[:3, :3] = scan["P"][:3, :3]
        lidar2img = intrinsic @ scan["T_velo_2_cam"] @ np.linalg.inv(self.transxy)
        img2lidar = np.linalg.inv(lidar2img)

        temImg2lidar = self.transxy @ np.linalg.inv(scan["T_velo_2_cam"]) @ \
            scan["T_cam0_2_cam2"] @ np.linalg.inv(scan["pose"]) @ \
            anchor_scan["pose"] @ anchor_scan["T_cam2_2_cam0"] @ \
            np.linalg.inv(intrinsic)
        img2prevImg = intrinsic @ anchor_scan["T_cam0_2_cam2"] @ \
            np.linalg.inv(anchor_scan["prev_poses"][anchor_prev]) @ \
            anchor_scan["pose"] @ anchor_scan["T_cam2_2_cam0"] @ \
            np.linalg.inv(intrinsic)
        img2nextImg = intrinsic @ anchor_scan["T_cam0_2_cam2"] @ \
            np.linalg.inv(anchor_scan["next_poses"][anchor_next]) @ \
            anchor_scan["pose"] @ anchor_scan["T_cam2_2_cam0"] @ \
            np.linalg.inv(intrinsic)

        return {
            "input_imgs_path": [scan["img_path"]],
            "curr_imgs_path": [anchor_scan["img_path"]],
            "prev_imgs_path": [anchor_scan["prev_img_paths"][anchor_prev]],
            "next_imgs_path": [anchor_scan["next_img_paths"][anchor_next]],
            "lidar2img": lidar2img[None],
            "img2lidar": img2lidar[None],
            "temImg2lidar": temImg2lidar[None],
            "img2prevImg": img2prevImg[None],
            "img2nextImg": img2nextImg[None],
            "ego2lidar": np.eye(4),
            "token": scan["frame_id"], "sequence": scan["sequence"],
        }

    def get_depth_from_lidar(self, lidar_path, lidar2img, image_size):
        """reference ``:294-315`` (note the transxy pre-rotation)."""
        scan = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 4)
        scan[:, 3] = 1.0
        pts = np.expand_dims(self.transxy @ scan.T, 0)
        img_points = np.transpose(lidar2img @ pts, (0, 2, 1))
        depth = img_points[..., 2]
        img_points = img_points[..., :2] / np.expand_dims(depth, 2)
        img_points[..., 0] /= image_size[1]
        img_points[..., 1] /= image_size[0]
        mask = (depth < self.eval_depth) & (depth > 1e-3)
        mask &= (img_points[..., 0] > 0) & (img_points[..., 1] > 0) & \
            (img_points[..., 0] < 1) & (img_points[..., 1] < 1)
        return img_points, depth, mask

    def load_2d_sem_label(self, scan):
        filename = os.path.basename(scan["img_path"])
        sem_path = os.path.join(self.sem_path, scan["sequence"], "image_02",
                                filename + ".npy")
        return np.load(sem_path)[None]

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

    def __getitem__(self, index):
        if random.random() < self.cur_prob:
            sup = "curr"
        elif random.random() < self.prev_prob:
            sup = "prev"
        else:
            sup = "next"

        while True:
            scan = deepcopy(self.scans[index])
            seq = scan["sequence"]
            if sup == "curr":
                anchor_scan = deepcopy(scan)
            elif sup == "prev":
                if not scan["prev_frame_ids"]:
                    index = np.random.randint(len(self))
                    continue
                aid = np.random.choice(scan["prev_frame_ids"])
                anchor_scan = deepcopy(
                    self.scans[self.frame2scan[f"{seq}_{aid}"]])
            else:
                if not scan["next_frame_ids"]:
                    index = np.random.randint(len(self))
                    continue
                aid = np.random.choice(scan["next_frame_ids"])
                anchor_scan = deepcopy(
                    self.scans[self.frame2scan[f"{seq}_{aid}"]])
            if not anchor_scan["prev_frame_ids"] or \
                    not anchor_scan["next_frame_ids"]:
                index = np.random.randint(len(self))
                continue
            anchor_prev = 0 if self.choose_nearest else \
                np.random.randint(len(anchor_scan["prev_frame_ids"]))
            anchor_next = 0 if self.choose_nearest else \
                np.random.randint(len(anchor_scan["next_frame_ids"]))
            break

        metas = self.prepare_img_metas(scan, anchor_scan, anchor_prev,
                                       anchor_next)
        if self.return_depth:
            loc, gt, mask = self.get_depth_from_lidar(
                scan["lid_path"], metas["lidar2img"],
                [self.img_H, self.img_W])
            metas.update({"depth_loc": loc, "depth_gt": gt,
                          "depth_mask": mask})
        if self.return_sem:
            metas["sem"] = self.load_2d_sem_label(anchor_scan)

        input_imgs = self.read_surround_imgs(metas["input_imgs_path"])
        curr_imgs = self.read_surround_imgs(metas["curr_imgs_path"])
        prev_imgs = self.read_surround_imgs(metas["prev_imgs_path"])
        next_imgs = self.read_surround_imgs(metas["next_imgs_path"])
        return ([input_imgs, curr_imgs, prev_imgs, next_imgs], metas)
