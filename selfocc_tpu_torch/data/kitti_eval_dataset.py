"""SemanticKITTI novel-view evaluation dataset — the port's copy of
``selfocc_tpu/data/kitti_eval_dataset.py``.

Behavioral rewrite of ``dataset/kitti/kitti_dataset_eval.py:23-398`` (the
remainder of that 604-LoC file is commented-out dead code): per validation
scan, walk forward/backward through the sequence accumulating ground-plane
ego displacement until ``sequence_distance``, keeping frames at least
``frames_interval`` apart from the last kept one; ``__getitem__`` returns
``(input_imgs, anchor_imgs, img_metas)`` with per-NEXT-neighbor
``temImg2lidars`` + lidar depth GT projected through the CURRENT
``lidar2img`` (the reference scores novel renders against the neighbor's
lidar in the current image frame, ``kitti_dataset_eval.py:381-383``) and
``frame_dists`` = cumulative distances for the per-distance buckets.

Quirk preserved: the reference accumulates ``dist += tmp_dist`` on every
candidate frame (including skipped ones, each measured against the last KEPT
pose), so the bucket distances over-count when frames are dense — matched
exactly (``kitti_dataset_eval.py:155-226``).
"""
from __future__ import annotations

import glob
import os
from copy import deepcopy

import cv2
import numpy as np

from .kitti_dataset import (SPLITS, TRANSXY, VAL_ERROR_FRAMES, dump_xyz,
                            read_calib, read_poses)


class Kitti_Novel_View_Eval:

    def __init__(self, split="val", data_path="data/kitti", root=None,
                 frames_interval=0.4, sequence_distance=10, n_sources=1,
                 eval_depth=80, sequences=None, selected_frames=None,
                 crop_size=(370, 1220), imageset=None, **kwargs):
        self.root = data_path or root
        self.split = split
        self.eval_depth = eval_depth
        self.n_sources = n_sources
        self.img_H, self.img_W = crop_size[0], crop_size[1]
        self.transxy = TRANSXY
        self.sequences = sequences or SPLITS[split]
        self.scans = []
        self.frame2scan = {}
        self._index(frames_interval, sequence_distance, selected_frames)

    def _seq_path(self, sequence, *parts):
        return os.path.join(self.root, "dataset", "sequences", sequence,
                            *parts)

    def _index(self, frames_interval, sequence_distance, selected_frames):
        for sequence in self.sequences:
            poses = read_poses(os.path.join(self.root, "dataset", "poses",
                                            sequence + ".txt"))
            calib = read_calib(self._seq_path(sequence, "calib.txt"))
            P = calib["P2"]
            T_cam0_2_cam2 = calib["T_cam0_2_cam2"]
            T_velo_2_cam = T_cam0_2_cam2 @ calib["Tr"]

            if self.split == "val":
                glob_path = self._seq_path(sequence, "voxels", "*.bin")
            else:
                glob_path = self._seq_path(sequence, "image_2", "*.png")
            seq_paths = sorted(glob.glob(glob_path))

            for p in seq_paths:
                fid = os.path.splitext(os.path.basename(p))[0]
                curr_img = self._seq_path(sequence, "image_2", fid + ".png")
                curr_lid = self._seq_path(sequence, "velodyne", fid + ".bin")

                # eval walk: step is ALWAYS 1 frame; distance measured to the
                # last KEPT pose (reference kitti_dataset_eval.py:155-226)
                def walk(step):
                    ids, img_paths, lid_paths = [], [], []
                    kept_poses = [poses[int(fid)]]
                    dists = []
                    cnt, dist = 0, 0.0
                    while True:
                        cnt += step
                        rid = "{:06d}".format(int(fid) + cnt)
                        img_path = self._seq_path(sequence, "image_2",
                                                  rid + ".png")
                        if int(fid) + cnt < 0 or not os.path.exists(img_path):
                            break
                        a = dump_xyz(kept_poses[-1])
                        b = dump_xyz(poses[int(rid)])
                        tmp = float(np.hypot(a[0] - b[0], a[2] - b[2]))
                        dist += tmp
                        if tmp < frames_interval:
                            continue
                        if dist > sequence_distance:
                            break
                        if self.split == "val" and rid in VAL_ERROR_FRAMES:
                            continue
                        ids.append(rid)
                        img_paths.append(img_path)
                        lid_paths.append(self._seq_path(
                            sequence, "velodyne", rid + ".bin"))
                        kept_poses.append(poses[int(rid)])
                        dists.append(dist)
                    return ids, img_paths, lid_paths, kept_poses[1:], dists

                prev = walk(-1)
                nxt = walk(1)
                if self.split == "val" and fid in VAL_ERROR_FRAMES:
                    continue
                included = (len(nxt[0]) > 0 if selected_frames is None
                            else fid in selected_frames)
                if not included:
                    continue
                self.frame2scan[f"{sequence}_{fid}"] = len(self.scans)
                self.scans.append({
                    "frame_id": fid, "sequence": sequence,
                    "img_path": curr_img, "lid_path": curr_lid,
                    "pose": poses[int(fid)],
                    "prev_img_paths": prev[1], "prev_lid_paths": prev[2],
                    "prev_poses": prev[3], "prev_dists": prev[4],
                    "prev_frame_ids": prev[0],
                    "next_img_paths": nxt[1], "next_lid_paths": nxt[2],
                    "next_poses": nxt[3], "next_dists": nxt[4],
                    "next_frame_ids": nxt[0],
                    "T_velo_2_cam": T_velo_2_cam, "P": P,
                    "T_cam0_2_cam2": T_cam0_2_cam2,
                })

    def __len__(self):
        return len(self.scans)

    def get_depth_from_lidar(self, lidar_path, lidar2img, image_size):
        """reference ``kitti_dataset_eval.py:287-309`` (transxy
        pre-rotation)."""
        scan = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 4)
        scan[:, 3] = 1.0
        pts = np.expand_dims(self.transxy @ scan.T, 0)        # 1, 4, n
        img_points = np.transpose(lidar2img @ pts, (0, 2, 1))  # N, n, 4
        depth = img_points[..., 2]
        img_points = img_points[..., :2] / np.expand_dims(depth, 2)
        img_points[..., 0] /= image_size[1]
        img_points[..., 1] /= image_size[0]
        mask = (depth < self.eval_depth) & (depth > 1e-3)
        mask &= (img_points[..., 0] > 0) & (img_points[..., 1] > 0) & \
            (img_points[..., 0] < 1) & (img_points[..., 1] < 1)
        return img_points, depth, mask

    def prepare_temImg2lidar(self, scan, anchor):
        """reference ``:314-325``: neighbor image -> current lidar frame."""
        intrinsic = np.eye(4)
        intrinsic[:3, :3] = scan["P"][:3, :3]
        temImg2lidar = self.transxy @ np.linalg.inv(scan["T_velo_2_cam"]) @ \
            scan["T_cam0_2_cam2"] @ \
            np.linalg.inv(scan["pose"]) @ \
            scan["next_poses"][anchor] @ \
            np.linalg.inv(scan["T_cam0_2_cam2"]) @ \
            np.linalg.inv(intrinsic)
        return np.asarray([temImg2lidar])

    def prepare_img_metas(self, scan):
        intrinsic = np.eye(4)
        intrinsic[:3, :3] = scan["P"][:3, :3]
        lidar2img = intrinsic @ scan["T_velo_2_cam"] @ \
            np.linalg.inv(self.transxy)
        return {
            "input_imgs_path": [scan["img_path"]],
            "lidar2img": np.expand_dims(lidar2img, 0),
            "img2lidar": np.asarray([np.linalg.inv(lidar2img)]),
            "token": scan["frame_id"], "sequence": scan["sequence"]}

    def read_surround_imgs(self, img_paths):
        imgs = []
        for p in img_paths:
            img = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32)
            imgs.append(img[:self.img_H, :self.img_W, :])
        return imgs

    def __getitem__(self, index):
        scan = deepcopy(self.scans[index])
        img_metas = self.prepare_img_metas(scan)

        anchor_imgs, locs, gts, masks, temImg2lidars = [], [], [], [], []
        for anchor in range(len(scan["next_frame_ids"])):
            temImg2lidars.append(self.prepare_temImg2lidar(scan, anchor))
            anchor_imgs.append(self.read_surround_imgs(
                [scan["next_img_paths"][anchor]]))
            loc, gt, mask = self.get_depth_from_lidar(
                scan["next_lid_paths"][anchor], img_metas["lidar2img"],
                (self.img_H, self.img_W))
            locs.append(loc)
            gts.append(gt)
            masks.append(mask)

        img_metas.update({
            "depth_loc": locs, "depth_gt": gts, "depth_mask": masks,
            "temImg2lidars": temImg2lidars,
            "frame_dists": scan["next_dists"]})
        input_imgs = self.read_surround_imgs(img_metas["input_imgs_path"])
        return (input_imgs, anchor_imgs, img_metas)
