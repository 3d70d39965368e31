"""Synthetic multi-camera driving-scene batches — the port's copy of
``selfocc_tpu/data/synthetic.py`` (numpy only).

The reference validates geometry with a visual lidar-reprojection check
(``dataset/dataset_one_frame_sweeps_dist.py:447-547``); this module serves the
same role programmatically: a procedurally generated scene (ground plane +
boxes) with *exact* camera poses and temporal motion, producing batches in the
framework's canonical layout so train/eval/bench run without nuScenes/KITTI on
disk.

Batch layout (canonical across the framework):
  imgs            (1, N, H, W, 3)   network input, normalized
  curr/prev/next  (1, N, Hs, Ws, 3) supervision images (divided by 256,
                                    mirroring ``dataset_wrapper_temporal.py:166-170``)
  lidar2img, img2lidar, temImg2lidar, img2prevImg, img2nextImg (1, N, 4, 4)
  sem_gt          (1, N, Hs, Ws) int
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def surround_cameras(num_cams: int, img_size: Tuple[int, int],
                     fov_scale: float = 0.8, height: float = 1.5,
                     radius: float = 0.5):
    """Pinhole rig looking outward, nuScenes-style. Returns cam2lidar,
    intrinsics (4x4 K with image plane at ``img_size``)."""
    H, W = img_size
    fx = fy = fov_scale * W
    K = np.array([[fx, 0, W / 2, 0], [0, fy, H / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    cam2lidar = []
    for i in range(num_cams):
        yaw = 2 * np.pi * i / max(num_cams, 1)
        c, s = np.cos(yaw), np.sin(yaw)
        # camera axes in lidar frame: z_cam = forward, x_cam = right, y_cam = down
        fwd = np.array([c, s, 0.0])
        right = np.array([s, -c, 0.0])
        down = np.array([0.0, 0.0, -1.0])
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2] = right, down, fwd
        m[:3, 3] = np.array([radius * c, radius * s, height])
        cam2lidar.append(m)
    return np.stack(cam2lidar), K


def _scene_color(pts):
    """Procedural RGB for world points — smooth + edge-rich, in [0, 1]."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = 0.5 + 0.5 * np.sin(0.7 * x) * np.cos(0.9 * y)
    g = 0.5 + 0.5 * np.cos(0.5 * x + 0.3 * z)
    b = 0.5 + 0.5 * np.sin(0.4 * y + 0.6 * z)
    return np.stack([r, g, b], -1)


def _ray_ground_depth(origins, dirs, ground_z=0.0, max_depth=60.0):
    """Depth along rays to the z=ground_z plane (inf -> max_depth)."""
    dz = dirs[..., 2]
    t = (ground_z - origins[..., 2]) / np.where(np.abs(dz) < 1e-6, -1e-6, dz)
    t = np.where((t > 0) & (np.abs(dz) >= 1e-6), t, max_depth)
    return np.clip(t, 0.1, max_depth)


def render_synthetic_view(cam2lidar, K, img_size, shift=np.zeros(3)):
    """Ray-cast the procedural scene from one camera (ground plane textured
    by world-space color). Returns HxWx3 float image in [0,1]."""
    H, W = img_size
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], -1)  # H,W,3
    Kinv = np.linalg.inv(K[:3, :3])
    dirs_cam = pix @ Kinv.T
    R = cam2lidar[:3, :3]
    dirs = dirs_cam @ R.T
    origin = cam2lidar[:3, 3] + shift
    t = _ray_ground_depth(origin[None, None], dirs)
    pts = origin[None, None] + dirs * t[..., None]
    img = _scene_color(pts)
    # darken with distance for shading cues
    img *= (1.0 / (1.0 + 0.02 * t))[..., None]
    return img.astype(np.float32)


class SyntheticDataset:
    """Deterministic synthetic temporal multi-camera dataset."""

    def __init__(self, num_cams=6, input_size=(96, 160), img_size=(192, 320),
                 num_classes=17, length=16, ego_speed=1.0, seed=0):
        self.num_cams = num_cams
        self.input_size = tuple(input_size)
        self.img_size = tuple(img_size)
        self.num_classes = num_classes
        self.length = length
        self.ego_speed = ego_speed
        self.cam2lidar_in, self.K_in = surround_cameras(num_cams, self.input_size)
        self.cam2lidar_sup, self.K_sup = surround_cameras(num_cams, self.img_size)

    def __len__(self):
        return self.length

    def _matrices(self, shift):
        """lidar2img / img2lidar for the supervision rig under an ego shift."""
        l2i, i2l = [], []
        for n in range(self.num_cams):
            c2l = self.cam2lidar_sup[n].copy()
            c2l[:3, 3] += shift
            m = self.K_sup @ np.linalg.inv(c2l)
            l2i.append(m)
            i2l.append(np.linalg.inv(m))
        return np.stack(l2i), np.stack(i2l)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        shift_curr = np.array([self.ego_speed * idx, 0.0, 0.0])
        shift_prev = shift_curr - np.array([self.ego_speed, 0, 0])
        shift_next = shift_curr + np.array([self.ego_speed, 0, 0])

        def views(size_rig, K, size, shift):
            return np.stack([
                render_synthetic_view(size_rig[n], K, size, shift)
                for n in range(self.num_cams)])

        imgs = views(self.cam2lidar_in, self.K_in, self.input_size, shift_curr)
        curr = views(self.cam2lidar_sup, self.K_sup, self.img_size, shift_curr)
        prev = views(self.cam2lidar_sup, self.K_sup, self.img_size, shift_prev)
        nxt = views(self.cam2lidar_sup, self.K_sup, self.img_size, shift_next)

        l2i_in = np.stack([self.K_in @ np.linalg.inv(self.cam2lidar_in[n])
                           for n in range(self.num_cams)])
        l2i, i2l = self._matrices(np.zeros(3))          # ego-centric frame
        l2i_prev, _ = self._matrices(shift_prev - shift_curr)
        l2i_next, _ = self._matrices(shift_next - shift_curr)
        img2prev = np.stack([l2i_prev[n] @ i2l[n] for n in range(self.num_cams)])
        img2next = np.stack([l2i_next[n] @ i2l[n] for n in range(self.num_cams)])

        # semantic classes from quantized scene color
        sem = (curr[..., 0] * (self.num_classes - 1)).astype(np.int32)

        # exact sparse depth GT (stands in for lidar projections,
        # reference get_depth_from_lidar, dataset_one_frame_sweeps_dist.py:158)
        rs = np.random.RandomState(idx)
        n_pts = 256
        Hs, Ws = self.img_size
        locs, gts = [], []
        Kinv = np.linalg.inv(self.K_sup[:3, :3])
        for n in range(self.num_cams):
            u = rs.uniform(0, Ws - 1, n_pts)
            v = rs.uniform(0, Hs - 1, n_pts)
            pix = np.stack([u + 0.5, v + 0.5, np.ones_like(u)], -1)
            dirs_cam = pix @ Kinv.T
            R = self.cam2lidar_sup[n][:3, :3]
            dirs = dirs_cam @ R.T
            origin = self.cam2lidar_sup[n][:3, 3]
            t = _ray_ground_depth(origin[None], dirs)   # z-depth (dir_z_cam=1)
            locs.append(np.stack([u / (Ws - 1), v / (Hs - 1)], -1))
            gts.append(t)
        depth_loc = np.stack(locs)       # N, n, 2 in [0, 1]
        depth_gt = np.stack(gts)         # N, n
        depth_mask = (depth_gt > 0.5) & (depth_gt < 59.0)

        def b(x):
            return x[None].astype(np.float32)

        # The wrapper divides raw 0..255 images by 256 (reference
        # dataset_wrapper_temporal.py:166-170) so real supervision pixels land
        # in [0, 1). The procedural renders are ALREADY unit-scale — scale by
        # 255/256 to land on the same range (a plain /256 once squashed
        # supervision to ~0.004, silencing the photometric losses: SSIM's
        # [0,1]-tuned constants dominated and reproj gradients vanished).
        sup_scale = 255.0 / 256.0
        return {
            "imgs": b(imgs),
            "curr_imgs": b(curr) * sup_scale,
            "prev_imgs": b(prev) * sup_scale,
            "next_imgs": b(nxt) * sup_scale,
            "color_imgs": b(curr) * sup_scale,
            "sem_gt": sem[None],
            "lidar2img": b(l2i_in),
            "img2lidar": b(i2l),
            "temImg2lidar": b(i2l),
            "img2prevImg": b(img2prev),
            "img2nextImg": b(img2next),
            # camera parameters for CameraAwareSE (camera_se_net.py:93-119)
            "intrinsic": b(np.stack([self.K_in] * self.num_cams)),
            "cam2ego": b(self.cam2lidar_in),
            "depth_loc": depth_loc.astype(np.float32),
            "depth_gt": depth_gt.astype(np.float32),
            "depth_mask": depth_mask,
        }

    def novel_view_sample(self, idx: int, offset: float):
        """Camera matrices + exact depth GT for a temporally shifted ego pose
        (stands in for ``nuScenes_One_Frame_Eval``'s per-neighbor
        ``temImg2lidars``, reference ``dataset_one_frame_eval.py:16-249``)."""
        shift = np.array([offset, 0.0, 0.0])
        l2i, i2l = self._matrices(shift)
        rs = np.random.RandomState(1000 + idx)
        n_pts = 256
        Hs, Ws = self.img_size
        Kinv = np.linalg.inv(self.K_sup[:3, :3])
        locs, gts = [], []
        for n in range(self.num_cams):
            u = rs.uniform(0, Ws - 1, n_pts)
            v = rs.uniform(0, Hs - 1, n_pts)
            pix = np.stack([u + 0.5, v + 0.5, np.ones_like(u)], -1)
            dirs = (pix @ Kinv.T) @ self.cam2lidar_sup[n][:3, :3].T
            origin = self.cam2lidar_sup[n][:3, 3] + shift
            t = _ray_ground_depth(origin[None], dirs)
            locs.append(np.stack([u / (Ws - 1), v / (Hs - 1)], -1))
            gts.append(t)
        depth_gt = np.stack(gts)
        return {
            "temImg2lidar": i2l[None].astype(np.float32),
            "depth_loc": np.stack(locs).astype(np.float32),
            "depth_gt": depth_gt.astype(np.float32),
            "depth_mask": (depth_gt > 0.5) & (depth_gt < 59.0),
            "frame_dist": abs(offset),
        }

    def occ3d_labels(self, idx=0):
        """Occ3D-format GT for the procedural scene on the standard ego grid
        (200x200x16, [-40,40]x[-40,40]x[-1,5.4], reference eval_iou.py:26-32
        labels.npz layout): 'semantics' with 17 = free, ground slab ->
        class 11 (driveable_surface); full 'mask_camera'/'mask_lidar'."""
        zs = np.linspace(-1 + 0.2, 5.4 - 0.2, 16)
        sem = np.full((200, 200, 16), 17, dtype=np.uint8)
        sem[:, :, zs <= 0.0] = 11
        ones = np.ones((200, 200, 16), dtype=bool)
        return {"semantics": sem, "mask_camera": ones, "mask_lidar": ones}

    def gt_occupancy(self, aabb, resolution):
        """Binary GT occupancy of the procedural scene on a uniform grid
        (ground slab z<=0) — for IoU pipeline validation."""
        xs = np.linspace(aabb[0], aabb[3], int((aabb[3] - aabb[0]) / resolution))
        ys = np.linspace(aabb[1], aabb[4], int((aabb[4] - aabb[1]) / resolution))
        zs = np.linspace(aabb[2], aabb[5], int((aabb[5] - aabb[2]) / resolution))
        W, H, D = len(xs), len(ys), len(zs)
        z = np.broadcast_to(zs[None, None, :], (H, W, D))
        return (z <= 0.0)
