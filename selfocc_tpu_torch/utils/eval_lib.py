"""Eval-driver machinery — counterpart of ``selfocc_tpu/utils/eval_lib.py``
(``ChunkedRenderer``, ``GridOccEvaluator``, ``eval_ray_grid``,
``eval_trans_mats``, ``rays_for_cams``, and the novel-view depth eval:
``enable_max_depth``, ``prep_input_imgs``, ``novel_eval_first_sample``,
``run_novel_depth_eval``). The JAX module's ``camera_kwargs`` has no
counterpart: the port refuses camera-aware encoders
(``models/segmentor.check_ported``), so the prepare takes no camera
arguments.

``prepare`` decodes the field once per frame (fp32 volume); ``render`` walks
the full ray grid in fixed-size chunks against it and returns host numpy
arrays of the requested outputs only (``render_device``: the same as tensors
on the volume's device, with no host synchronisation). ``GridOccEvaluator``
queries the uniform occupancy grid against the same volume, likewise in a
numpy form and a ``*_device`` form.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import Config
from ..geometry.projection import rays_from_img2lidar
from ..geometry.ray_sampler import RaySampler
from ..models.heads import uniform_axes, uniform_axes_on, uniform_grid
from ..ops.interp import bilinear_sample, first_channel, trilinear_sample
from .metrics import cal_depth_metric

# outputs derived from the sdf channel alone: a render that asks only for
# these samples a 1-channel view of the volume (the JAX ``geo_only``)
GEO_OUTPUTS = frozenset({"depth", "weights", "acc", "fars", "inv_s", "sdf",
                         "eik_grad", "ts", "deltas", "normal_vis",
                         "max_depth"})


class ChunkedRenderer:
    """Renders a full fixed ray grid in chunks against a prepared volume."""

    def __init__(self, model, chunk: int = 32768,
                 outputs: Sequence[str] = ("depth", "rgb", "acc", "sem")):
        self.model = model
        self.chunk = chunk
        self.outputs = tuple(outputs)
        self.geo_only = set(self.outputs) <= GEO_OUTPUTS

    @torch.no_grad()
    def prepare(self, imgs: torch.Tensor, lidar2img: torch.Tensor):
        """Backbone -> encoder -> decoded (C, H, W, D) fp32 volume."""
        return self.model.prepare(imgs, lidar2img).float()

    def render(self, volume, origin, direction) -> Dict[str, np.ndarray]:
        """origin/direction (R, 3) on the volume's device -> host dict of
        per-ray outputs."""
        return {k: v.cpu().numpy() for k, v in
                self.render_device(volume, origin, direction).items()}

    @torch.no_grad()
    def render_device(self, volume, origin,
                      direction) -> Dict[str, torch.Tensor]:
        """``render``'s outputs as tensors on the volume's device. The ray
        axis is padded to a whole number of chunks (directions with 1.0 so
        padded rays stay finite); each chunk renders only ``outputs``. A
        geo-only render takes the sdf plane out of the volume once, not once
        per chunk."""
        if self.geo_only:
            volume = first_channel(volume)
        R = origin.shape[0]
        pad = (-R) % self.chunk
        o = F.pad(origin, (0, 0, 0, pad))
        d = F.pad(direction, (0, 0, 0, pad), value=1.0)
        outs = []
        for i in range(o.shape[0] // self.chunk):
            sl = slice(i * self.chunk, (i + 1) * self.chunk)
            r = self.model.render_rays(volume, o[sl], d[sl],
                                       geo_only=self.geo_only,
                                       outputs=self.outputs)
            outs.append({k: r[k] for k in self.outputs if k in r})
        return {k: torch.cat([x[k] for x in outs])[:R] for k in outs[0]}


def occ3d_indices(pts: np.ndarray, pcr, expansion, grid_shape) -> np.ndarray:
    """Fractional (h, w, d) indices of metric lidar-frame points ``pts``
    (..., 3) in the (H, W, D) uniform grid over ``pcr`` (align-corners,
    h <- y, w <- x, d <- z), computed in float64 and rounded to fp32 as in
    ``eval_lib.py:418-422``."""
    H, W, D = grid_shape
    fy = (pts[..., 1] - pcr[1]) / expansion[1] * (H - 1)
    fx = (pts[..., 0] - pcr[0]) / expansion[0] * (W - 1)
    fz = (pts[..., 2] - pcr[2]) / expansion[2] * (D - 1)
    return np.stack([fy, fx, fz], -1).astype(np.float32)


class GridOccEvaluator:
    """``GridOccEvaluator`` (``eval_lib.py:257-450``) on one card: decode
    the field once per frame (an fp32 volume), then query the uniform
    occupancy grid over an AABB against it, either as one trilinear query
    of the flattened grid's points (``query="gather"``, the parity default)
    or as three per-axis lerps (``"separable"``: the same interpolant, ~1
    ulp apart). The ``*_device`` methods return tensors on the volume's
    device without a host synchronisation; the others call them and copy
    once to numpy."""

    def __init__(self, model, query: str = "gather"):
        if query not in ("gather", "separable"):
            raise ValueError(f"query must be gather or separable, got "
                             f"{query!r}")
        self.model = model
        self.query = query
        self._prep = ChunkedRenderer(model)

    def prepare(self, imgs, lidar2img):
        return self._prep.prepare(imgs, lidar2img)

    @staticmethod
    def _flat_grid(aabb, resolution, device):
        """The uniform grid's (H * W * D, 3) metric points and (H, W, D)."""
        xs, ys, zs = uniform_axes_on(tuple(aabb), resolution, device)
        shape = (ys.shape[0], xs.shape[0], zs.shape[0])
        return uniform_grid(xs, ys, zs).reshape(-1, 3), shape

    def _dense(self, volume, aabb, resolution, outputs):
        """The occupancy query on the whole grid -> (H, W, D[, C]) outputs
        (views of one channel-last result where the query gives one)."""
        if self.query == "separable":
            xs, ys, zs = uniform_axes_on(tuple(aabb), resolution,
                                         volume.device)
            return self.model.occ_uniform(volume, xs, ys, zs, outputs=outputs)
        flat, shape = self._flat_grid(aabb, resolution, volume.device)
        out = self.model.occ_from_volume(volume, flat, outputs=outputs)
        return {k: v.reshape(shape + tuple(v.shape[1:]))
                for k, v in out.items()}

    @staticmethod
    def _shrink(key, v):
        """The argmax grid as uint8 (classes < 256)."""
        return v.to(torch.uint8) if key == "sem" else v

    @torch.no_grad()
    def query_grid_device(self, volume, aabb, resolution,
                          keys: Optional[Sequence[str]] = None
                          ) -> Dict[str, torch.Tensor]:
        """The uniform-grid outputs ``sdf`` (H, W, D), ``sem`` (uint8) and
        ``logits`` (H, W, D, C), or only ``keys``, on the volume's device.
        Asked for ``sdf`` alone, the query samples the sdf plane only."""
        out = self._dense(volume, aabb, resolution, keys)
        if keys is not None:
            out = {k: out[k] for k in keys if k in out}
        return {k: self._shrink(k, v) for k, v in out.items()}

    def query_grid(self, volume, aabb, resolution,
                   keys: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
        """``query_grid_device`` copied to numpy, plus ``xyz`` (H, W, D, 3),
        the grid's metric points."""
        res = {k: v.cpu().numpy() for k, v in self.query_grid_device(
            volume, aabb, resolution, keys).items()}
        xs, ys, zs = uniform_axes(aabb, resolution)
        res["xyz"] = np.stack(np.meshgrid(ys, xs, zs, indexing="ij"),
                              -1)[..., [1, 0, 2]]
        return res

    def grid_shape(self, aabb, resolution):
        xs, ys, zs = uniform_axes(aabb, resolution)
        return ys.shape[0], xs.shape[0], zs.shape[0]

    @torch.no_grad()
    def query_grid_occ3d_device(self, volume, aabb, resolution,
                                idx) -> Dict[str, torch.Tensor]:
        """The Occ3D query (``eval_lib.py:407-435``): the uniform grid's sdf
        and sem logits, trilinearly resampled at fractional grid indices
        ``idx`` (..., 3) on the volume's device (``occ3d_indices``) ->
        ``sdf_r``, the resampled logits ``logits_r`` and their argmax
        ``sem_r``. On the card the resample reads the dense query's
        channel-last sdf and logits in place."""
        out = self._dense(volume, aabb, resolution, ("sdf", "logits"))
        res = {"sdf_r": trilinear_sample(out["sdf"][..., None], idx)[..., 0]}
        if "logits" in out:
            res["logits_r"] = trilinear_sample(out["logits"], idx)
            res["sem_r"] = torch.argmax(res["logits_r"], dim=-1)
        return res

    def query_grid_occ3d(self, volume, aabb, resolution, pts, pcr,
                         expansion) -> Dict[str, np.ndarray]:
        """``query_grid_occ3d_device``'s ``sdf_r`` and ``sem_r`` at the
        metric lidar-frame points ``pts``
        (``eval_iou.occ3d_ego_to_grid_coords``), copied to numpy."""
        idx = torch.from_numpy(occ3d_indices(
            np.asarray(pts), pcr, expansion,
            self.grid_shape(aabb, resolution)))
        if volume.is_cuda:
            idx = idx.pin_memory().to(volume.device, non_blocking=True)
        out = self.query_grid_occ3d_device(volume, aabb, resolution, idx)
        return {k: out[k].cpu().numpy() for k in ("sdf_r", "sem_r")
                if k in out}

    def forward_occ(self, imgs, lidar2img, aabb, resolution,
                    keys: Optional[Sequence[str]] = None
                    ) -> Dict[str, np.ndarray]:
        """prepare + query_grid."""
        return self.query_grid(self.prepare(imgs, lidar2img), aabb,
                               resolution, keys=keys)


def eval_ray_grid(cfg: Config, device=None) -> torch.Tensor:
    """Fixed eval ray grid (reference ``modify_for_eval`` NUM_RAYS)."""
    return RaySampler(ray_sample_mode="fixed",
                      ray_number=tuple(cfg.eval_num_rays),
                      ray_img_size=tuple(cfg.img_size))(device)


def eval_trans_mats(batch, cfg: Config):
    """The matrices the eval render projects rays through: ``trans_kw_eval``
    when set, else ``trans_kw``, falling back to ``img2lidar``."""
    h = cfg.model.head
    kw = h.trans_kw_eval or h.trans_kw
    if isinstance(kw, (list, tuple)):
        kw = kw[0]
    return batch[kw] if kw in batch else batch["img2lidar"]


def rays_for_cams(img2lidar, rays):
    """(1, N, 4, 4) + (R, 2) -> flat origins / directions (N * R, 3)."""
    origin, direction = rays_from_img2lidar(img2lidar, rays)
    _, N, R = direction.shape[:3]
    origin = origin[0, :, None, :].expand(N, R, 3).reshape(-1, 3)
    return origin, direction[0].reshape(-1, 3)


def enable_max_depth(cfg: Config) -> Config:
    """``cfg`` with the head's ``return_max_depth`` on (the reference sets it
    in every eval driver that scores the argmax-weight render,
    ``eval_novel_depth.py:70``). An output-only flag: the weights are the
    same, so checkpoints load as they are."""
    if cfg.model.head.return_max_depth:
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head,
                                            return_max_depth=True)))


def prep_input_imgs(input_imgs, cfg: Config, device=None) -> torch.Tensor:
    """The val pipeline (Normalize -> RandomScale(cfg.scale_rate) -> Pad div
    32) on a list of raw HWC images -> (1, N, H, W, 3) float32 network
    input, for raw eval datasets that bypass the ``TemporalDatasetWrapper``
    (``eval_lib.py:453``)."""
    from ..data.transforms import (IMG_NORM, NormalizeMultiviewImage,
                                   PadMultiViewImage,
                                   RandomScaleImageMultiViewImage,
                                   forward_aug)
    transforms = [NormalizeMultiviewImage(**IMG_NORM)]
    if cfg.scale_rate != 1:
        transforms.append(RandomScaleImageMultiViewImage([cfg.scale_rate]))
    transforms.append(PadMultiViewImage(size_divisor=32))
    imgs, _ = forward_aug(list(input_imgs), {}, transforms)
    return torch.from_numpy(np.stack(imgs).astype(np.float32))[None].to(
        device or "cpu")


def novel_eval_first_sample(ds, cfg: Config, real: bool) -> Dict:
    """The first item's network inputs, as host arrays, from a raw
    novel-view eval dataset (``(input_imgs, anchor_imgs, metas)`` items) or
    a canonical-batch dataset (``eval_lib.py:503``)."""
    if real:
        input_imgs, _, metas0 = ds[0]
        return {"imgs": prep_input_imgs(input_imgs, cfg).numpy(),
                "lidar2img": np.asarray(metas0["lidar2img"],
                                        np.float32)[None],
                cfg.model.head.trans_kw: np.asarray(
                    metas0["img2lidar"], np.float32)[None]}
    return {k: np.asarray(v) for k, v in ds[0].items()
            if not isinstance(v, (str, dict))}


BUCKET_KEYS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def run_novel_depth_eval(ds, real: bool, cfg: Config, renderer, logger,
                         device, num_samples: int = 0,
                         offsets=(-2.0, -1.0, 1.0, 2.0),
                         depth_key: str = "depth") -> Dict:
    """The novel-view depth loop (``eval_lib.py:517-591``, reference
    ``eval_novel_depth.py:133-229``): decode the field once per sample,
    render depth from each temporal neighbour's poses
    (``temImg2lidars[j]``; on the synthetic scene
    ``novel_view_sample(i, offset)``), and bucket the depth errors by
    ``ceil(distance)``. ``depth_key``: the scored render, ``depth`` or
    ``max_depth`` (``--depth-tgt raw|max``). Logs the bucket table and
    returns ``buckets`` (bucket -> metric -> per-camera values), ``table``
    (bucket -> the seven means), ``prepare_s`` (per sample) and
    ``render_s`` (per neighbour; the render ends with the host copy of the
    depths), and ``rays`` (per neighbour)."""
    rays = eval_ray_grid(cfg, device=device)
    rh, rw = cfg.eval_num_rays
    buckets = defaultdict(lambda: defaultdict(list))
    n = min(num_samples or len(ds), len(ds))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    stats = {"prepare_s": [], "render_s": [], "rays": 0}

    def prepare(imgs, lidar2img):
        sync()
        t0 = time.perf_counter()
        volume = renderer.prepare(imgs, lidar2img)
        sync()
        stats["prepare_s"].append(time.perf_counter() - t0)
        return volume

    def render(volume, tem):
        origin, direction = rays_for_cams(
            torch.as_tensor(np.asarray(tem), dtype=torch.float32,
                            device=device), rays)
        t0 = time.perf_counter()
        depth = renderer.render(volume, origin, direction)[depth_key]
        stats["render_s"].append(time.perf_counter() - t0)
        stats["rays"] = origin.shape[0]
        return torch.from_numpy(depth).reshape(cfg.num_cams, rh, rw)

    def score(depth, loc, gt_all, mask_all, bucket):
        loc = np.asarray(loc)
        pix = torch.from_numpy(np.stack(
            [loc[..., 0] * (rw - 1), loc[..., 1] * (rh - 1)], -1)).float()
        for c in range(cfg.num_cams):
            m = np.asarray(mask_all[c]).astype(bool)
            if m.sum() == 0:
                continue
            pred = bilinear_sample(depth[c][..., None], pix[c],
                                   "border")[..., 0].numpy()[m]
            for k, v in cal_depth_metric(pred,
                                         np.asarray(gt_all[c])[m]).items():
                buckets[bucket][k].append(v)

    for i in range(n):
        if real:
            input_imgs, _, metas = ds[i]
            imgs = prep_input_imgs(input_imgs, cfg, device)
            lidar2img = torch.as_tensor(
                np.asarray(metas["lidar2img"]), dtype=torch.float32,
                device=device)[None]
            volume = prepare(imgs, lidar2img)
            for j, tem in enumerate(metas["temImg2lidars"]):
                depth = render(volume, np.asarray(tem)[None])
                score(depth, metas["depth_loc"][j], metas["depth_gt"][j],
                      metas["depth_mask"][j],
                      math.ceil(metas["frame_dists"][j]))
            logger.info(f"[{i + 1}/{n}] rendered "
                        f"{len(metas['temImg2lidars'])} novel views")
            continue
        item = ds[i]
        batch = {k: torch.as_tensor(np.asarray(v)).to(device)
                 for k, v in item.items() if not isinstance(v, (str, dict))}
        volume = prepare(batch["imgs"], batch["lidar2img"])
        if not hasattr(ds, "novel_view_sample"):
            continue
        for off in offsets:
            nb = ds.novel_view_sample(i, off)
            depth = render(volume, nb["temImg2lidar"])
            score(depth, nb["depth_loc"], nb["depth_gt"], nb["depth_mask"],
                  math.ceil(nb["frame_dist"]))
        logger.info(f"[{i + 1}/{n}] rendered {len(offsets)} novel views")

    logger.info(("{:>8} | " * 8).format("dist", *BUCKET_KEYS))
    table = {}
    for b in sorted(buckets):
        table[b] = [float(np.mean(buckets[b][k])) for k in BUCKET_KEYS]
        logger.info((f"{b:>8} | " + "{: 8.3f} | " * 7).format(*table[b]))
    return dict(stats, buckets=buckets, table=table)
