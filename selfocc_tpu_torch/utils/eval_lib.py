"""Eval-driver machinery — counterpart of ``selfocc_tpu/utils/eval_lib.py``
(``ChunkedRenderer``, ``GridOccEvaluator``, ``eval_ray_grid``,
``eval_trans_mats``, ``rays_for_cams``, and the novel-view depth eval:
``enable_max_depth``, ``prep_input_imgs``, ``novel_eval_first_sample``,
``run_novel_depth_eval``, ``camera_kwargs``). A camera-aware encoder's
``intrinsic`` / ``cam2ego`` reach each prepare through ``camera_kwargs``,
as in every JAX eval path.

Both heads, NeuS and density (``head_type="nerfacc"``), are driven through
the same model methods. ``prepare`` decodes the field once per frame (fp32
volume); ``render`` walks
the full ray grid in fixed-size chunks against it and returns host numpy
arrays of the requested outputs only (``render_device``: the same as tensors
on the volume's device, with no host synchronisation). ``GridOccEvaluator``
queries the uniform occupancy grid against the same volume, likewise in a
numpy form and a ``*_device`` form.

Both shard over several devices (``devices``; the JAX ``shard=True`` over
the mesh, ``eval_lib.py:126-183, 259-300``): the volume is copied to each
device once a frame, each chunk's rays or the grid's points are split into
contiguous slices, one per device (``parallel.mesh.split_rows``), each
rendered or queried by a copy of the model there, and the results are
concatenated in their order on the first device, which holds the model.
Each ray's and each point's arithmetic is the one-device path's.
``prepare_shard`` also splits the cameras of the prepare's backbone and
neck over the devices (the JAX ``prepare_shard``, ``eval_lib.py:131-141,
201-230``); their features are gathered on the first device, where the
lifter, encoder and decode run.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import Config
from ..geometry.projection import rays_from_img2lidar
from ..geometry.ray_sampler import RaySampler
from ..models.heads import uniform_axes, uniform_axes_on, uniform_grid
from ..ops.interp import bilinear_sample, first_channel, trilinear_sample
from ..parallel.mesh import split_rows
from .metrics import cal_depth_metric

# outputs derived from the sdf channel alone: a render that asks only for
# these samples a 1-channel view of the volume (the JAX ``geo_only``)
GEO_OUTPUTS = frozenset({"depth", "weights", "acc", "fars", "inv_s", "sdf",
                         "sigma", "eik_grad", "ts", "deltas", "normal_vis",
                         "max_depth"})


def camera_kwargs(cfg: Config, batch: Dict) -> Dict:
    """The ``intrinsic`` / ``cam2ego`` a camera-aware encoder takes
    (``eval_lib.py:99-121``): {} unless ``cfg.model.encoder.camera_aware``;
    then the batch (or a raw item's metas) must carry both, batched (1, N,
    4, 4) or per frame (N, 4, 4), as fp32 tensors or arrays. Tensors keep
    their device; arrays become CPU tensors (the caller's ``to_device``
    moves a batch)."""
    if not cfg.model.encoder.camera_aware:
        return {}
    missing = [k for k in ("intrinsic", "cam2ego") if k not in batch]
    if missing:
        raise KeyError(
            f"camera_aware=True but the dataset item carries no {missing}; "
            "camera-aware eval needs intrinsic+cam2ego in the batch/metas "
            "(data/wrapper.py forwards them when the dataset provides them)")
    out = {}
    for k in ("intrinsic", "cam2ego"):
        v = torch.as_tensor(batch[k]).float()
        out[k] = v[None] if v.dim() == 3 else v
    return out


def on_device(device: torch.device):
    """The context in which work on ``device`` runs: a card becomes the
    current device (the kernels launch on the current device's stream)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


class ChunkedRenderer:
    """Renders a full fixed ray grid in chunks against a prepared volume;
    with more than one of ``devices`` each chunk's rays are split over them
    (the module docstring). The model lives on ``devices[0]`` (default: its
    own device, no sharding)."""

    def __init__(self, model, chunk: int = 32768,
                 outputs: Sequence[str] = ("depth", "rgb", "acc", "sem"),
                 devices: Optional[Sequence] = None,
                 prepare_shard: bool = False):
        self.model = model
        self.chunk = chunk
        self.outputs = tuple(outputs)
        self.geo_only = set(self.outputs) <= GEO_OUTPUTS
        home = next(model.parameters()).device
        self.devices = [torch.device(d) for d in devices] if devices \
            else [home]
        if self.devices[0] != home:
            raise ValueError(f"the model is on {home}; the first of the "
                             f"devices {self.devices} must hold it")
        self.prepare_shard = prepare_shard
        self._models = {home: model}
        self._frame = {}       # geo_only -> (volume, {device: its copy})

    def _model_on(self, device: torch.device):
        """The model on ``device``: itself on the first device, else an
        eval-mode copy made at first use."""
        if device not in self._models:
            self._models[device] = copy.deepcopy(self.model).to(
                device).eval()
        return self._models[device]

    def volumes(self, volume, geo_only: bool) -> Dict:
        """device -> the volume each device queries (``geo_only``: its sdf
        plane, ``first_channel``). With several devices the copies are made
        once for each volume (kept until the next one)."""
        if len(self.devices) == 1:
            return {self.devices[0]:
                    first_channel(volume) if geo_only else volume}
        held = self._frame.get(geo_only)
        if held is None or held[0] is not volume:
            v = first_channel(volume) if geo_only else volume
            held = (volume, {d: v if d == v.device else v.to(d)
                             for d in self.devices})
            self._frame[geo_only] = held
        return held[1]

    def shard_rows(self, vols: Dict, fn: Callable, *rows) -> Dict:
        """``fn(model, volume, *rows)`` -> a dict of row-major outputs, run
        on each device's contiguous slice of ``rows`` (their leading axis)
        against ``vols[device]`` (``volumes``); the slices' outputs
        concatenated in order on the first device."""
        if len(self.devices) == 1:
            return fn(self.model, vols[self.devices[0]], *rows)
        home, parts = self.devices[0], []
        for (a, b), dev in zip(split_rows(rows[0].shape[0],
                                          len(self.devices)), self.devices):
            with on_device(dev):
                parts.append(fn(self._model_on(dev), vols[dev],
                                *[r[a:b].to(dev) for r in rows]))
        return {k: torch.cat([p[k].to(home) for p in parts])
                for k in parts[0]}

    @torch.no_grad()
    def prepare(self, imgs: torch.Tensor, lidar2img: torch.Tensor,
                flip: bool = False, intrinsic=None, cam2ego=None):
        """Backbone -> encoder -> decoded (C, H, W, D) fp32 volume;
        ``flip=True``: the flip-TTA pass, ``imgs`` mirrored along W and the
        features mirrored back before the encoder (``eval_lib.py:187-230``).
        No focal ratios, as in the JAX eval drivers; ``intrinsic`` /
        ``cam2ego``: ``camera_kwargs``. ``prepare_shard`` with several
        devices: the backbone and neck run on each device's contiguous
        share of the cameras (``models/segmentor.extract_img_feat``)."""
        feats = None
        if self.prepare_shard and len(self.devices) > 1:
            feats = self._sharded_features(imgs, flip)
        return self.model.prepare(imgs, lidar2img, flip=flip,
                                  intrinsic=intrinsic, cam2ego=cam2ego,
                                  feats=feats).float()

    def _sharded_features(self, imgs, flip) -> List[torch.Tensor]:
        """``extract_img_feat(imgs, flip)`` with the camera axis split over
        the devices, each level gathered on the first device."""
        home, parts = self.devices[0], []
        for (a, b), dev in zip(split_rows(imgs.shape[1], len(self.devices)),
                               self.devices):
            if a == b:
                continue
            f = flip.to(dev) if torch.is_tensor(flip) else flip
            with on_device(dev):
                feats = self._model_on(dev).extract_img_feat(
                    imgs[:, a:b].to(dev), f)
            parts.append([x.to(home) for x in feats])
        return [torch.cat(level, dim=1) for level in zip(*parts)]

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
        vols = self.volumes(volume, self.geo_only)
        R = origin.shape[0]
        pad = (-R) % self.chunk
        o = F.pad(origin, (0, 0, 0, pad))
        d = F.pad(direction, (0, 0, 0, pad), value=1.0)

        def render(model, vol, oo, dd):
            r = model.render_rays(vol, oo, dd, geo_only=self.geo_only,
                                  outputs=self.outputs)
            return {k: r[k] for k in self.outputs if k in r}
        outs = []
        for i in range(o.shape[0] // self.chunk):
            sl = slice(i * self.chunk, (i + 1) * self.chunk)
            outs.append(self.shard_rows(vols, render, o[sl], d[sl]))
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
    """``GridOccEvaluator`` (``eval_lib.py:257-450``): decode the field
    once per frame (an fp32 volume), then query the uniform occupancy grid
    over an AABB against it, either as one trilinear query of the flattened
    grid's points (``query="gather"``, the parity default; with several
    ``devices`` the points split over them, as ``ChunkedRenderer``'s rays
    do) or as three per-axis lerps (``"separable"``: the same interpolant,
    ~1 ulp apart; on the first device, as the JAX evaluator's separable
    query runs replicated). ``prepare_shard``: see ``ChunkedRenderer``.
    The ``*_device`` methods return tensors on the volume's device without
    a host synchronisation; the others call them and copy once to numpy."""

    def __init__(self, model, query: str = "gather",
                 devices: Optional[Sequence] = None,
                 prepare_shard: bool = False):
        if query not in ("gather", "separable"):
            raise ValueError(f"query must be gather or separable, got "
                             f"{query!r}")
        self.model = model
        self.query = query
        self._prep = ChunkedRenderer(model, devices=devices,
                                     prepare_shard=prepare_shard)

    def prepare(self, imgs, lidar2img, intrinsic=None, cam2ego=None):
        return self._prep.prepare(imgs, lidar2img, intrinsic=intrinsic,
                                  cam2ego=cam2ego)

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
        out = self._prep.shard_rows(
            self._prep.volumes(volume, False),
            lambda model, vol, pts: model.occ_from_volume(
                vol, pts, outputs=outputs), flat)
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
                    keys: Optional[Sequence[str]] = None, intrinsic=None,
                    cam2ego=None) -> Dict[str, np.ndarray]:
        """prepare + query_grid."""
        return self.query_grid(self.prepare(imgs, lidar2img, intrinsic,
                                            cam2ego), aabb, resolution,
                               keys=keys)


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
    same, so checkpoints load as they are. The density head has no
    argmax-weight depth: the driver exits, with the JAX ``eval_depth``'s
    message (``eval_depth.py:114-117``)."""
    if cfg.model.head.head_type == "nerfacc":
        raise SystemExit("--depth-metric-tgt max needs the NeuS head "
                         "(the nerfacc head has no argmax-weight depth, "
                         "matching the reference)")
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

    def prepare(imgs, lidar2img, cams):
        sync()
        t0 = time.perf_counter()
        volume = renderer.prepare(
            imgs, lidar2img, **{k: v.to(device) for k, v in
                                camera_kwargs(cfg, cams).items()})
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
            volume = prepare(imgs, lidar2img, metas)
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
        volume = prepare(batch["imgs"], batch["lidar2img"], batch)
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
