"""Eval-driver machinery — counterpart of ``selfocc_tpu/utils/eval_lib.py``
(``ChunkedRenderer``, ``GridOccEvaluator``, ``eval_ray_grid``,
``eval_trans_mats``, ``rays_for_cams``).

``prepare`` decodes the field once per frame (fp32 volume); ``render`` walks
the full ray grid in fixed-size chunks against it and returns host numpy
arrays of the requested outputs only (``render_device``: the same as tensors
on the volume's device, with no host synchronisation). ``GridOccEvaluator``
queries the uniform occupancy grid against the same volume, likewise in a
numpy form and a ``*_device`` form.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import Config
from ..geometry.projection import rays_from_img2lidar
from ..geometry.ray_sampler import RaySampler
from ..models.heads import uniform_axes, uniform_axes_on, uniform_grid
from ..ops.interp import first_channel, trilinear_sample

# outputs derived from the sdf channel alone: a render that asks only for
# these samples a 1-channel view of the volume (the JAX ``geo_only``)
GEO_OUTPUTS = frozenset({"depth", "weights", "acc", "fars", "inv_s", "sdf",
                         "eik_grad", "ts", "deltas", "normal_vis"})


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
