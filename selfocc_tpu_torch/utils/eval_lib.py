"""Eval-driver machinery — counterpart of ``selfocc_tpu/utils/eval_lib.py``
(``ChunkedRenderer``, ``eval_ray_grid``, ``eval_trans_mats``,
``rays_for_cams``).

``prepare`` decodes the field once per frame (fp32 volume); ``render`` walks
the full ray grid in fixed-size chunks against it and returns host numpy
arrays of the requested outputs only.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import Config
from ..geometry.projection import rays_from_img2lidar
from ..geometry.ray_sampler import RaySampler
from ..ops.interp import first_channel

# outputs derived from the sdf channel alone: a render that asks only for
# these samples a 1-channel view of the volume (the JAX ``geo_only``)
GEO_OUTPUTS = frozenset({"depth", "weights", "acc", "fars", "inv_s", "sdf",
                         "eik_grad", "ts", "deltas"})


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

    @torch.no_grad()
    def render(self, volume, origin, direction) -> Dict[str, np.ndarray]:
        """origin/direction (R, 3) on the volume's device -> host dict of
        per-ray outputs. The ray axis is padded to a whole number of chunks
        (directions with 1.0 so padded rays stay finite). A geo-only render
        takes the sdf plane out of the volume once, not once per chunk."""
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
                                       geo_only=self.geo_only)
            outs.append({k: r[k] for k in self.outputs if k in r})
        return {k: torch.cat([x[k] for x in outs])[:R].cpu().numpy()
                for k in outs[0]}


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
