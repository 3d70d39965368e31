"""Density-field head — counterpart of
``selfocc_tpu/models/density_head.py`` (``NeRFAccHead``,
``occupancy_grid``), the NeRFAcc-based alternative to the NeuS head with the
same driver interface: ``prepare``, ``render_rays``, the training
``forward`` and the occupancy queries (``heads.OccupancyQueries``), which
return the density softplus(channel 0) under the key ``sdf``
(``eval_iou --density`` thresholds it from above).

The render takes fixed uniform samples per ray (the JAX package's static
stand-in for nerfacc's grid traversal), density = softplus(channel 0), alpha
= 1 - exp(-density * delta), the weights through ``ops.render_weights.
weights_from_alpha`` (the ``neus_weights_fwd`` / ``neus_weights_bwd``
kernels for CUDA tensors, their plain versions on the CPU), and the depth
normalised by the opacity (the reference's ``rendering.py:158`` quirk). The
volume queries are values only (``ops.interp.trilinear_sample_cf``: the
``trilinear_cf_fwd`` / ``trilinear_cf_bwd`` kernels on the card). There is
no ray chunking, as in the JAX head.

The field sits at ``head.radiance_field`` (the reference's key; it has no
NeuS variance). Randomness: the stratified jitter and the random background
come from an explicit ``torch.Generator`` or from ``draws`` (``cellular``
(4,), ``t_rand`` (R, S + 1), ``bkgd`` (R, 3)), as in ``NeuSHead``.
"""
from __future__ import annotations

from typing import Any, Collection, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.projection import rays_from_img2lidar
from ..geometry.ray_sampler import RaySampler
from ..ops.interp import first_channel
from ..ops.render_weights import weights_from_alpha
from . import neus
from .field import TPVSDFField
from .heads import OccupancyQueries

OCC_THRE = 0.0  # reference nerfacc_head.py:18


def occupancy_grid(volume: torch.Tensor, thre: float = OCC_THRE):
    """Binary occupancy grid (H, W, D) from a decoded (C, H, W, D) density
    volume: softplus(channel 0) > ``thre`` (``density_head.py:39-43``)."""
    return F.softplus(volume[0]) > thre


class NeRFAccHead(OccupancyQueries, nn.Module):
    """Density-field head with the same driver interface as ``NeuSHead``;
    its occupancy queries return the density softplus(channel 0)."""

    occ_value = staticmethod(F.softplus)

    def __init__(self, roi_aabb: Sequence[float], mapping_args: Dict[str, Any],
                 resolution: float = 0.4, near_plane: float = 0.0,
                 far_plane: float = 1e10, num_samples: int = 256,
                 ray_sample_mode: str = "fixed",
                 ray_number: Sequence[int] = (192, 400),
                 ray_img_size: Sequence[int] = (768, 1600),
                 ray_upper_crop: int = 0, render_bkgd: str = "white",
                 embed_dims: int = 96, color_dims: int = 0,
                 sem_dims: int = 0, density_layers: int = 2, sh_deg: int = 2,
                 sh_act: str = "relu", tpv: bool = False,
                 return_sem: bool = False):
        super().__init__()
        self.roi_aabb = tuple(roi_aabb)
        self.resolution = resolution
        self.near_plane, self.far_plane = near_plane, far_plane
        self.num_samples = num_samples
        self.render_bkgd = render_bkgd
        self.color_dims, self.sem_dims = color_dims, sem_dims
        self.return_sem = return_sem
        self.radiance_field = TPVSDFField(
            mapping_args=mapping_args, embed_dims=embed_dims,
            color_dims=color_dims, sem_dims=sem_dims,
            density_layers=density_layers, sh_deg=sh_deg, sh_act=sh_act,
            tpv=tpv, variance=False)
        self.ray_sampler = RaySampler(
            ray_sample_mode=ray_sample_mode, ray_number=tuple(ray_number),
            ray_img_size=tuple(ray_img_size), ray_upper_crop=ray_upper_crop)
        self.ray_sampler_eval = RaySampler(
            ray_sample_mode="fixed", ray_number=tuple(ray_number),
            ray_img_size=tuple(ray_img_size), ray_upper_crop=ray_upper_crop)

    @property
    def field(self) -> TPVSDFField:
        return self.radiance_field

    def prepare(self, representation) -> torch.Tensor:
        """Decode the field volume once: (C, H, W, D) for bs = 1."""
        return self.field.decode(representation)[0]

    def render_rays(self, volume, origin, direction, geo_only: bool = False,
                    train: bool = False, generator=None,
                    draws: Optional[Dict[str, torch.Tensor]] = None,
                    outputs: Optional[Collection[str]] = None):
        """Density render of (R,) rays against a decoded (C, H, W, D) volume
        (``density_head.py:92-147``). ``direction`` is unnormalized;
        ``depth``, ``ts`` and ``deltas`` come back divided by its norm.
        ``geo_only`` samples only the density channel; ``rgb`` is then
        (R, 0) and ``sem`` omitted. ``train`` jitters the samples and draws
        the random background (from ``draws`` or ``generator``); the eval
        render falls back to a white background, as the JAX head does
        without a key. ``outputs``: the keys the caller reads (None: all);
        the colour and semantic composites are skipped when not asked for."""
        def want(key):
            return outputs is None or key in outputs

        direction = direction.float()
        origin = origin.float()
        draws = draws or {}
        dnorm = torch.linalg.norm(direction, dim=-1, keepdim=True)
        unit = direction / dnorm
        near, far = neus.ray_aabb_near_far(origin, unit, self.roi_aabb,
                                           self.near_plane, self.far_plane)
        R, S = origin.shape[0], self.num_samples
        t_rand = None
        if train:
            t_rand = draws.get("t_rand")
            if t_rand is None:
                t_rand = torch.rand((R, S + 1), generator=generator,
                                    device=origin.device)
        segs = neus.sample_uniform(near, far, S, t_rand)
        mids = segs.mids
        pos = origin[:, None, :] + unit[:, None, :] * mids[..., None]
        geo = self.field.query_geo(first_channel(volume) if geo_only
                                   else volume, pos)
        sigma = F.softplus(geo["sdf"])                       # bev_nerf.py:117
        alpha = 1.0 - torch.exp(-sigma * segs.deltas)
        weights = weights_from_alpha(alpha)
        opacity = weights.sum(-1)
        depth = neus.composite(weights, mids[..., None])[..., 0]
        # nerfacc: depth normalized by the opacity (rendering.py:158)
        depth = depth / opacity.clamp_min(1e-10)
        out = {"weights": weights, "acc": opacity, "fars": far,
               "sigma": sigma, "depth": depth / dnorm[:, 0],
               "ts": mids / dnorm, "deltas": segs.deltas / dnorm}
        if self.color_dims > 0 and not geo_only and want("rgb"):
            rgb = neus.composite(weights, self.field.color(
                geo["color_feat"], unit[:, None, :]))
            mode = self.render_bkgd
            if mode == "random" and not train:
                mode = "white"
            bkgd = neus.background_color(mode, rgb.shape, rgb.device,
                                         generator, draws.get("bkgd"))
            out["rgb"] = rgb + bkgd * (1.0 - opacity)[..., None]
        elif want("rgb"):
            out["rgb"] = sigma.new_zeros(sigma.shape[:-1] + (0,))
        if (self.return_sem and self.sem_dims > 0 and not geo_only
                and want("sem")):
            out["sem"] = neus.composite(
                weights, torch.softmax(geo["sem_logits"], dim=-1))
        return out

    def forward(self, representation, img2lidar, train: bool = True,
                generator=None, draws: Optional[Dict[str, Any]] = None,
                global_iter=None):
        """Training forward (``density_head.py:149-181``): decode, sample
        the ray grid, render every camera's rays at once (no chunking, as in
        JAX) and return the loss inputs (``ms_depths``, ``ms_colors``,
        ``ms_accs``, ``ms_fars``, ``ms_rays``, ``weights``, ``ts``,
        ``deltas``, and ``sem`` with semantics). ``global_iter`` is taken
        and not read, as in the JAX head."""
        volume = self.field.decode(representation)[0]
        device = volume.device
        draws = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in (draws or {}).items()}
        sampler = self.ray_sampler if train else self.ray_sampler_eval
        rays = sampler(device, generator, draws.get(sampler.ray_sample_mode))
        origin, direction = rays_from_img2lidar(img2lidar, rays)
        bs, num_cams, num_rays = direction.shape[:3]
        if bs != 1:
            raise ValueError("the density head renders batch size 1")
        o = origin[:, :, None, :].expand(bs, num_cams, num_rays,
                                         3).reshape(-1, 3)
        d = direction.reshape(-1, 3)
        r = self.render_rays(volume, o, d, train=train, generator=generator,
                             draws=draws)

        def cams(x, extra=()):
            return x.reshape((bs, num_cams, num_rays) + tuple(extra))

        S = self.num_samples
        outputs = {
            "ms_depths": [cams(r["depth"])],
            "ms_colors": [cams(r["rgb"], (r["rgb"].shape[-1],))],
            "ms_accs": [cams(r["acc"])],
            "ms_fars": [cams(r["fars"])],
            "ms_rays": rays,
            "weights": cams(r["weights"], (S,)),
            "ts": cams(r["ts"], (S,)),
            "deltas": cams(r["deltas"], (S,)),
        }
        if self.return_sem and "sem" in r:
            outputs["sem"] = [cams(r["sem"], (self.sem_dims,))]
        return outputs
