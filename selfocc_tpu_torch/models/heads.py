"""NeuS rendering head — counterpart of
``selfocc_tpu/models/heads.py::NeuSHead``: ``prepare`` and
``render_rays`` for eval, and the training ``forward`` (``heads.py:397-526``)
with its chunked, checkpointed render.

The field sits at ``head.model.field`` so its state-dict keys are the
reference's (``head.model.field.*``, the sdfstudio wrapper's naming).
The NeuS weights always go through ``ops.render_weights.weights_from_alpha``
and the volume queries through ``ops.interp``: the hand-written kernels for
CUDA tensors, their plain versions on the CPU.

Randomness: the JAX head splits a PRNG key for the cellular ray grid, the
stratified jitter and the random background. Here those come from an
explicit ``torch.Generator``, or from a ``draws`` dict that fixes them
(``cellular`` (4,), ``t_rand`` (R, S + 1), ``bkgd`` (R, 3)), which is how the
parity tests hand the JAX draws to the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..geometry.projection import rays_from_img2lidar
from ..geometry.ray_sampler import RaySampler
from ..ops.interp import first_channel
from ..ops.render_weights import weights_from_alpha
from . import neus
from .field import TPVSDFField


class _FieldHolder(nn.Module):
    """The reference head's ``model`` (its sdfstudio NeuS model), which owns
    the field."""

    def __init__(self, field: TPVSDFField):
        super().__init__()
        self.field = field


class NeuSHead(nn.Module):
    """SDF head: decode the field, cast rays, NeuS-composite depth/RGB/sem."""

    def __init__(self, roi_aabb: Sequence[float], mapping_args: Dict[str, Any],
                 near_plane: float = 0.0, far_plane: float = 1e10,
                 num_samples: int = 256, beta_init: float = 0.1,
                 return_sem: bool = False, render_bkgd: str = "white",
                 embed_dims: int = 96, color_dims: int = 0,
                 sem_dims: int = 0, density_layers: int = 2, sh_deg: int = 0,
                 sh_act: str = "relu", return_second_grad: bool = False,
                 use_compact_2nd_grad: bool = False,
                 numerical_gradients_delta: float = 0.01,
                 ray_sample_mode: str = "fixed",
                 ray_number: Sequence[int] = (192, 400),
                 ray_img_size: Sequence[int] = (768, 1600),
                 ray_upper_crop: int = 0,
                 ray_x_dsr_max: Optional[float] = None,
                 ray_y_dsr_max: Optional[float] = None,
                 train_ray_chunk: int = 0):
        super().__init__()
        self.roi_aabb = tuple(roi_aabb)
        self.near_plane, self.far_plane = near_plane, far_plane
        self.num_samples = num_samples
        self.return_sem = return_sem
        self.render_bkgd = render_bkgd
        self.color_dims, self.sem_dims = color_dims, sem_dims
        self.return_second_grad = return_second_grad
        self.use_compact_2nd_grad = use_compact_2nd_grad
        self.numerical_gradients_delta = numerical_gradients_delta
        self.train_ray_chunk = train_ray_chunk
        self.ray_sampler = RaySampler(
            ray_sample_mode=ray_sample_mode, ray_number=tuple(ray_number),
            ray_img_size=tuple(ray_img_size), ray_upper_crop=ray_upper_crop,
            ray_x_dsr_max=ray_x_dsr_max, ray_y_dsr_max=ray_y_dsr_max)
        self.ray_sampler_eval = RaySampler(
            ray_sample_mode="fixed", ray_number=tuple(ray_number),
            ray_img_size=tuple(ray_img_size), ray_upper_crop=ray_upper_crop)
        self.model = _FieldHolder(TPVSDFField(
            mapping_args=mapping_args, embed_dims=embed_dims,
            color_dims=color_dims, sem_dims=sem_dims,
            density_layers=density_layers, sh_deg=sh_deg, sh_act=sh_act,
            beta_init=beta_init))

    @property
    def field(self) -> TPVSDFField:
        return self.model.field

    def prepare(self, representation) -> torch.Tensor:
        """Decode the field volume once: (C, H, W, D) for bs = 1."""
        return self.field.decode(representation)[0]

    def render_rays(self, volume, origin, direction, geo_only: bool = False,
                    train: bool = False, generator=None,
                    draws: Optional[Dict[str, torch.Tensor]] = None,
                    inv_s=None):
        """Render (R,) rays against a decoded (C, H, W, D) volume.

        ``direction`` is unnormalized; ``depth``, ``ts`` and ``deltas`` come
        back divided by its norm (camera z-depth, the reference's post-8.16
        behaviour). ``geo_only`` samples only the sdf channel; ``rgb`` is
        then (R, 0) and ``sem`` is omitted. ``train`` jitters the samples and
        draws the random background (from ``draws`` or ``generator``) and
        adds ``second_grad`` and ``normal_vis``; the eval render draws
        nothing, and a random background falls back to white there, as in
        the JAX head without a key."""
        direction = direction.float()
        origin = origin.float()
        draws = draws or {}
        direction_norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
        unit_dir = direction / direction_norm
        near, far = neus.ray_aabb_near_far(origin, unit_dir, self.roi_aabb,
                                           self.near_plane, self.far_plane)
        R, S = origin.shape[0], self.num_samples
        t_rand = None
        if train:
            t_rand = draws.get("t_rand")
            if t_rand is None:
                t_rand = torch.rand((R, S + 1), generator=generator,
                                    device=origin.device)
        segs = neus.sample_uniform(near, far, S, t_rand)
        mids, deltas = segs.mids, segs.deltas                 # (R, S)
        positions = origin[:, None, :] + unit_dir[:, None, :] * mids[..., None]

        qvol = first_channel(volume) if geo_only else volume
        geo, grad = self.field.query_geo_grad(qvol, positions)
        sdf = geo["sdf"]
        if inv_s is None:
            inv_s = self.field.inv_s()
        alpha = neus.neus_alpha(sdf, grad, unit_dir, deltas, inv_s)
        weights = weights_from_alpha(alpha)
        acc = weights.sum(-1)
        out = {"weights": weights, "acc": acc, "fars": far, "inv_s": inv_s,
               "sdf": sdf, "eik_grad": grad}
        depth = neus.composite(weights, mids[..., None])[..., 0]
        out["depth"] = depth / direction_norm[:, 0]
        out["ts"] = mids / direction_norm
        out["deltas"] = deltas / direction_norm

        if self.color_dims > 0 and not geo_only:
            rgb = neus.composite(weights, self.field.color(
                geo["color_feat"], unit_dir[:, None, :]))
            mode = self.render_bkgd
            if mode == "random" and not train:
                mode = "white"
            bkgd = neus.background_color(mode, rgb.shape, rgb.device,
                                         generator, draws.get("bkgd"))
            out["rgb"] = rgb + bkgd * (1.0 - acc)[..., None]
        else:
            out["rgb"] = sdf.new_zeros(sdf.shape[:-1] + (0,))
        if self.return_sem and self.sem_dims > 0 and not geo_only:
            out["sem"] = neus.composite(
                weights, torch.softmax(geo["sem_logits"], dim=-1))
        if train:
            norm = grad / torch.linalg.norm(grad, dim=-1,
                                            keepdim=True).clamp_min(1e-6)
            out["normal_vis"] = neus.composite(weights, (norm + 1.0) / 2.0)
            if self.return_second_grad and not geo_only:
                delta = self.numerical_gradients_delta
                if self.use_compact_2nd_grad:
                    out["second_grad"] = self.field.second_grad(
                        volume, positions, delta, center=sdf)
                else:
                    out["second_grad"] = self.field.second_grad_noncompact(
                        volume, positions, delta)
        return out

    def _train_draws(self, R: int, device, generator, draws):
        """The jitter and background uniforms of R rays, drawn up front so
        that a checkpointed chunk recomputes with the same numbers."""
        out = {}
        if "t_rand" in draws:
            out["t_rand"] = draws["t_rand"]
        else:
            out["t_rand"] = torch.rand((R, self.num_samples + 1),
                                       generator=generator, device=device)
        if self.color_dims > 0 and self.render_bkgd == "random":
            out["bkgd"] = (draws["bkgd"] if "bkgd" in draws else
                           torch.rand((R, 3), generator=generator,
                                      device=device))
        return out

    def forward(self, representation, img2lidar, train: bool = True,
                generator=None, draws: Optional[Dict[str, Any]] = None):
        """Training forward (``heads.py:397-526``): decode, sample the
        cellular ray grid, render every camera's rays (in checkpointed chunks
        of ``train_ray_chunk`` rays when that is smaller than the ray count,
        as the JAX head uses ``jax.checkpoint``) and return the loss inputs
        (``ms_depths``, ``ms_colors``, ``weights``, ``ts``, ``eik_grad``,
        ``second_grad``, ``sem``, ...). ``img2lidar`` (1, N, 4, 4) is the
        caller's ``trans_kw`` matrix."""
        volume = self.field.decode(representation)[0]
        device = volume.device
        draws = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in (draws or {}).items()}
        sampler = self.ray_sampler if train else self.ray_sampler_eval
        rays = sampler(device, generator, draws.get("cellular"))
        origin, direction = rays_from_img2lidar(img2lidar, rays)
        bs, num_cams, num_rays = direction.shape[:3]
        if bs != 1:
            raise ValueError("the NeuS head renders batch size 1")
        origin_flat = origin[:, :, None, :].expand(
            bs, num_cams, num_rays, 3).reshape(-1, 3)
        dir_flat = direction.reshape(-1, 3)
        R_tot = origin_flat.shape[0]
        chunk = self.train_ray_chunk
        if train and chunk and chunk < R_tot:
            inv_s = self.field.inv_s()
            pad = (-R_tot) % chunk
            o = F.pad(origin_flat, (0, 0, 0, pad))
            d = F.pad(dir_flat, (0, 0, 0, pad), value=1.0)
            rd = {k: F.pad(v, (0, 0, 0, pad)) for k, v in self._train_draws(
                R_tot, device, generator, draws).items()}
            parts = []
            for i in range((R_tot + pad) // chunk):
                sl = slice(i * chunk, (i + 1) * chunk)
                parts.append(checkpoint(
                    self._render_chunk, volume, o[sl], d[sl], inv_s,
                    {k: v[sl] for k, v in rd.items()}, use_reentrant=False))
            r = {k: parts[0][k] if parts[0][k].dim() == 0 else
                 torch.cat([p[k] for p in parts])[:R_tot] for k in parts[0]}
        else:
            if train:
                draws.update(self._train_draws(R_tot, device, generator,
                                               draws))
            r = self.render_rays(volume, origin_flat, dir_flat, train=train,
                                 generator=generator, draws=draws)

        def cams(x, extra=()):
            return x.reshape((bs, num_cams, num_rays) + tuple(extra))

        S = r["weights"].shape[-1]
        outputs = {
            "ms_depths": [cams(r["depth"])],
            "ms_colors": [cams(r["rgb"], (r["rgb"].shape[-1],))],
            "ms_accs": [cams(r["acc"])],
            "ms_fars": [cams(r["fars"])],
            "ms_rays": rays,
            "weights": cams(r["weights"], (S,)),
            "ts": cams(r["ts"], (S,)),
            "deltas": cams(r["deltas"], (S,)),
            "eik_grad": r["eik_grad"].reshape(-1, 3),
            "inv_s": r["inv_s"],
        }
        if "normal_vis" in r:
            outputs["vis_normal"] = [cams(r["normal_vis"], (3,))]
        if self.return_sem and "sem" in r:
            outputs["sem"] = [cams(r["sem"], (self.sem_dims,))]
        if "second_grad" in r:
            outputs["second_grad"] = r["second_grad"].reshape(-1, 3)
        return outputs

    def _render_chunk(self, volume, origin, direction, inv_s, draws):
        r = self.render_rays(volume, origin, direction, train=True,
                             draws=draws, inv_s=inv_s)
        r.pop("sdf")
        return r
