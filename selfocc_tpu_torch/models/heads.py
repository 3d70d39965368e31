"""NeuS rendering head — counterpart of
``selfocc_tpu/models/heads.py::NeuSHead``: ``prepare`` and
``render_rays`` for eval (with ``return_max_depth``, the argmax-weight
depth ``max_depth``), the training ``forward`` (``heads.py:397-526``)
with its chunked, checkpointed render, and the occupancy queries
(``get_uniform_sdf``, ``forward_occ``, ``occ_from_volume``,
``occ_uniform``; ``heads.py:528-577``).

The field sits at ``head.model.field`` so its state-dict keys are the
reference's (``head.model.field.*``, the sdfstudio wrapper's naming).
The NeuS render of the samples (alpha, weights, depth and normal
composites) goes through ``ops.render_weights.neus_composite`` and the
volume queries through ``ops.interp``: the hand-written kernels for CUDA
tensors, their plain versions on the CPU.

Randomness: the JAX head splits a PRNG key for the cellular ray grid, the
stratified jitter and the random background. Here those come from an
explicit ``torch.Generator``, or from a ``draws`` dict that fixes them
(``cellular`` (4,), ``t_rand`` (R, S + 1), ``bkgd`` (R, 3)), which is how the
parity tests hand the JAX draws to the port.
"""
from __future__ import annotations

import functools
from typing import Any, Collection, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..geometry.projection import rays_from_img2lidar
from ..geometry.ray_sampler import RaySampler
from ..ops.interp import first_channel
from ..ops.render_weights import neus_composite
from . import neus
from .field import TPVSDFField


def uniform_axes(aabb: Sequence[float], resolution: float):
    """The uniform occupancy grid's metric axes ``xs``, ``ys``, ``zs`` over
    ``aabb`` at ``resolution`` (``heads.py:531-533``,
    ``eval_lib.py:311-319``), as fp32 numpy arrays. JAX builds them with an
    fp32 ``jnp.linspace``, whose bits differ between its eager and jitted
    forms and which rounds at the scale of the endpoints; here they are
    computed in float64 and rounded once, which puts each value within 1
    ulp of the larger endpoint of JAX's eager axes. ``get_uniform_sdf`` and
    the evaluator share this function."""
    return tuple(np.linspace(aabb[i], aabb[i + 3],
                             int((aabb[i + 3] - aabb[i]) / resolution)
                             ).astype(np.float32) for i in range(3))


@functools.lru_cache(maxsize=16)
def uniform_axes_on(aabb: tuple, resolution: float, device: torch.device):
    """``uniform_axes`` as tensors on ``device``, copied there once per
    (aabb, resolution, device): a per-call host-to-device copy would
    synchronise the stream."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in uniform_axes(aabb, resolution))


def uniform_grid(xs, ys, zs) -> torch.Tensor:
    """(H, W, D, 3) metric (x, y, z) points of the grid ``ys`` x ``xs`` x
    ``zs`` (h <- y, w <- x, d <- z)."""
    Y, X, Z = torch.meshgrid(ys, xs, zs, indexing="ij")
    return torch.stack([X, Y, Z], dim=-1)


def max_depth(weights: torch.Tensor, ts: torch.Tensor,
              deltas: torch.Tensor) -> torch.Tensor:
    """The argmax-weight depth (JAX ``heads.py:379-386``, the reference's
    ``neus_head.py:579-587``): among the samples with ``deltas >= eps``,
    the one of largest ``weights / deltas`` (the first on ties), its
    ``ts``. (R, S) each -> (R,)."""
    eps = torch.finfo(torch.float32).eps
    w = torch.where(deltas < eps, torch.zeros_like(weights), weights)
    idx = torch.argmax(w / deltas.clamp_min(eps), dim=-1, keepdim=True)
    return torch.gather(ts, -1, idx)[..., 0]


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
                 train_ray_chunk: int = 0, resolution: float = 0.4,
                 return_max_depth: bool = False):
        super().__init__()
        self.roi_aabb = tuple(roi_aabb)
        self.resolution = resolution
        self.near_plane, self.far_plane = near_plane, far_plane
        self.num_samples = num_samples
        self.return_sem = return_sem
        self.render_bkgd = render_bkgd
        self.color_dims, self.sem_dims = color_dims, sem_dims
        self.return_second_grad = return_second_grad
        self.use_compact_2nd_grad = use_compact_2nd_grad
        self.numerical_gradients_delta = numerical_gradients_delta
        self.train_ray_chunk = train_ray_chunk
        self.return_max_depth = return_max_depth
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
                    inv_s=None, outputs: Optional[Collection[str]] = None):
        """Render (R,) rays against a decoded (C, H, W, D) volume.

        ``direction`` is unnormalized; ``depth``, ``ts`` and ``deltas`` come
        back divided by its norm (camera z-depth, the reference's post-8.16
        behaviour). ``geo_only`` samples only the sdf channel; ``rgb`` is
        then (R, 0) and ``sem`` is omitted. ``train`` jitters the samples and
        draws the random background (from ``draws`` or ``generator``); the
        eval render draws nothing, and a random background falls back to
        white there, as in the JAX head without a key. ``normal_vis`` and
        (with ``return_second_grad``, not ``geo_only``) ``second_grad`` come
        with every call, as in the JAX head.

        ``outputs``: the keys the caller reads (None: every key the JAX head
        returns). The JAX ``ChunkedRenderer`` returns only its outputs from
        the jit and XLA drops the rest; eager PyTorch skips them here: the
        colour and semantic composites, ``second_grad``, and on the card the
        weights and ``ts`` / ``deltas`` writes of the fused render. Keys
        computed anyway may come back too."""
        def want(*keys):
            return outputs is None or any(k in outputs for k in keys)

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
        positions = origin[:, None, :] + unit_dir[:, None, :] * \
            segs.mids[..., None]

        qvol = first_channel(volume) if geo_only else volume
        geo, grad = self.field.query_geo_grad(qvol, positions)
        sdf = geo["sdf"]
        if inv_s is None:
            inv_s = self.field.inv_s()
        rgb_wanted = self.color_dims > 0 and not geo_only and want("rgb")
        sem_wanted = (self.return_sem and self.sem_dims > 0 and not geo_only
                      and want("sem"))
        max_wanted = self.return_max_depth and want("max_depth")
        weights, acc, depth, normal_vis, ts, deltas = neus_composite(
            sdf, grad, unit_dir, segs.edges, direction_norm, inv_s,
            weights=want("weights") or rgb_wanted or sem_wanted or max_wanted,
            geometry=want("ts", "deltas") or max_wanted)
        out = {"acc": acc, "fars": far, "inv_s": inv_s, "sdf": sdf,
               "eik_grad": grad, "depth": depth, "normal_vis": normal_vis}
        if want("weights"):
            out["weights"] = weights
        if want("ts", "deltas"):
            out["ts"], out["deltas"] = ts, deltas
        if max_wanted:
            out["max_depth"] = max_depth(weights, ts, deltas)

        if rgb_wanted:
            rgb = neus.composite(weights, self.field.color(
                geo["color_feat"], unit_dir[:, None, :]))
            mode = self.render_bkgd
            if mode == "random" and not train:
                mode = "white"
            bkgd = neus.background_color(mode, rgb.shape, rgb.device,
                                         generator, draws.get("bkgd"))
            out["rgb"] = rgb + bkgd * (1.0 - acc)[..., None]
        elif want("rgb"):
            out["rgb"] = sdf.new_zeros(sdf.shape[:-1] + (0,))
        if sem_wanted:
            out["sem"] = neus.composite(
                weights, torch.softmax(geo["sem_logits"], dim=-1))
        if self.return_second_grad and not geo_only and want("second_grad"):
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
        if "max_depth" in r:
            outputs["ms_max_depths"] = [cams(r["max_depth"])]
        return outputs

    def get_uniform_sdf(self, volume, aabb, resolution, generator=None,
                        shift: Optional[torch.Tensor] = None):
        """The sdf and sem logits on the uniform metric grid over ``aabb``
        (``heads.py:528-542``) -> (sdf (H, W, D), sem_logits (H, W, D,
        sem_dims), xyz (H, W, D, 3)). The points are jittered by ``shift``
        (H, W, D, 3) uniforms times ``resolution`` when given (the parity
        tests hand over the JAX draw), else by uniforms from ``generator``
        when one is given, else not at all."""
        xs, ys, zs = uniform_axes_on(tuple(aabb), resolution, volume.device)
        xyz = uniform_grid(xs, ys, zs)
        if shift is None and generator is not None:
            shift = torch.rand(xyz.shape, generator=generator,
                               device=xyz.device)
        if shift is not None:
            xyz = xyz + shift * resolution
        geo = self.field.query_geo(volume, xyz)
        return geo["sdf"], geo["sem_logits"], xyz

    def _occ(self, geo, outputs):
        out = {"sdf": geo["sdf"]}
        if self._occ_sem(outputs):
            out["sem"] = torch.argmax(geo["sem_logits"], dim=-1)
            out["logits"] = geo["sem_logits"]
        return out

    def _occ_sem(self, outputs):
        return (self.return_sem and self.sem_dims > 0 and
                (outputs is None or bool({"sem", "logits"} & set(outputs))))

    @torch.no_grad()
    def forward_occ(self, representation, aabb=None, resolution=None):
        """Occupancy eval (``heads.py:543-554``): decode, then the uniform
        grid's sdf, ``xyz`` and, with semantics, the logits and their
        argmax ``sem``."""
        volume = self.field.decode(representation)[0]
        aabb = self.roi_aabb if aabb is None else aabb
        resolution = self.resolution if resolution is None else resolution
        sdf, sem_logits, xyz = self.get_uniform_sdf(volume, aabb, resolution)
        return dict(self._occ({"sdf": sdf, "sem_logits": sem_logits}, None),
                    xyz=xyz)

    @torch.no_grad()
    def occ_from_volume(self, volume, xyz,
                        outputs: Optional[Collection[str]] = None):
        """``forward_occ``'s query against a decoded (C, H, W, D) volume at
        metric points (..., 3) (``heads.py:556-566``). ``outputs``: the keys
        the caller reads (None: all); without ``sem`` or ``logits`` only
        the sdf plane is sampled, which computes the same sdf."""
        sem = self._occ_sem(outputs)
        return self._occ(self.field.query_geo(
            volume if sem else first_channel(volume), xyz), outputs)

    @torch.no_grad()
    def occ_uniform(self, volume, xs, ys, zs,
                    outputs: Optional[Collection[str]] = None):
        """``occ_from_volume`` on the separable grid ``ys`` x ``xs`` x
        ``zs`` through the per-axis query (``heads.py:568-577``,
        ``eval_iou --grid-query separable``) -> (H, W, D[, C]) outputs."""
        sem = self._occ_sem(outputs)
        return self._occ(self.field.query_geo_uniform(
            volume if sem else first_channel(volume), xs, ys, zs), outputs)

    def _render_chunk(self, volume, origin, direction, inv_s, draws):
        r = self.render_rays(volume, origin, direction, train=True,
                             draws=draws, inv_s=inv_s)
        r.pop("sdf")
        return r
