"""NeuS rendering head, eval branch — counterpart of
``selfocc_tpu/models/heads.py::NeuSHead`` (``prepare`` and
``render_rays(train=False)``).

The field sits at ``head.model.field`` so its state-dict keys are the
reference's (``head.model.field.*``, the sdfstudio wrapper's naming).
The NeuS weights always go through ``ops.render_weights.weights_from_alpha``:
the hand-written kernel for CUDA tensors, its plain version on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

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
                 sh_act: str = "relu"):
        super().__init__()
        self.roi_aabb = tuple(roi_aabb)
        self.near_plane, self.far_plane = near_plane, far_plane
        self.num_samples = num_samples
        self.return_sem = return_sem
        # the eval render draws no random numbers: a 'random' background
        # falls back to white, as in the JAX head without an rng
        self.render_bkgd = "white" if render_bkgd == "random" else render_bkgd
        self.color_dims, self.sem_dims = color_dims, sem_dims
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

    def render_rays(self, volume, origin, direction, geo_only: bool = False):
        """Render (R,) rays against a decoded (C, H, W, D) volume.

        ``direction`` is unnormalized; ``depth``, ``ts`` and ``deltas`` come
        back divided by its norm (camera z-depth, the reference's post-8.16
        behaviour). ``geo_only`` samples only the sdf channel; ``rgb`` is
        then (R, 0) and ``sem`` is omitted."""
        direction = direction.float()
        origin = origin.float()
        direction_norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
        unit_dir = direction / direction_norm
        near, far = neus.ray_aabb_near_far(origin, unit_dir, self.roi_aabb,
                                           self.near_plane, self.far_plane)
        segs = neus.sample_uniform(near, far, self.num_samples)
        mids, deltas = segs.mids, segs.deltas                 # (R, S)
        positions = origin[:, None, :] + unit_dir[:, None, :] * mids[..., None]

        qvol = volume[:1] if geo_only else volume
        geo, grad = self.field.query_geo_grad(qvol, positions)
        sdf = geo["sdf"]
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
            bkgd = neus.background_color(self.render_bkgd, rgb.shape,
                                         rgb.device)
            out["rgb"] = rgb + bkgd * (1.0 - acc)[..., None]
        else:
            out["rgb"] = sdf.new_zeros(sdf.shape[:-1] + (0,))
        if self.return_sem and self.sem_dims > 0 and not geo_only:
            out["sem"] = neus.composite(
                weights, torch.softmax(geo["sem_logits"], dim=-1))
        return out
