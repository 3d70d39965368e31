"""NeuS rendering head — counterpart of
``selfocc_tpu/models/heads.py::NeuSHead``: ``prepare`` and
``render_rays`` for eval (with ``return_max_depth``, the argmax-weight
depth ``max_depth``), the training ``forward`` (``heads.py:397-526``)
with its chunked, checkpointed render, and the occupancy queries
(``get_uniform_sdf``, ``forward_occ``, ``occ_from_volume``,
``occ_uniform``; ``heads.py:528-577``); ``return_uniform_sdf`` puts the
uniform grid's sdf among the training outputs. Every branch of the JAX
``render_rays`` is here: the NeuS importance rounds
(``num_samples_importance``), eval-time empty-space skipping
(``eval_skip_coarse`` / ``eval_skip_fine``), AABB annealing
(``anneal_aabb``), the hand-tuned inv_s schedule (``beta_hand_tune``),
central-difference sdf gradients (``use_numerical_gradients``), the
``surface_sdf`` and ``sample_sdf`` outputs and ``two_split``, and the BEV
flow head (``estimate_flow``, ``FlowNet``; ``heads.py:44-67, 412-431,
507-523``): given the neighbouring frames' BEV planes (``prev_rep`` /
``next_rep``) the training forward predicts four flow volumes and warps
the ray samples by two of them. No segmentor path passes neighbours and no
loss reads the flows, as in the JAX package; the head's forward takes
them. The flow lookup at the samples is one values-only query with
``"border"`` padding (on the card ``trilinear_cf_fwd`` / ``trilinear_cf_bwd``
at C = 3, their narrow instances, which clip the points themselves).

The field sits at ``head.model.field`` so its state-dict keys are the
reference's (``head.model.field.*``, the sdfstudio wrapper's naming).
The NeuS render of uniform samples (alpha, weights, depth and normal
composites) goes through the fused ``ops.render_weights.neus_composite``,
which takes bin edges. The importance and skip branches place sorted
samples that no edges express; they take the alpha-input route, as the
JAX head does: ``neus.neus_alpha`` in torch, ``weights_from_alpha`` (the
``neus_weights_fwd`` / ``neus_weights_bwd`` kernels on the card) and the
composites in torch, so that the gradient reaches the sample positions.
The volume queries go through ``ops.interp``: the hand-written kernels for
CUDA tensors, their plain versions on the CPU.

Randomness: the JAX head splits a PRNG key for the cellular ray grid, the
stratified jitter, the random background and the uniform sdf grid's
jitter. Here those come from an explicit ``torch.Generator``, or from a
``draws`` dict that fixes them (``cellular`` (4,) or ``random`` (R, 2) by
the sampler's mode, ``t_rand`` (R, S + 1), ``bkgd`` (R, 3),
``uniform_shift`` (H, W, D, 3)), which is how the parity tests hand the
JAX draws to the port.
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
from ..ops.interp import first_channel, trilinear_sample
from ..ops.render_weights import neus_composite, weights_from_alpha
from . import neus
from .field import TPVSDFField
from .initializers import normal_
from .resnet import BatchNorm2d


def beta_schedule(beta_init: float, beta_max: float, total_iters: int,
                  it) -> float:
    """The hand-tuned inv_s of iteration ``it`` (``heads.py:35-41``): beta
    goes linearly from ``beta_init`` to ``beta_max`` over ``total_iters``,
    inv_s = 1 / beta; in float32, as JAX computes it from the traced step."""
    f32 = np.float32
    frac = np.clip(f32(it) / f32(total_iters), f32(0), f32(1))
    return float(f32(1) / (f32(beta_init) + f32(beta_max - beta_init) * frac))


def annealed_band(it, every: int, total_iters: int, near_plane: float,
                  min_near: float, min_far_frac: float):
    """The AABB annealing's scalars at iteration ``it`` (``heads.py:226-
    240``): the progress ``p``, quantised to ``every`` iterations, the near
    clamp and the fraction of the band kept, in float32."""
    f32 = np.float32
    p = np.clip(np.floor(f32(it) / f32(every)) * f32(every) / f32(total_iters),
                f32(0), f32(1))
    near_clamp = f32(min_near) + p * f32(near_plane - min_near)
    far_frac = f32(min_far_frac) + p * f32(1.0 - min_far_frac)
    return float(near_clamp), float(far_frac)


def split_cams_for_losses(outputs, num_cams):
    """``two_split`` (``heads.py:580-594``): the first half of the cameras
    keeps the depth-supervised outputs, the second half the colour and
    semantic ones."""
    half = num_cams // 2
    out = dict(outputs)
    for k in ("ms_depths", "ms_accs", "ms_fars", "ms_max_depths"):
        if k in out:
            out[k] = [x[:, :half] for x in out[k]]
    for k in ("ms_colors", "sem"):
        if k in out:
            out[k] = [x[:, half:] for x in out[k]]
    for k in ("weights", "ts", "deltas", "sample_sdf", "surface_sdf"):
        if k in out:
            out[k] = out[k][:, :half]
    return out


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


class OccupancyQueries:
    """The occupancy queries of both heads (``heads.py:543-577``,
    ``density_head.py:183-218``): ``forward_occ``, ``occ_from_volume`` and
    ``occ_uniform`` return the field's channel 0 through ``occ_value``
    under the key ``sdf`` (the sdf of the NeuS head, the density of the
    density head) and, with semantics, the logits and their argmax
    ``sem``. The head provides ``field``, ``roi_aabb``, ``resolution``,
    ``return_sem`` and ``sem_dims``."""

    @staticmethod
    def occ_value(sdf):
        return sdf

    def _occ_sem(self, outputs):
        return (self.return_sem and self.sem_dims > 0 and
                (outputs is None or bool({"sem", "logits"} & set(outputs))))

    def _occ(self, geo, outputs):
        out = {"sdf": self.occ_value(geo["sdf"])}
        if self._occ_sem(outputs):
            out["sem"] = torch.argmax(geo["sem_logits"], dim=-1)
            out["logits"] = geo["sem_logits"]
        return out

    @torch.no_grad()
    def forward_occ(self, representation, aabb=None, resolution=None):
        """Occupancy eval: decode, then the uniform grid over ``aabb`` at
        ``resolution`` (the head's by default): its values, ``xyz`` and,
        with semantics, the logits and their argmax ``sem``."""
        volume = self.field.decode(representation)[0]
        aabb = self.roi_aabb if aabb is None else aabb
        resolution = self.resolution if resolution is None else resolution
        xs, ys, zs = uniform_axes_on(tuple(aabb), resolution, volume.device)
        xyz = uniform_grid(xs, ys, zs)
        return dict(self._occ(self.field.query_geo(volume, xyz), None),
                    xyz=xyz)

    @torch.no_grad()
    def occ_from_volume(self, volume, xyz,
                        outputs: Optional[Collection[str]] = None):
        """``forward_occ``'s query against a decoded (C, H, W, D) volume at
        metric points (..., 3). ``outputs``: the keys the caller reads
        (None: all); without ``sem`` or ``logits`` only the sdf plane is
        sampled, which computes the same values."""
        sem = self._occ_sem(outputs)
        return self._occ(self.field.query_geo(
            volume if sem else first_channel(volume), xyz), outputs)

    @torch.no_grad()
    def occ_uniform(self, volume, xs, ys, zs,
                    outputs: Optional[Collection[str]] = None):
        """``occ_from_volume`` on the separable grid ``ys`` x ``xs`` x
        ``zs`` through the per-axis query (``eval_iou --grid-query
        separable``) -> (H, W, D[, C]) outputs."""
        sem = self._occ_sem(outputs)
        return self._occ(self.field.query_geo_uniform(
            volume if sem else first_channel(volume), xs, ys, zs), outputs)


class FlowNet(nn.Sequential):
    """BEV flow head (``heads.py:44-67``, reference ``neus_head.py:215-235``
    Sequential, whose keys ``head.flow_net.{0,1,3,4,6}`` these are): two
    3x3 convs without bias, each with flax's BatchNorm (momentum 0.99) and
    a ReLU, then a 1x1 conv to ``z_size * 3`` channels (normal(1e-2)
    weights). (B, H, W, 2C) channel-last -> (B, H, W, z_size, 3)."""

    def __init__(self, embed_dims: int, z_size: int):
        super().__init__(
            nn.Conv2d(2 * embed_dims, embed_dims, 3, padding=1, bias=False),
            BatchNorm2d(embed_dims, momentum=0.99), nn.ReLU(),
            nn.Conv2d(embed_dims, embed_dims, 3, padding=1, bias=False),
            BatchNorm2d(embed_dims, momentum=0.99), nn.ReLU(),
            nn.Conv2d(embed_dims, z_size * 3, 1))
        self.z_size = z_size

    def reset_parameters_like_jax(self, generator):
        normal_(self[6].weight, 1e-2, generator)
        self[6].bias.data.zero_()

    def forward(self, x):
        B, H, W, _ = x.shape
        y = super().forward(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).reshape(B, H, W, self.z_size, 3)


def sample_border(vol: torch.Tensor, hwd: torch.Tensor) -> torch.Tensor:
    """A channel-last (H, W, D, C) volume at (..., 3) fractional indices
    with ``"border"`` padding, as the JAX head's lookup
    (``heads.py:519-520``): one values-only query, whose points are clipped
    to the volume and whose upper corners are clamped onto the face rows
    (``interp.py:131-150``)."""
    return trilinear_sample(vol, hwd, "border")


class _FieldHolder(nn.Module):
    """The reference head's ``model`` (its sdfstudio NeuS model), which owns
    the field."""

    def __init__(self, field: TPVSDFField):
        super().__init__()
        self.field = field


class NeuSHead(OccupancyQueries, nn.Module):
    """SDF head: decode the field, cast rays, NeuS-composite depth/RGB/sem.
    ``tpv``: the field decodes the three TPV planes, or (False) the BEV
    plane (``heads.py:157``). The other arguments are the JAX head's
    fields; with ``beta_hand_tune`` the field has no learned variance (the
    JAX head never makes that parameter then)."""

    def __init__(self, roi_aabb: Sequence[float], mapping_args: Dict[str, Any],
                 near_plane: float = 0.0, far_plane: float = 1e10,
                 num_samples: int = 256, beta_init: float = 0.1,
                 beta_max: float = 0.195, total_iters: int = 3516 * 11,
                 beta_hand_tune: bool = False,
                 use_numerical_gradients: bool = False,
                 return_sem: bool = False, render_bkgd: str = "white",
                 embed_dims: int = 96, color_dims: int = 0,
                 sem_dims: int = 0, density_layers: int = 2, sh_deg: int = 0,
                 sh_act: str = "relu", return_second_grad: bool = False,
                 use_compact_2nd_grad: bool = False,
                 numerical_gradients_delta: float = 0.01,
                 anneal_aabb: bool = False, aabb_every_iters: int = 3516,
                 aabb_min_near: float = 10.0, aabb_min_far_frac: float = 0.25,
                 base_variance: float = 64.0,
                 num_samples_importance: int = 0, num_upsample_steps: int = 4,
                 eval_skip_coarse: int = 0, eval_skip_fine: int = 0,
                 ray_sample_mode: str = "fixed",
                 ray_number: Sequence[int] = (192, 400),
                 ray_img_size: Sequence[int] = (768, 1600),
                 ray_upper_crop: int = 0,
                 ray_x_dsr_max: Optional[float] = None,
                 ray_y_dsr_max: Optional[float] = None,
                 train_ray_chunk: int = 0, resolution: float = 0.4,
                 return_max_depth: bool = False,
                 return_uniform_sdf: bool = False,
                 return_surface_sdf: bool = False,
                 return_sample_sdf: bool = False, two_split: bool = False,
                 tpv: bool = True, estimate_flow: bool = False):
        super().__init__()
        self.roi_aabb = tuple(roi_aabb)
        self.resolution = resolution
        self.near_plane, self.far_plane = near_plane, far_plane
        self.num_samples = num_samples
        self.beta_init, self.beta_max = beta_init, beta_max
        self.total_iters = total_iters
        self.beta_hand_tune = beta_hand_tune
        self.use_numerical_gradients = use_numerical_gradients
        self.return_sem = return_sem
        self.render_bkgd = render_bkgd
        self.color_dims, self.sem_dims = color_dims, sem_dims
        self.return_second_grad = return_second_grad
        self.use_compact_2nd_grad = use_compact_2nd_grad
        self.numerical_gradients_delta = numerical_gradients_delta
        self.anneal_aabb = anneal_aabb
        self.aabb_every_iters = aabb_every_iters
        self.aabb_min_near = aabb_min_near
        self.aabb_min_far_frac = aabb_min_far_frac
        self.base_variance = base_variance
        self.num_samples_importance = num_samples_importance
        self.num_upsample_steps = num_upsample_steps
        self.eval_skip_coarse, self.eval_skip_fine = (eval_skip_coarse,
                                                      eval_skip_fine)
        self.train_ray_chunk = train_ray_chunk
        self.return_max_depth = return_max_depth
        self.return_uniform_sdf = return_uniform_sdf
        self.return_surface_sdf = return_surface_sdf
        self.return_sample_sdf = return_sample_sdf
        self.two_split = two_split
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
            beta_init=beta_init, tpv=tpv, variance=not beta_hand_tune))
        self.embed_dims = embed_dims
        self.flow_net = FlowNet(embed_dims, self.field.mapping.size_d) \
            if estimate_flow else None

    @property
    def field(self) -> TPVSDFField:
        return self.model.field

    def prepare(self, representation) -> torch.Tensor:
        """Decode the field volume once: (C, H, W, D) for bs = 1."""
        return self.field.decode(representation)[0]

    def inv_s(self, global_iter=None, device=None):
        """The NeuS sharpness (``heads.py:189-194``): the field's learned
        one, or with ``beta_hand_tune`` the schedule's at ``global_iter``
        (iteration 0 when None: the eval paths pass none), a 0-dim fp32
        tensor on ``device`` made by a fill, not a copy from the host."""
        if not self.beta_hand_tune:
            return self.field.inv_s()
        it = 0 if global_iter is None else global_iter
        return torch.full((), beta_schedule(self.beta_init, self.beta_max,
                                            self.total_iters, it),
                          dtype=torch.float32, device=device)

    def _annealed(self, near, far, global_iter):
        near_clamp, far_frac = annealed_band(
            0 if global_iter is None else global_iter, self.aabb_every_iters,
            self.total_iters, self.near_plane, self.aabb_min_near,
            self.aabb_min_far_frac)
        ann_near = near.clamp_min(near_clamp)
        ann_far = near + far_frac * (far - near)
        # the band stays non-degenerate whatever the box intersection
        near = torch.minimum(ann_near, ann_far - 1e-3)
        far = torch.maximum(ann_far, near + 1e-3)
        return near, far

    def _skip_samples(self, volume, origin, unit_dir, near, far, inv_s):
        """The eval-time skip (``heads.py:245-270``): a coarse sdf-only
        query at ``eval_skip_coarse`` uniform samples, one up-sample round
        of ``eval_skip_fine`` positions at ``inv_s``, sorted."""
        ts_c = neus.sample_uniform(near, far, self.eval_skip_coarse).mids
        sdf_c = self.field.sdf(volume, origin[:, None, :] +
                               unit_dir[:, None, :] * ts_c[..., None])
        return torch.sort(neus.upsample_ts(ts_c, sdf_c, self.eval_skip_fine,
                                           inv_s), dim=-1, stable=True)[0]

    def _importance_samples(self, volume, origin, unit_dir, ts):
        """The NeuS up-sample rounds (``heads.py:276-295``):
        ``num_upsample_steps`` rounds of ``num_samples_importance // steps``
        positions at inv_s ``base_variance * 2**i``, each merged into the
        sorted set; differentiable in the volume and the positions."""
        n_per = max(self.num_samples_importance // self.num_upsample_steps, 1)
        for i in range(self.num_upsample_steps):
            sdf = self.field.sdf(volume, origin[:, None, :] +
                                 unit_dir[:, None, :] * ts[..., None])
            ts = neus.merge_ts(ts, neus.upsample_ts(
                ts, sdf, n_per, self.base_variance * 2 ** i))
        return ts

    def render_rays(self, volume, origin, direction, geo_only: bool = False,
                    train: bool = False, generator=None,
                    draws: Optional[Dict[str, torch.Tensor]] = None,
                    inv_s=None, outputs: Optional[Collection[str]] = None,
                    global_iter=None):
        """Render (R,) rays against a decoded (C, H, W, D) volume.

        ``direction`` is unnormalized; ``depth``, ``ts`` and ``deltas`` come
        back divided by its norm (camera z-depth, the reference's post-8.16
        behaviour). ``geo_only`` samples only the sdf channel; ``rgb`` is
        then (R, 0) and ``sem`` is omitted. ``train`` jitters the samples and
        draws the random background (from ``draws`` or ``generator``); the
        eval render draws nothing, and a random background falls back to
        white there, as in the JAX head without a key. ``normal_vis`` and
        (with ``return_second_grad``, not ``geo_only``) ``second_grad`` come
        with every call, as in the JAX head. ``global_iter``: the training
        step, read by ``anneal_aabb`` (training only) and ``beta_hand_tune``
        (None: iteration 0). With importance samples or eval skipping the
        per-ray sample count is theirs (S + Si, or ``eval_skip_fine``).

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
        if self.anneal_aabb and train:
            near, far = self._annealed(near, far, global_iter)
        if inv_s is None:
            inv_s = self.inv_s(global_iter, origin.device)
        R, S = origin.shape[0], self.num_samples
        edges = None
        if not train and self.eval_skip_coarse > 0 and self.eval_skip_fine > 0:
            mids = self._skip_samples(volume, origin, unit_dir, near, far,
                                      inv_s)
        else:
            t_rand = None
            if train:
                t_rand = draws.get("t_rand")
                if t_rand is None:
                    t_rand = torch.rand((R, S + 1), generator=generator,
                                        device=origin.device)
            segs = neus.sample_uniform(near, far, S, t_rand)
            mids, edges = segs.mids, segs.edges
        if self.num_samples_importance > 0 and mids.shape[-1] == S:
            mids = self._importance_samples(volume, origin, unit_dir, mids)
            edges = None
        positions = origin[:, None, :] + unit_dir[:, None, :] * \
            mids[..., None]

        qvol = first_channel(volume) if geo_only else volume
        if self.use_numerical_gradients:
            geo = self.field.query_geo(qvol, positions)
            grad = self.field.sdf_numerical_grad(
                volume, positions, self.numerical_gradients_delta)
        else:
            geo, grad = self.field.query_geo_grad(qvol, positions)
        sdf = geo["sdf"]
        rgb_wanted = self.color_dims > 0 and not geo_only and want("rgb")
        sem_wanted = (self.return_sem and self.sem_dims > 0 and not geo_only
                      and want("sem"))
        max_wanted = self.return_max_depth and want("max_depth")
        if edges is not None:
            weights, acc, depth, normal_vis, ts, deltas = neus_composite(
                sdf, grad, unit_dir, edges, direction_norm, inv_s,
                weights=(want("weights") or rgb_wanted or sem_wanted or
                         max_wanted),
                geometry=want("ts", "deltas") or max_wanted)
        else:
            weights, acc, depth, normal_vis, ts, deltas = self._composite(
                sdf, grad, unit_dir, mids, neus.section_deltas(mids, far),
                direction_norm, inv_s)
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
        if self.return_surface_sdf and want("surface_sdf"):
            # the JAX head scales its euclidean depth by |d| once more
            # (heads.py:376): copied as it is
            surf = origin + unit_dir * (depth * direction_norm[:, 0])[
                ..., None] * direction_norm
            out["surface_sdf"] = self.field.sdf(volume, surf)
        return out

    @staticmethod
    def _composite(sdf, grad, unit_dir, mids, deltas, direction_norm, inv_s):
        """The alpha-input render of sorted samples (``heads.py:315-366``):
        alpha, ``weights_from_alpha`` and the composites in torch;
        differentiable in every input. Returns ``neus_composite``'s six
        outputs."""
        alpha = neus.neus_alpha(sdf, grad, unit_dir, deltas, inv_s)
        weights = weights_from_alpha(alpha.contiguous())
        dn = direction_norm[:, 0]
        depth = neus.composite(weights, mids[..., None])[..., 0] / dn
        norm = grad / torch.linalg.norm(grad, dim=-1,
                                        keepdim=True).clamp_min(1e-6)
        normal_vis = neus.composite(weights, (norm + 1.0) / 2.0)
        return (weights, weights.sum(-1), depth, normal_vis,
                mids / direction_norm, deltas / direction_norm)

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

    def flows(self, representation, prev_rep, next_rep):
        """The four BEV flow volumes (``heads.py:412-431``), each (1, H, W,
        D, 3): FlowNet on the channel-concatenated (prev, curr),
        (next, curr), (curr, prev) and (curr, next) planes."""
        if isinstance(representation, (list, tuple)):
            raise ValueError("the flow head takes a BEV representation "
                             "(neus_head.py:489)")
        H, W = self.field.mapping.size_h, self.field.mapping.size_w
        curr, prev, nxt = (r.reshape(1, H, W, self.embed_dims)
                           for r in (representation, prev_rep, next_rep))
        return {"curr2prev_flow": self.flow_net(torch.cat([prev, curr], -1)),
                "curr2next_flow": self.flow_net(torch.cat([nxt, curr], -1)),
                "prev2curr_flow": self.flow_net(torch.cat([curr, prev], -1)),
                "next2curr_flow": self.flow_net(torch.cat([curr, nxt], -1))}

    def warped_samples(self, flows, origin, direction, ts):
        """The ray samples (R, S) at metric positions ``origin + unit *
        ts * |direction|`` moved by the curr2prev / curr2next flows looked
        up there (``heads.py:507-523``): ``prev_warp`` / ``next_warp``
        (R, S, 3)."""
        norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
        positions = origin[:, None, :] + (direction / norm)[:, None, :] * \
            (ts * norm)[..., None]
        grids = self.field.mapping.meter2grid(positions)
        return {tgt: positions + sample_border(flows[key][0], grids)
                for key, tgt in (("curr2prev_flow", "prev_warp"),
                                 ("curr2next_flow", "next_warp"))}

    def forward(self, representation, img2lidar, train: bool = True,
                generator=None, draws: Optional[Dict[str, Any]] = None,
                global_iter=None, prev_rep=None, next_rep=None):
        """Training forward (``heads.py:397-526``): decode, sample the
        cellular ray grid, render every camera's rays (in checkpointed chunks
        of ``train_ray_chunk`` rays when that is smaller than the ray count,
        as the JAX head uses ``jax.checkpoint``) and return the loss inputs
        (``ms_depths``, ``ms_colors``, ``weights``, ``ts``, ``eik_grad``,
        ``second_grad``, ``sem``, ...). ``img2lidar`` (1, N, 4, 4) is the
        caller's ``trans_kw`` matrix. With ``return_uniform_sdf`` it also
        returns ``uniform_sdf``, the sdf on the jittered uniform grid over
        ``roi_aabb`` at ``resolution`` (``get_uniform_sdf``), which
        ``SoftSparsityLoss`` reads; its gradient flows into the volume.
        ``global_iter``: the step count before this step's update (the
        JAX step's ``state.step``), for ``anneal_aabb`` and
        ``beta_hand_tune``. ``return_sample_sdf`` / ``return_surface_sdf``
        add ``sample_sdf`` (the samples' sdf, which
        ``AdaptiveSparsityLoss`` reads) / ``surface_sdf`` (at the rendered
        depth); ``two_split`` then splits the cameras
        (``split_cams_for_losses``). With ``estimate_flow`` and both
        neighbouring BEV planes ``prev_rep`` / ``next_rep`` given, it also
        returns the four flow volumes (``flows``) and the samples warped by
        them, ``prev_warp`` / ``next_warp`` (``warped_samples``)."""
        volume = self.field.decode(representation)[0]
        device = volume.device
        flows = None
        if self.flow_net is not None and prev_rep is not None \
                and next_rep is not None:
            flows = self.flows(representation, prev_rep, next_rep)
        draws = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in (draws or {}).items()}
        sampler = self.ray_sampler if train else self.ray_sampler_eval
        rays = sampler(device, generator, draws.get(sampler.ray_sample_mode))
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
            inv_s = self.inv_s(global_iter, device)
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
                    {k: v[sl] for k, v in rd.items()}, global_iter,
                    use_reentrant=False))
            r = {k: parts[0][k] if parts[0][k].dim() == 0 else
                 torch.cat([p[k] for p in parts])[:R_tot] for k in parts[0]}
        else:
            if train:
                draws.update(self._train_draws(R_tot, device, generator,
                                               draws))
            r = self.render_rays(volume, origin_flat, dir_flat, train=train,
                                 generator=generator, draws=draws,
                                 global_iter=global_iter)

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
        if self.return_sample_sdf:
            outputs["sample_sdf"] = cams(r["sdf"], (S,))
        if self.return_surface_sdf:
            outputs["surface_sdf"] = cams(r["surface_sdf"])
        if "max_depth" in r:
            outputs["ms_max_depths"] = [cams(r["max_depth"])]
        if self.return_uniform_sdf:
            # the jitter: JAX draws uniform(split(rng)[1], xyz.shape)
            # (heads.py:503-506); here the caller's generator, or the
            # replayed draw ``uniform_shift`` (H, W, D, 3)
            outputs["uniform_sdf"] = self.get_uniform_sdf(
                volume, self.roi_aabb, self.resolution, generator=generator,
                shift=draws.get("uniform_shift"))[0]
        if flows is not None:
            warps = self.warped_samples(flows, origin_flat, dir_flat, r["ts"])
            outputs.update({k: cams(v, (S, 3)) for k, v in warps.items()})
            outputs.update(flows)
        if self.two_split:
            outputs = split_cams_for_losses(outputs, num_cams)
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

    def _render_chunk(self, volume, origin, direction, inv_s, draws,
                      global_iter):
        r = self.render_rays(volume, origin, direction, train=True,
                             draws=draws, inv_s=inv_s,
                             global_iter=global_iter)
        if not self.return_sample_sdf:
            r.pop("sdf")
        return r
