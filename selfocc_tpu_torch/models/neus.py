"""NeuS volume-rendering math — counterpart of ``selfocc_tpu/models/neus.py``
(box collider, uniform sampling without jitter, SDF -> alpha, weights,
compositing). Stratified jitter, importance sampling and random backgrounds
come with the training slice."""
from __future__ import annotations

from typing import NamedTuple

import torch


class RaySegments(NamedTuple):
    starts: torch.Tensor   # (R, S) euclidean distance along the unit direction
    ends: torch.Tensor     # (R, S)
    nears: torch.Tensor    # (R,)
    fars: torch.Tensor     # (R,)

    @property
    def mids(self):
        return (self.starts + self.ends) / 2

    @property
    def deltas(self):
        return self.ends - self.starts


def ray_aabb_near_far(origins, directions, aabb, near_plane=0.0,
                      far_plane=1e10):
    """Axis-aligned box collider: (R, 3) origins, (R, 3) unit directions,
    6-list ``[x0, y0, z0, x1, y1, z1]`` -> (near, far) (R,), with
    ``near_plane <= near <= far``; rays that miss collapse to near == far."""
    inv_d = 1.0 / torch.where(directions.abs() < 1e-10,
                              torch.full_like(directions, 1e-10), directions)
    # per-axis python-scalar bounds: no host-to-device copy per call
    t0 = torch.stack([(float(aabb[k]) - origins[:, k]) * inv_d[:, k]
                      for k in range(3)], dim=-1)
    t1 = torch.stack([(float(aabb[k + 3]) - origins[:, k]) * inv_d[:, k]
                      for k in range(3)], dim=-1)
    t_min = torch.minimum(t0, t1).amax(dim=-1)
    t_max = torch.maximum(t0, t1).amin(dim=-1)
    near = t_min.clamp_min(near_plane)
    far = t_max.clamp_max(far_plane)
    far = torch.maximum(far, near)
    return near, far


def sample_uniform(near, far, num_samples: int) -> RaySegments:
    """Uniform bins between near and far (no jitter: the eval path)."""
    R = near.shape[0]
    # i / n, the values jnp.linspace(0, 1, n + 1) gives in float32
    bins = (torch.arange(num_samples + 1, dtype=torch.float32,
                         device=near.device) / num_samples)
    bins = bins[None, :].expand(R, -1)
    t = near[:, None] + (far - near)[:, None] * bins
    return RaySegments(starts=t[:, :-1], ends=t[:, 1:], nears=near, fars=far)


def neus_alpha(sdf, grad, directions, deltas, inv_s, cos_anneal_ratio=1.0):
    """SDF -> per-sample opacity via the NeuS logistic-CDF section estimate.
    sdf (R, S), grad (R, S, 3), directions (R, 3) unit, deltas (R, S)."""
    true_cos = (directions[:, None, :] * grad).sum(-1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * deltas * 0.5
    est_prev = sdf - iter_cos * deltas * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return alpha.clamp(0.0, 1.0)


def weights_from_alpha(alpha):
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-7): the plain
    exclusive-cumprod. The renderer uses ``ops.render_weights`` instead (the
    kernel on CUDA tensors)."""
    trans = torch.cumprod(1.0 - alpha + 1e-7, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def composite(weights, values):
    """(R, S) x (R, S, C) -> (R, C)."""
    return (weights[..., None] * values).sum(-2)


def background_color(render_bkgd: str, shape, device):
    """'white' | 'black' (the rng-less eval backgrounds)."""
    if render_bkgd == "white":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if render_bkgd == "black":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    raise ValueError(f"background {render_bkgd!r} needs a random generator; "
                     "eval renders use 'white' or 'black'")
