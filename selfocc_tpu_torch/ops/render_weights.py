"""The NeuS render of each ray: alpha, weights and composites — counterpart
of ``selfocc_tpu/ops/render_pallas.py`` and of the elementwise chain around
it in the JAX head (``selfocc_tpu/models/heads.py:316-336, 360-362``).

    w_i = a_i * prod_{j<i} (1 - a_j + eps) = a_i * exp(sum_{j<i} log(1 - a_j + eps))

``neus_composite`` is the renderer's entry point: from the samples' sdf, its
metric gradient, the unit directions, the bin edges, ``|direction|`` and
``inv_s`` it returns the weights, ``acc``, ``depth``, ``normal_vis``, ``ts``
and ``deltas``, differentiable in sdf, gradient and ``inv_s``. For CUDA
tensors its forward and backward launch the fused kernels of
``csrc/neus_weights.cu`` (``neus_render_fwd``, ``neus_render_bwd``, through
``_NeuSComposite``); for CPU tensors it runs the plain version
(``neus_composite_plain``, the head's chain of torch ops) under autograd.

``weights_from_alpha`` is the alpha-input entry, which the density head's
render, the NeuS head's importance and skip renders and its up-sample
rounds take: for CUDA tensors the ``neus_weights_fwd`` instance of the same
forward kernel and the ``neus_weights_bwd`` kernel for the closed-form
gradient of ``render_pallas.py:76-84``, summed without its division by
``1 - alpha + eps``; for CPU tensors their plain versions,
``weights_from_alpha_plain`` and ``weights_grad_plain``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ..models import neus

EPS = 1e-7
# the fused backward keeps a whole ray in registers: 32 lanes x at most 8
# samples
MAX_BWD_SAMPLES = 256
# the alpha-input backward stages rows through shared memory above that: one
# pass up to 512 samples, tiles of 512 above, at most 16
MAX_WEIGHTS_BWD_SAMPLES = 16 * 512


def weights_from_alpha_plain(alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: exclusive cumsum of
    log(1 - a + eps), exponentiated, times a."""
    la = torch.log(1.0 - alpha + EPS)
    csum = torch.cumsum(la, dim=-1)
    excl = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]], dim=-1)
    return alpha * torch.exp(excl)


def _check(alpha: torch.Tensor):
    if alpha.dtype != torch.float32 or alpha.dim() != 2:
        raise ValueError("weights_from_alpha: expected (R, S) float32 alpha, "
                         f"got {tuple(alpha.shape)} {alpha.dtype}")


def neus_weights_fwd(alpha: torch.Tensor) -> torch.Tensor:
    """Launch the alpha-input instance of ``csrc/neus_weights.cu`` on (R, S)
    fp32 CUDA alpha."""
    _check(alpha)
    _build.require_cuda_tensor(alpha, "neus_weights_fwd", torch.float32, 2)
    lib = _build.load("neus_weights", _SIGNATURES)
    out = torch.empty_like(alpha)
    R, S = alpha.shape
    status = lib.neus_weights_fwd(_build.ptr(alpha), _build.ptr(out), R, S,
                                  _build.stream_ptr(alpha.device))
    _build.check(status, "neus_weights_fwd")
    neus_weights_fwd.launches += 1
    return out


neus_weights_fwd.launches = 0
_SIGNATURES = {"neus_weights_fwd": (_build.PTR, _build.PTR, _build.I64,
                                    _build.I32, _build.PTR)}


def neus_weights_bwd(alpha: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/neus_weights.cu::neus_weights_bwd`` on (R, S) fp32
    CUDA alpha and the weights' cotangent ``g``: the cotangent of alpha
    (``weights_grad_plain`` is its plain version). At most
    ``MAX_WEIGHTS_BWD_SAMPLES`` samples a ray: up to 256 the kernel holds a
    ray in registers; above, it stages each row through shared memory, one
    pass up to 512 samples and tiles of 512 beyond (``tiled_launches``
    counts the calls above 256)."""
    _check(alpha)
    _build.require_cuda_tensor(alpha, "neus_weights_bwd alpha",
                               torch.float32, 2)
    _build.require_cuda_tensor(g, "neus_weights_bwd g", torch.float32, 2)
    R, S = alpha.shape
    if tuple(g.shape) != (R, S) or g.device != alpha.device:
        raise ValueError(f"neus_weights_bwd: g must be {(R, S)} on "
                         f"{alpha.device}, got {tuple(g.shape)} on "
                         f"{g.device}")
    if S > MAX_WEIGHTS_BWD_SAMPLES:
        raise ValueError(f"neus_weights_bwd: at most "
                         f"{MAX_WEIGHTS_BWD_SAMPLES} samples per ray, got {S}")
    lib = _build.load("neus_weights", _SIGNATURES)
    alpha, g = alpha.contiguous(), g.contiguous()
    out = torch.empty_like(alpha)
    status = lib.neus_weights_bwd(_build.ptr(alpha), _build.ptr(g),
                                  _build.ptr(out), R, S,
                                  _build.stream_ptr(alpha.device))
    _build.check(status, "neus_weights_bwd")
    neus_weights_bwd.launches += 1
    neus_weights_bwd.tiled_launches += S > 256
    return out


neus_weights_bwd.launches = 0
neus_weights_bwd.tiled_launches = 0
_SIGNATURES["neus_weights_bwd"] = (_build.PTR, _build.PTR, _build.PTR,
                                   _build.I64, _build.I32, _build.PTR)


def _reverse_logcumsumexp(x):
    return torch.flip(torch.logcumsumexp(torch.flip(x, [-1]), -1), [-1])


def weights_grad_plain(alpha, g):
    """The cotangent of alpha for the cotangent ``g`` of the weights: the
    closed form of ``render_pallas.py:76-84``,
        da_k = g_k T_k - (sum_{i>k} g_i w_i) / (1 - a_k + eps),
    taken as T_k D_k with D_k = g_k - sum_{i>k} g_i a_i prod_{k<j<i} b_j,
    b_j = 1 - a_j + eps. D obeys D_k = c_k + b_{k+1} D_{k+1}, c_k = (g_k -
    g_{k+1}) - g_{k+1} ((a_{k+1} + b_{k+1}) - 1) (c = g at the last
    sample; (a + b) - 1 ~ eps is taken in float64), so
        D_k = sum_{i>=k} c_i prod_{k<j<=i} b_j,
    summed in the log domain with its positive and negative terms apart
    (``logcumsumexp``). Neither the division by 1 - a_k + eps (down to
    1e-7 where alpha saturates, scaling the suffix sum's rounding by 1e7)
    nor the difference g_k - (suffix), which cancels to the remaining
    transmittance on an opaque ray, is taken in fp32. The kernel
    ``neus_render_bwd`` runs the same recurrence."""
    b = 1.0 - alpha + EPS
    log_b = torch.log(b)
    log_t_incl = torch.cumsum(log_b, -1)             # log T_{k+1}
    b_err = (alpha.double() + b.double() - 1.0).to(alpha.dtype)
    g_next = torch.cat([g[..., 1:], torch.zeros_like(g[..., :1])], -1)
    e_next = torch.cat([b_err[..., 1:], torch.zeros_like(g[..., :1])], -1)
    c = (g - g_next) - g_next * e_next
    neg_inf = torch.full_like(c, float("-inf"))
    d = torch.zeros_like(c)
    for sign in (1.0, -1.0):
        part = sign * c
        terms = torch.where(part > 0, torch.log(part.clamp_min(1e-38))
                            + log_t_incl, neg_inf)
        d = d + sign * torch.exp(_reverse_logcumsumexp(terms) - log_t_incl)
    log_t = torch.cat([torch.zeros_like(log_b[..., :1]),
                       log_t_incl[..., :-1]], -1)    # log T_k
    return torch.exp(log_t) * d


class _WeightsFromAlpha(torch.autograd.Function):
    """The kernels on CUDA alpha unless ``plain`` (then any float dtype and
    the plain versions on any device): ``neus_weights_fwd`` forward,
    ``neus_weights_bwd`` backward."""

    @staticmethod
    def forward(ctx, alpha, plain):
        if not plain:
            _check(alpha)
        kernel = alpha.is_cuda and not plain
        w = neus_weights_fwd(alpha.contiguous()) if kernel else \
            weights_from_alpha_plain(alpha)
        ctx.kernel = kernel
        ctx.save_for_backward(alpha)
        return w

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        if ctx.kernel:
            return neus_weights_bwd(alpha.contiguous(), g.float()), None
        return weights_grad_plain(alpha, g), None


def weights_from_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """(R, S) fp32 alpha -> (R, S) weights; differentiable."""
    return _WeightsFromAlpha.apply(alpha, False)


# ------------------------------------------------------- the fused render
def neus_composite_plain(sdf, grad, unit_dir, edges, direction_norm, inv_s,
                         dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of the fused render: the head's chain of torch
    ops. sdf (R, S), grad (R, S, 3), unit_dir (R, 3), edges (R, S + 1),
    direction_norm (R,), inv_s 0-dim -> (weights (R, S), acc (R,), depth
    (R,), normal_vis (R, 3), ts (R, S), deltas (R, S)). The weights take the
    plain forward and the closed-form gradient.

    ``dtype`` (default: the inputs') is the type of everything after alpha.
    ``chip_smoke.py`` holds the fp32 kernels' gradients to this function
    with alpha in fp32 and the rest in float64: alpha's ``prev - next``
    difference costs any fp32 implementation the same digits, while the
    sums after it are taken in another order by the kernels."""
    starts, ends = edges[:, :-1], edges[:, 1:]
    mids = (starts + ends) / 2
    deltas = ends - starts
    alpha = neus.neus_alpha(sdf, grad, unit_dir, deltas, inv_s)
    if dtype is not None:
        alpha, grad, mids, deltas, direction_norm = (
            t.to(dtype) for t in (alpha, grad, mids, deltas, direction_norm))
    weights = _WeightsFromAlpha.apply(alpha, True)
    acc = weights.sum(-1)
    dn = direction_norm[:, None]
    depth = neus.composite(weights, mids[..., None])[..., 0] / dn[:, 0]
    norm = grad / torch.linalg.norm(grad, dim=-1,
                                    keepdim=True).clamp_min(1e-6)
    normal_vis = neus.composite(weights, (norm + 1.0) / 2.0)
    return weights, acc, depth, normal_vis, mids / dn, deltas / dn


def neus_composite_bwd_plain(sdf, grad, unit_dir, edges, direction_norm,
                             inv_s, g_weights, g_acc, g_depth, g_normal_vis,
                             dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of ``neus_render_bwd``: autograd through
    ``neus_composite_plain`` (``dtype`` as there); any cotangent may be
    None. Returns (g_sdf, g_grad, g_inv_s)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (sdf, grad, inv_s)]
        outs = neus_composite_plain(leaves[0], leaves[1], unit_dir, edges,
                                    direction_norm, leaves[2], dtype)[:4]
        pairs = [(o, g.to(o.dtype)) for o, g in zip(
            outs, (g_weights, g_acc, g_depth, g_normal_vis)) if g is not None]
        if not pairs:
            return tuple(torch.zeros_like(t) for t in leaves)
        got = torch.autograd.grad([o for o, _ in pairs], leaves,
                                  [g for _, g in pairs], allow_unused=True)
        return tuple(torch.zeros_like(t) if g is None else g
                     for g, t in zip(got, leaves))


def _sdf_strides(sdf: torch.Tensor) -> Tuple[int, int]:
    """(ray stride, sample stride) of a (R, S) sdf view: the training render
    passes ``vals[..., 0]`` of its (R, S, C) trilinear result as it is."""
    if sdf.dtype != torch.float32 or sdf.dim() != 2:
        raise ValueError("neus_render: expected (R, S) float32 sdf, got "
                         f"{tuple(sdf.shape)} {sdf.dtype}")
    return sdf.stride(0), sdf.stride(1)


def _check_render_inputs(name, sdf, grad, unit_dir, edges, direction_norm,
                         inv_s):
    if not sdf.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {sdf.device}")
    R, S = sdf.shape
    for t, tname, shape in ((grad, "grad", (R, S, 3)),
                            (unit_dir, "unit_dir", (R, 3)),
                            (edges, "edges", (R, S + 1)),
                            (direction_norm, "direction_norm", (R,)),
                            (inv_s, "inv_s", ())):
        _build.require_cuda_tensor(t, f"{name} {tname}", torch.float32)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != sdf.device:
            raise ValueError(f"{name}: {tname} on {t.device}, sdf on "
                             f"{sdf.device}")


def neus_render_fwd(sdf, grad, unit_dir, edges, direction_norm, inv_s,
                    weights: bool = True, geometry: bool = True):
    """Launch ``csrc/neus_weights.cu::neus_render_fwd`` on fp32 CUDA
    tensors (sdf (R, S) with any strides, the rest contiguous; ``inv_s`` a
    0-dim device tensor, read by the kernel, never by the host). Returns
    ``neus_composite_plain``'s six outputs; ``weights = False`` /
    ``geometry = False`` skip writing the weights / ``ts`` and ``deltas``,
    which then come back as empty tensors."""
    ray_stride, step = _sdf_strides(sdf)
    _check_render_inputs("neus_render_fwd", sdf, grad, unit_dir, edges,
                         direction_norm, inv_s)
    R, S = sdf.shape
    lib = _build.load("neus_weights", _SIGNATURES)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=sdf.device)

    w = new(R, S) if weights else new(0)
    ts, deltas = (new(R, S), new(R, S)) if geometry else (new(0), new(0))
    acc, depth, normal_vis = new(R), new(R), new(R, 3)
    status = lib.neus_render_fwd(
        _build.ptr(sdf), ray_stride, step, _build.ptr(grad),
        _build.ptr(unit_dir), _build.ptr(edges), _build.ptr(direction_norm),
        _build.ptr(inv_s), _optional_ptr(w if weights else None),
        _build.ptr(acc), _build.ptr(depth), _build.ptr(normal_vis),
        _optional_ptr(ts if geometry else None),
        _optional_ptr(deltas if geometry else None), R, S,
        _build.stream_ptr(sdf.device))
    _build.check(status, "neus_render_fwd")
    neus_render_fwd.launches += 1
    return w, acc, depth, normal_vis, ts, deltas


neus_render_fwd.launches = 0
_SIGNATURES["neus_render_fwd"] = (
    _build.PTR, _build.I64, _build.I64, _build.PTR, _build.PTR, _build.PTR,
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
    _build.PTR, _build.PTR, _build.I64, _build.I32, _build.PTR)


def neus_render_bwd(sdf, grad, unit_dir, edges, direction_norm, inv_s,
                    g_weights: Optional[torch.Tensor],
                    g_acc: Optional[torch.Tensor],
                    g_depth: Optional[torch.Tensor],
                    g_normal_vis: Optional[torch.Tensor]):
    """Launch ``csrc/neus_weights.cu::neus_render_bwd``: (g_sdf (R, S),
    g_grad (R, S, 3), g_inv_s 0-dim) for the cotangents of weights, acc,
    depth and normal_vis (each may be None). The kernel writes one partial
    of g_inv_s per ray; one ``torch.sum`` adds them, in a fixed order."""
    ray_stride, step = _sdf_strides(sdf)
    _check_render_inputs("neus_render_bwd", sdf, grad, unit_dir, edges,
                         direction_norm, inv_s)
    R, S = sdf.shape
    if S > MAX_BWD_SAMPLES:
        raise ValueError(f"neus_render_bwd: at most {MAX_BWD_SAMPLES} "
                         f"samples per ray, got {S}")
    for g, name, shape in ((g_weights, "g_weights", (R, S)),
                           (g_acc, "g_acc", (R,)), (g_depth, "g_depth", (R,)),
                           (g_normal_vis, "g_normal_vis", (R, 3))):
        if g is not None:
            _build.require_cuda_tensor(g, f"neus_render_bwd {name}",
                                       torch.float32)
            if tuple(g.shape) != shape:
                raise ValueError(f"neus_render_bwd: {name} must be {shape}, "
                                 f"got {tuple(g.shape)}")
    lib = _build.load("neus_weights", _SIGNATURES)
    g_sdf = torch.empty((R, S), dtype=torch.float32, device=sdf.device)
    g_grad = torch.empty((R, S, 3), dtype=torch.float32, device=sdf.device)
    g_inv_s = torch.empty((R,), dtype=torch.float32, device=sdf.device)
    status = lib.neus_render_bwd(
        _build.ptr(sdf), ray_stride, step, _build.ptr(grad),
        _build.ptr(unit_dir), _build.ptr(edges), _build.ptr(direction_norm),
        _build.ptr(inv_s), _optional_ptr(g_weights), _optional_ptr(g_acc),
        _optional_ptr(g_depth), _optional_ptr(g_normal_vis), _build.ptr(g_sdf),
        _build.ptr(g_grad), _build.ptr(g_inv_s), R, S,
        _build.stream_ptr(sdf.device))
    _build.check(status, "neus_render_bwd")
    neus_render_bwd.launches += 1
    return g_sdf, g_grad, g_inv_s.sum()


neus_render_bwd.launches = 0
_SIGNATURES["neus_render_bwd"] = (
    _build.PTR, _build.I64, _build.I64, _build.PTR, _build.PTR, _build.PTR,
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
    _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32, _build.PTR)


def _optional_ptr(t):
    return _build.ptr(t) if t is not None else None


def _contiguous(t):
    return None if t is None else t.contiguous()


class _NeuSComposite(torch.autograd.Function):
    """The fused kernels on CUDA tensors; gradients for sdf, grad and inv_s
    only (``neus_composite`` refuses the ray geometry's)."""

    @staticmethod
    def forward(ctx, sdf, grad, unit_dir, edges, direction_norm, inv_s,
                weights, geometry):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(sdf, grad, unit_dir, edges, direction_norm,
                              inv_s)
        outs = neus_render_fwd(sdf, grad, unit_dir, edges, direction_norm,
                               inv_s, weights, geometry)
        ctx.mark_non_differentiable(outs[4], outs[5])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_weights, g_acc, g_depth, g_normal_vis, _g_ts,
                 _g_deltas):
        g_sdf, g_grad, g_inv_s = neus_render_bwd(
            *ctx.saved_tensors,
            *(_contiguous(g) for g in (g_weights, g_acc, g_depth,
                                       g_normal_vis)))
        return g_sdf, g_grad, None, None, None, g_inv_s, None, None


def neus_composite(sdf: torch.Tensor, grad: torch.Tensor,
                   unit_dir: torch.Tensor, edges: torch.Tensor,
                   direction_norm: torch.Tensor, inv_s: torch.Tensor,
                   weights: bool = True, geometry: bool = True):
    """The NeuS render of R rays of S samples (cos_anneal_ratio 1).

    Args:
      sdf: (R, S) sample sdf (a strided view is read as it is).
      grad: (R, S, 3) metric sdf gradient.
      unit_dir: (R, 3) unit ray directions; edges: (R, S + 1) bin edges
        along them; direction_norm: (R,) ``|direction|``. No gradient.
      inv_s: 0-dim tensor on the same device.
      weights, geometry: on a CUDA tensor, ``False`` skips writing the
        weights / ``ts`` and ``deltas`` (empty tensors come back).
    Returns:
      weights (R, S), acc (R,), depth (R,) = sum w mid / |d|, normal_vis
      (R, 3), ts (R, S) = mid / |d|, deltas (R, S) = delta / |d|; the first
      four differentiable in sdf, grad and inv_s.
    """
    for t, name in ((unit_dir, "unit_dir"), (edges, "edges"),
                    (direction_norm, "direction_norm")):
        if torch.is_tensor(t) and t.requires_grad:
            raise NotImplementedError(
                f"neus_composite: no gradient with respect to {name} is "
                "ported (detach it)")
    inv_s = torch.as_tensor(inv_s, dtype=torch.float32, device=sdf.device)
    if not sdf.is_cuda:
        return neus_composite_plain(sdf.float(), grad.float(),
                                    unit_dir.float(), edges.float(),
                                    direction_norm.float().reshape(-1), inv_s)
    return _NeuSComposite.apply(
        sdf.float(), grad.float().contiguous(), unit_dir.float().contiguous(),
        edges.float().contiguous(),
        direction_norm.float().reshape(-1).contiguous(), inv_s, weights,
        geometry)
