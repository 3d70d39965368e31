"""NeuS compositing weights from per-sample alpha — counterpart of
``selfocc_tpu/ops/render_pallas.py``.

    w_i = a_i * prod_{j<i} (1 - a_j + eps) = a_i * exp(sum_{j<i} log(1 - a_j + eps))

``weights_from_alpha`` is the renderer's entry point. For a CUDA tensor it
launches the hand-written kernel ``csrc/neus_weights.cu`` (one warp per ray,
shuffle scan of the log-transmittance); for a CPU tensor it takes the plain
PyTorch version ``weights_from_alpha_plain``, which computes the same
log-sum formula. The gradient is the closed form of ``render_pallas.py:76-84``
in a ``torch.autograd.Function`` (plain XLA in JAX too, so no kernel).
"""
from __future__ import annotations

import torch

from .. import _build

EPS = 1e-7


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
    """Launch ``csrc/neus_weights.cu`` on (R, S) fp32 CUDA alpha."""
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


def _forward(alpha: torch.Tensor) -> torch.Tensor:
    _check(alpha)
    if alpha.is_cuda:
        return neus_weights_fwd(alpha.contiguous())
    return weights_from_alpha_plain(alpha)


def _recompute_trans(alpha):
    trans = torch.cumprod(1.0 - alpha + EPS, dim=-1)
    return torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)


class _WeightsFromAlpha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha):
        w = _forward(alpha)
        ctx.save_for_backward(alpha, w)
        return w

    @staticmethod
    def backward(ctx, g):
        alpha, w = ctx.saved_tensors
        # w_i = a_i t_i, t_i = exp(sum_{j<i} log(1 - a_j + eps))
        # da_k = g_k t_k - (1 / (1 - a_k + eps)) * sum_{i>k} g_i w_i
        pos = alpha > 0
        t = torch.where(pos, w / torch.where(pos, alpha, torch.ones_like(alpha)),
                        _recompute_trans(alpha))
        gw = g * w
        suffix = torch.flip(torch.cumsum(torch.flip(gw, [-1]), -1), [-1]) - gw
        return g * t - suffix / (1.0 - alpha + EPS)


def weights_from_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """(R, S) fp32 alpha -> (R, S) weights; differentiable."""
    return _WeightsFromAlpha.apply(alpha)
