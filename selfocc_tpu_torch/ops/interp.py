"""Bilinear / trilinear interpolation — counterpart of
``selfocc_tpu/ops/interp.py``.

Conventions are the JAX package's: the public functions take **fractional
indices** under ``align_corners=True`` (0 .. size-1), not [-1, 1] grids, and
volumes have the channel-first shape ``(C, H, W, D)``.

``trilinear_sample_cf_with_grad`` is the render's hot loop. It is
differentiable with respect to the volume, from both of its outputs
(``_TrilinearWithGrad``): for a CUDA volume its forward and backward launch
``csrc/trilinear.cu`` (``trilinear_cf_with_grad_fwd``, ``trilinear_bwd``,
zeros padding); for a CPU volume they take the plain versions
(``trilinear_sample_cf_with_grad_plain`` and ``trilinear_bwd_plain``,
autograd through it). The points get no gradient.

The kernels read a channel-last volume: ``(H, W, D, C)`` in memory, seen as
``(C, H, W, D)`` through a permute, so that a corner's channels are one
contiguous row. ``field.decode`` produces that layout; ``kernel_volume``
passes it through and copies any other, and ``first_channel`` takes the sdf
plane of it with a gradient in the same layout.
"""
from __future__ import annotations

import torch

from .. import _build


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor,
                    padding: str = "zeros") -> torch.Tensor:
    """Sample a (H, W, C) image at fractional (x, y) pixel indices (..., 2)
    -> (..., C); 'zeros' or 'border' padding (``interp.py:34``)."""
    H, W = img.shape[0], img.shape[1]
    x, y = xy[..., 0], xy[..., 1]
    if padding == "border":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    out = None
    for yi, wyi in ((y0, 1.0 - wy), (y0 + 1, wy)):
        for xi, wxi in ((x0, 1.0 - wx), (x0 + 1, wx)):
            w = wyi * wxi
            if padding == "zeros":
                valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                w = w * valid
            val = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            term = w[..., None] * val
            out = term if out is None else out + term
    return out


def _corners(vol_cf, hwd, padding):
    """Per-corner (flat index, weight, mask, axis weights) for a (C, H, W, D)
    volume at (N, 3) fractional indices — the reference's loop order."""
    C, H, W, D = vol_cf.shape
    h, w, d = hwd[:, 0], hwd[:, 1], hwd[:, 2]
    if padding == "border":
        h = h.clamp(0.0, H - 1.0)
        w = w.clamp(0.0, W - 1.0)
        d = d.clamp(0.0, D - 1.0)
    h0, w0, d0 = torch.floor(h), torch.floor(w), torch.floor(d)
    wh_ = (1.0 - (h - h0), h - h0)
    ww_ = (1.0 - (w - w0), w - w0)
    wd_ = (1.0 - (d - d0), d - d0)
    h0i, w0i, d0i = h0.long(), w0.long(), d0.long()
    for ih in (0, 1):
        for iw in (0, 1):
            for idd in (0, 1):
                hi, wi, di = h0i + ih, w0i + iw, d0i + idd
                if padding == "zeros":
                    mask = ((hi >= 0) & (hi <= H - 1) & (wi >= 0)
                            & (wi <= W - 1) & (di >= 0) & (di <= D - 1))
                    mask = mask.to(vol_cf.dtype)
                else:
                    mask = None
                lin = ((hi.clamp(0, H - 1) * W + wi.clamp(0, W - 1)) * D
                       + di.clamp(0, D - 1))
                yield (ih, iw, idd), lin, mask, (wh_, ww_, wd_)


def trilinear_sample_cf(vol_cf: torch.Tensor, hwd: torch.Tensor,
                        padding: str = "zeros") -> torch.Tensor:
    """vol (C, H, W, D), hwd (..., 3) fractional indices -> (..., C)."""
    C = vol_cf.shape[0]
    pts_shape = hwd.shape[:-1]
    v_flat = vol_cf.reshape(C, -1)
    out = None
    for (ih, iw, idd), lin, mask, (wh_, ww_, wd_) in _corners(
            vol_cf, hwd.reshape(-1, 3), padding):
        wgt = wh_[ih] * ww_[iw] * wd_[idd]
        if mask is not None:
            wgt = wgt * mask
        term = wgt[None, :] * v_flat[:, lin]
        out = term if out is None else out + term
    return out.T.reshape(*pts_shape, C)


def trilinear_sample_cf_with_grad_plain(vol_cf: torch.Tensor,
                                        hwd: torch.Tensor,
                                        padding: str = "zeros"):
    """Plain PyTorch version of the kernel (``interp.py:159-222``): values
    (..., C) and grad0 (..., 3) = d(channel 0)/d(h, w, d)."""
    C = vol_cf.shape[0]
    pts_shape = hwd.shape[:-1]
    v_flat = vol_cf.reshape(C, -1)
    vals = gh = gw = gd = None
    for (ih, iw, idd), lin, mask, (wh_, ww_, wd_) in _corners(
            vol_cf, hwd.reshape(-1, 3), padding):
        g = v_flat[:, lin]                                    # (C, N)
        c0 = g[0] * mask if mask is not None else g[0]
        wgt = wh_[ih] * ww_[iw] * wd_[idd]
        if mask is not None:
            wgt = wgt * mask
        term = wgt[None, :] * g
        vals = term if vals is None else vals + term
        th = (1.0 if ih else -1.0) * ww_[iw] * wd_[idd] * c0
        tw = (1.0 if iw else -1.0) * wh_[ih] * wd_[idd] * c0
        td = (1.0 if idd else -1.0) * wh_[ih] * ww_[iw] * c0
        gh = th if gh is None else gh + th
        gw = tw if gw is None else gw + tw
        gd = td if gd is None else gd + td
    grad0 = torch.stack([gh, gw, gd], dim=-1)
    return (vals.T.reshape(*pts_shape, C).float(),
            grad0.reshape(*pts_shape, 3).float())


def kernel_volume(vol_cf: torch.Tensor) -> torch.Tensor:
    """``vol_cf`` (C, H, W, D) in the layout the kernels read: channel-last
    memory (for C = 1, a contiguous plane). A volume already laid out so is
    returned as it is; any other is copied (differentiably)."""
    cl = vol_cf.permute(1, 2, 3, 0)
    return vol_cf if cl.is_contiguous() else \
        cl.contiguous().permute(3, 0, 1, 2)


def first_channel(vol_cf: torch.Tensor) -> torch.Tensor:
    """Channel 0 of a (C, H, W, D) volume as a contiguous (1, H, W, D)
    plane, the sdf queries' volume. A channel-first volume gives a slice.
    A channel-last one is sliced on its (H, W, D, C) view and copied, so
    that autograd's zero-filled gradient of the slice is channel-last too
    and adds to the volume's other gradients without a transpose."""
    if vol_cf.is_contiguous():
        return vol_cf[:1]
    return kernel_volume(vol_cf.permute(1, 2, 3, 0)[..., :1]
                         .permute(3, 0, 1, 2))


def _require_kernel_volume(vol_cf, name):
    _build.require_cuda_tensor(vol_cf.permute(1, 2, 3, 0),
                               f"{name} volume (channel-last)", torch.float32,
                               4)


def trilinear_cf_with_grad_fwd(vol_cf: torch.Tensor, hwd: torch.Tensor):
    """Launch ``csrc/trilinear.cu``: an fp32 CUDA (C, H, W, D) volume in the
    kernels' layout (``kernel_volume``), (N, 3) fractional indices, zeros
    padding -> vals (N, C), grad0 (N, 3). C = 1 takes the plane kernel, any
    other C the rows kernel (``plane_launches`` counts the former)."""
    _require_kernel_volume(vol_cf, "trilinear_cf_with_grad_fwd")
    _build.require_cuda_tensor(hwd, "trilinear_cf_with_grad_fwd points",
                               torch.float32, 2)
    if hwd.shape[1] != 3 or hwd.device != vol_cf.device:
        raise ValueError("trilinear_cf_with_grad_fwd: points must be (N, 3) "
                         "on the volume's device")
    lib = _build.load("trilinear", _SIGNATURES)
    C, H, W, D = vol_cf.shape
    N = hwd.shape[0]
    vals = torch.empty((N, C), dtype=torch.float32, device=hwd.device)
    grad0 = torch.empty((N, 3), dtype=torch.float32, device=hwd.device)
    status = lib.trilinear_cf_with_grad_fwd(
        _build.ptr(vol_cf), _build.ptr(hwd), _build.ptr(vals),
        _build.ptr(grad0), N, C, H, W, D, _build.stream_ptr(hwd.device))
    _build.check(status, "trilinear_cf_with_grad_fwd")
    trilinear_cf_with_grad_fwd.launches += 1
    trilinear_cf_with_grad_fwd.plane_launches += C == 1
    return vals, grad0


trilinear_cf_with_grad_fwd.launches = 0
trilinear_cf_with_grad_fwd.plane_launches = 0
_SIGNATURES = {"trilinear_cf_with_grad_fwd": (
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32,
    _build.I32, _build.I32, _build.I32, _build.PTR)}


def trilinear_bwd_plain(vol_cf, hwd, grad_vals, grad_grad0,
                        padding: str = "zeros"):
    """Plain PyTorch version of ``trilinear_bwd``: autograd through
    ``trilinear_sample_cf_with_grad_plain``; either cotangent may be None."""
    with torch.enable_grad():
        vol = vol_cf.detach().requires_grad_(True)
        vals, grad0 = trilinear_sample_cf_with_grad_plain(vol, hwd, padding)
        outs = [(o, g) for o, g in ((vals, grad_vals), (grad0, grad_grad0))
                if g is not None]
        if not outs:
            return torch.zeros_like(vol_cf)
        return torch.autograd.grad([o for o, _ in outs], vol,
                                   [g for _, g in outs])[0]


def trilinear_bwd(vol_cf: torch.Tensor, hwd: torch.Tensor, grad_vals,
                  grad_grad0) -> torch.Tensor:
    """Launch ``csrc/trilinear.cu::trilinear_bwd``: the (C, H, W, D)
    cotangent of a volume in the kernels' layout, in that layout, for
    cotangents ``grad_vals`` (N, C) and ``grad_grad0`` (N, 3) of
    ``trilinear_cf_with_grad_fwd`` (either may be None; with neither, zeros
    and no launch), zeros padding. The kernel accumulates into the
    zero-filled result itself; C = 1 takes the plane kernel
    (``plane_launches``), any other C the rows kernel."""
    _require_kernel_volume(vol_cf, "trilinear_bwd")
    _build.require_cuda_tensor(hwd, "trilinear_bwd points", torch.float32, 2)
    C, H, W, D = vol_cf.shape
    N = hwd.shape[0]
    for g, name, width in ((grad_vals, "grad_vals", C),
                           (grad_grad0, "grad_grad0", 3)):
        if g is not None:
            _build.require_cuda_tensor(g, f"trilinear_bwd {name}",
                                       torch.float32, 2)
            if tuple(g.shape) != (N, width):
                raise ValueError(f"trilinear_bwd: {name} must be ({N}, "
                                 f"{width}), got {tuple(g.shape)}")
    grad = torch.zeros((H, W, D, C), dtype=torch.float32, device=hwd.device)
    if grad_vals is None and grad_grad0 is None:
        return grad.permute(3, 0, 1, 2)
    lib = _build.load("trilinear", _SIGNATURES)
    status = lib.trilinear_bwd(
        _build.ptr(hwd), _optional_ptr(grad_vals), _optional_ptr(grad_grad0),
        _build.ptr(grad), N, C, H, W, D, _build.stream_ptr(hwd.device))
    _build.check(status, "trilinear_bwd")
    trilinear_bwd.launches += 1
    trilinear_bwd.plane_launches += C == 1
    return grad.permute(3, 0, 1, 2)


def _optional_ptr(t):
    return _build.ptr(t) if t is not None else None


trilinear_bwd.launches = 0
trilinear_bwd.plane_launches = 0
_SIGNATURES["trilinear_bwd"] = (
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32,
    _build.I32, _build.I32, _build.I32, _build.PTR)


class _TrilinearWithGrad(torch.autograd.Function):
    """The kernels on a CUDA volume, the plain versions on a CPU volume;
    (N, 3) points that need no gradient."""

    @staticmethod
    def forward(ctx, vol_cf, hwd, padding):
        if hwd.requires_grad:
            raise NotImplementedError(
                "trilinear_sample_cf_with_grad: no gradient with respect to "
                "the points is ported (detach them)")
        ctx.padding = padding
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(vol_cf, hwd)
        if vol_cf.is_cuda:
            return trilinear_cf_with_grad_fwd(vol_cf, hwd)
        return trilinear_sample_cf_with_grad_plain(vol_cf, hwd, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_vals, grad_grad0):
        vol_cf, hwd = ctx.saved_tensors
        if vol_cf.is_cuda:
            grad_vol = trilinear_bwd(
                vol_cf, hwd,
                None if grad_vals is None else grad_vals.contiguous(),
                None if grad_grad0 is None else grad_grad0.contiguous())
        else:
            grad_vol = trilinear_bwd_plain(vol_cf, hwd, grad_vals,
                                           grad_grad0, ctx.padding)
        return grad_vol, None, None


def trilinear_sample_cf_with_grad(vol_cf: torch.Tensor, hwd: torch.Tensor,
                                  padding: str = "zeros"):
    """Channel-first trilinear sampling with the analytic gradient of
    channel 0. vol (C, H, W, D) in any layout (a channel-last one is read
    as it is, any other copied: ``kernel_volume``), hwd (..., 3) -> vals
    (..., C) fp32, grad0 (..., 3) fp32 (d channel0 / d(h, w, d)); both
    differentiable with respect to the volume."""
    if vol_cf.dim() != 4 or hwd.shape[-1] != 3:
        raise ValueError("trilinear_sample_cf_with_grad: expected a (C, H, W,"
                         f" D) volume and (..., 3) points, got "
                         f"{tuple(vol_cf.shape)} / {tuple(hwd.shape)}")
    if vol_cf.is_cuda and padding != "zeros":
        raise ValueError("the CUDA trilinear kernel implements zeros padding")
    pts_shape = hwd.shape[:-1]
    vals, grad0 = _TrilinearWithGrad.apply(
        kernel_volume(vol_cf.float()),
        hwd.reshape(-1, 3).float().contiguous(), padding)
    return (vals.reshape(*pts_shape, vol_cf.shape[0]),
            grad0.reshape(*pts_shape, 3))
