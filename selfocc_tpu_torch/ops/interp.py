"""Bilinear / trilinear interpolation — counterpart of
``selfocc_tpu/ops/interp.py``.

Conventions are the JAX package's: the public functions take **fractional
indices** under ``align_corners=True`` (0 .. size-1), not [-1, 1] grids, and
volumes are channel-first ``(C, H, W, D)``.

``trilinear_sample_cf_with_grad`` is the render's hot loop. For a CUDA volume
it launches ``csrc/trilinear.cu`` (one thread per point, zeros padding); for a
CPU volume it takes the plain version ``trilinear_sample_cf_with_grad_plain``.
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


def trilinear_cf_with_grad_fwd(vol_cf: torch.Tensor, hwd: torch.Tensor):
    """Launch ``csrc/trilinear.cu``: fp32 CUDA (C, H, W, D) volume, (N, 3)
    fractional indices, zeros padding -> vals (N, C), grad0 (N, 3)."""
    _build.require_cuda_tensor(vol_cf, "trilinear_cf_with_grad_fwd volume",
                               torch.float32, 4)
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
    return vals, grad0


trilinear_cf_with_grad_fwd.launches = 0
_SIGNATURES = {"trilinear_cf_with_grad_fwd": (
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32,
    _build.I32, _build.I32, _build.I32, _build.PTR)}


def trilinear_sample_cf_with_grad(vol_cf: torch.Tensor, hwd: torch.Tensor,
                                  padding: str = "zeros"):
    """Channel-first trilinear sampling with the analytic gradient of
    channel 0. vol (C, H, W, D), hwd (..., 3) -> vals (..., C) fp32,
    grad0 (..., 3) fp32 (d channel0 / d(h, w, d))."""
    if vol_cf.dim() != 4 or hwd.shape[-1] != 3:
        raise ValueError("trilinear_sample_cf_with_grad: expected a (C, H, W,"
                         f" D) volume and (..., 3) points, got "
                         f"{tuple(vol_cf.shape)} / {tuple(hwd.shape)}")
    if not vol_cf.is_cuda:
        return trilinear_sample_cf_with_grad_plain(vol_cf, hwd, padding)
    if padding != "zeros":
        raise ValueError("the CUDA trilinear kernel implements zeros padding")
    pts_shape = hwd.shape[:-1]
    vals, grad0 = trilinear_cf_with_grad_fwd(
        vol_cf.float().contiguous(), hwd.reshape(-1, 3).float().contiguous())
    return (vals.reshape(*pts_shape, vol_cf.shape[0]),
            grad0.reshape(*pts_shape, 3))
