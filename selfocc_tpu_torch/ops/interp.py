"""Bilinear / trilinear interpolation — counterpart of
``selfocc_tpu/ops/interp.py``.

Conventions are the JAX package's: the public functions take **fractional
indices** under ``align_corners=True`` (0 .. size-1), not [-1, 1] grids, and
volumes have the channel-first shape ``(C, H, W, D)``.

``trilinear_sample_cf`` (values only; the occupancy query) and
``trilinear_sample`` (a channel-last volume; the Occ3D resample) launch the
values-only kernel ``trilinear_cf_fwd`` for a CUDA volume and take
``trilinear_sample_cf_plain`` for a CPU one; ``lerp_axis_cf`` and
``separable_grid_resample_cf`` (the separable occupancy query) are plain
torch ops.

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


def trilinear_sample_cf_plain(vol_cf: torch.Tensor, hwd: torch.Tensor,
                              padding: str = "zeros") -> torch.Tensor:
    """Plain PyTorch version of ``trilinear_cf_fwd`` (``interp.py:118``):
    vol (C, H, W, D), hwd (..., 3) fractional indices -> (..., C)."""
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


def trilinear_sample_cf(vol_cf: torch.Tensor, hwd: torch.Tensor,
                        padding: str = "zeros") -> torch.Tensor:
    """Values-only trilinear sampling (``interp.py:118``): vol (C, H, W, D),
    hwd (..., 3) fractional indices -> (..., C) fp32. A CUDA volume
    launches ``trilinear_cf_fwd`` (zeros padding, no gradient), reading a
    channel-last volume in place, rows of a wider channel-last tensor
    included (``row_stride``), and copying any other layout; a CPU volume
    takes ``trilinear_sample_cf_plain``."""
    if not vol_cf.is_cuda:
        return trilinear_sample_cf_plain(vol_cf, hwd, padding)
    if padding != "zeros":
        raise ValueError("the CUDA trilinear kernel implements zeros padding")
    if torch.is_grad_enabled() and vol_cf.requires_grad:
        raise NotImplementedError(
            "trilinear_sample_cf: the values-only kernel has no backward "
            "(use trilinear_sample_cf_with_grad)")
    vol = vol_cf.float()
    if row_stride(vol) is None:
        vol = kernel_volume(vol)
    vals = trilinear_cf_fwd(vol, hwd.reshape(-1, 3).float().contiguous())
    return vals.reshape(*hwd.shape[:-1], vol_cf.shape[0])


def trilinear_sample(vol: torch.Tensor, hwd: torch.Tensor,
                     padding: str = "zeros") -> torch.Tensor:
    """Sample a channel-last (H, W, D, C) volume at (..., 3) fractional
    (h, w, d) indices -> (..., C) (``interp.py:73``): the same interpolant
    as ``trilinear_sample_cf`` on its (C, H, W, D) view, which on the card
    reads the channel-last memory where it lies."""
    return trilinear_sample_cf(vol.permute(3, 0, 1, 2), hwd, padding)


def lerp_axis_cf(vol_cf: torch.Tensor, g: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Linear interpolation of a volume along ONE axis at fractional
    indices ``g`` (1-D), zeros outside ``[0, size - 1]``; that axis is
    resized to ``g.shape[0]`` (``interp.py:361``). Element for element the
    JAX function's arithmetic, on any layout: the result takes the
    input's order of dimensions in memory."""
    size = vol_cf.shape[axis]
    i0 = torch.floor(g)
    f = (g - i0).to(vol_cf.dtype)
    i0i = i0.long()
    w0 = (1.0 - f) * ((i0i >= 0) & (i0i <= size - 1))
    w1 = f * ((i0i + 1 >= 0) & (i0i + 1 <= size - 1))
    v0 = vol_cf.index_select(axis, i0i.clamp(0, size - 1))
    v1 = vol_cf.index_select(axis, (i0i + 1).clamp(0, size - 1))
    shape = [1] * vol_cf.dim()
    shape[axis] = g.shape[0]
    return v0 * w0.reshape(shape) + v1 * w1.reshape(shape)


def separable_grid_resample_cf(vol_cf: torch.Tensor, gh: torch.Tensor,
                               gw: torch.Tensor,
                               gd: torch.Tensor) -> torch.Tensor:
    """Trilinear sampling of a (C, H, W, D) volume on the separable index
    grid ``gh`` x ``gw`` x ``gd`` -> (C, Ho, Wo, Do) (``interp.py:379``):
    three per-axis lerps, h then w then d, as in the JAX function. They run
    on the channel-last view, so a channel-last volume gives a channel-last
    result (a permuted view, as ``field.decode``'s), which the Occ3D
    resample reads in place."""
    out = vol_cf.permute(1, 2, 3, 0)
    out = lerp_axis_cf(out, gh, 0)
    out = lerp_axis_cf(out, gw, 1)
    return lerp_axis_cf(out, gd, 2).permute(3, 0, 1, 2)


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


def row_stride(vol_cf: torch.Tensor):
    """The floats from one voxel's channels to the next voxel's when the
    (C, H, W, D) volume is channel-last with its channels contiguous: C for
    a contiguous channel-last volume, more for a slice of channels of a
    wider one. None for any other layout."""
    C, H, W, D = vol_cf.shape
    cl = vol_cf.permute(1, 2, 3, 0)
    sh, sw, sd, _ = cl.stride()
    row = sd if D > 1 else sw if W > 1 else sh if H > 1 else C
    want = (W * D * row, D * row, row, 1)
    ok = row >= C and all(n == 1 or st == w for n, st, w in
                          zip(cl.shape, cl.stride(), want))
    return row if ok else None


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


def trilinear_cf_fwd(vol_cf: torch.Tensor, hwd: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/trilinear.cu::trilinear_cf_fwd``, the values-only
    forward: an fp32 CUDA (C, H, W, D) volume that is channel-last with
    contiguous channels and any row stride (``row_stride``), (N, 3)
    fractional indices, zeros padding -> vals (N, C). C = 1 takes the plane
    kernel (``plane_launches``), any other C the rows kernel."""
    if not vol_cf.is_cuda or vol_cf.dtype != torch.float32 \
            or vol_cf.dim() != 4:
        raise ValueError("trilinear_cf_fwd: expected an fp32 CUDA (C, H, W, "
                         f"D) volume, got {vol_cf.dtype} {vol_cf.device} "
                         f"{tuple(vol_cf.shape)}")
    row = row_stride(vol_cf)
    if row is None:
        raise ValueError("trilinear_cf_fwd: the volume must be channel-last "
                         "with contiguous channels (kernel_volume)")
    _build.require_cuda_tensor(hwd, "trilinear_cf_fwd points",
                               torch.float32, 2)
    if hwd.shape[1] != 3 or hwd.device != vol_cf.device:
        raise ValueError("trilinear_cf_fwd: points must be (N, 3) on the "
                         "volume's device")
    lib = _build.load("trilinear", _SIGNATURES)
    C, H, W, D = vol_cf.shape
    N = hwd.shape[0]
    vals = torch.empty((N, C), dtype=torch.float32, device=hwd.device)
    status = lib.trilinear_cf_fwd(
        _build.ptr(vol_cf), _build.ptr(hwd), _build.ptr(vals), N, C, H, W, D,
        row, _build.stream_ptr(hwd.device))
    _build.check(status, "trilinear_cf_fwd")
    trilinear_cf_fwd.launches += 1
    trilinear_cf_fwd.plane_launches += C == 1
    return vals


trilinear_cf_fwd.launches = 0
trilinear_cf_fwd.plane_launches = 0
_SIGNATURES["trilinear_cf_fwd"] = (
    _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32, _build.I32,
    _build.I32, _build.I32, _build.I64, _build.PTR)


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
