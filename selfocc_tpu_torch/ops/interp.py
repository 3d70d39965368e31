"""Bilinear / trilinear interpolation — counterpart of
``selfocc_tpu/ops/interp.py``.

Conventions are the JAX package's: the public functions take **fractional
indices** under ``align_corners=True`` (0 .. size-1), not [-1, 1] grids, and
volumes have the channel-first shape ``(C, H, W, D)``.

``trilinear_sample_cf`` (values only: the occupancy query, the uniform
sdf grid of ``SoftSparsityLoss``, the compact second derivative's sdf
taps and, with ``"border"`` padding at C = 3, the flow head's lookup) and
``trilinear_sample`` (a channel-last volume; the Occ3D resample, the flow
lookup) launch the values-only kernel ``trilinear_cf_fwd`` for a CUDA
volume and take ``trilinear_sample_cf_plain`` for a CPU one. Where the
CUDA volume needs a gradient, ``_TrilinearValues`` pairs that forward with
the values-only backward ``trilinear_cf_bwd``; on the CPU autograd runs
through the plain version. Points that need a gradient (the importance
rounds' sdf queries, the surface sdf) get the cotangent JAX autodiff gives
the fractional indices, from the backward's point instance. ``"border"``
padding is JAX's (``interp.py:131-150``): each index clipped by a maximum
and a minimum, whose gradient splits a tie as ``jnp.clip``'s does, and the
upper corners clamped onto the face rows; on the card the narrow instances
(C <= 3) clip in the kernel.
``lerp_axis_cf`` and ``separable_grid_resample_cf`` (the separable
occupancy query) are plain torch ops.

``trilinear_sample_cf_with_grad`` is the render's hot loop. It is
differentiable with respect to the volume, from both of its outputs
(``_TrilinearWithGrad``): for a CUDA volume its forward and backward launch
``csrc/trilinear.cu`` (``trilinear_cf_with_grad_fwd``, ``trilinear_bwd``,
zeros padding); for a CPU volume they take the plain versions
(``trilinear_sample_cf_with_grad_plain`` and ``trilinear_bwd_plain``,
autograd through it). Points that need a gradient (the samples placed by
the importance rounds) get theirs from both outputs: ``trilinear_bwd``'s
point instance on the card, the plain version's autograd on the CPU.

The kernels read a channel-last volume: ``(H, W, D, C)`` in memory, seen as
``(C, H, W, D)`` through a permute, so that a corner's channels are one
contiguous row. ``field.decode`` produces that layout; ``kernel_volume``
passes it through and copies any other, ``channel0_view`` takes the sdf
channel of it as a view at the volume's row stride and ``first_channel`` as
a contiguous plane, both with a gradient in the same layout.
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
        x = _clip(x, W - 1.0)
        y = _clip(y, H - 1.0)
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


def _clip(x: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.clip(x, 0, hi)``: a maximum, then a minimum, whose gradients
    pass half at a tie (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), hi))


def _corners(vol_cf, hwd, padding):
    """Per-corner (flat index, weight, mask, axis weights) for a (C, H, W, D)
    volume at (N, 3) fractional indices — the reference's loop order."""
    C, H, W, D = vol_cf.shape
    h, w, d = hwd[:, 0], hwd[:, 1], hwd[:, 2]
    if padding == "border":
        h = _clip(h, H - 1.0)
        w = _clip(w, W - 1.0)
        d = _clip(d, D - 1.0)
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
    hwd (..., 3) fractional indices -> (..., C) fp32, differentiable with
    respect to the volume and the points. A CUDA volume launches
    ``trilinear_cf_fwd`` (``"border"`` padding at C <= 3, in the narrow
    instances), reading a channel-last volume in place, rows of a wider
    channel-last tensor included (``row_stride``), and copying any other
    layout; where it needs a gradient, the backward launches
    ``trilinear_cf_bwd``. A CPU volume takes ``trilinear_sample_cf_plain``,
    with autograd through it."""
    if not vol_cf.is_cuda:
        return trilinear_sample_cf_plain(vol_cf, hwd, padding)
    vol = vol_cf.float()
    if row_stride(vol) is None:
        vol = kernel_volume(vol)
    pts = hwd.reshape(-1, 3).float().contiguous()
    if torch.is_grad_enabled() and (vol.requires_grad or pts.requires_grad):
        vals = _TrilinearValues.apply(vol, pts, padding)
    else:
        vals = trilinear_cf_fwd(vol, pts, padding)
    return vals.reshape(*hwd.shape[:-1], vol_cf.shape[0])


def trilinear_sample(vol: torch.Tensor, hwd: torch.Tensor,
                     padding: str = "zeros") -> torch.Tensor:
    """Sample a channel-last (H, W, D, C) volume at (..., 3) fractional
    (h, w, d) indices -> (..., C) (``interp.py:73``): the same interpolant
    as ``trilinear_sample_cf`` on its (C, H, W, D) view, which on the card
    reads the channel-last memory where it lies."""
    return trilinear_sample_cf(vol.permute(3, 0, 1, 2), hwd, padding)


def trilinear_sample_taps(vol_cf: torch.Tensor,
                          hwd: torch.Tensor) -> torch.Tensor:
    """``trilinear_sample_cf`` at (..., T, 3) taps of each point, zeros
    padding -> (..., T, C): one values-only query for all T taps, so that a
    CUDA volume takes one forward and one backward launch. A CPU volume
    takes the same query through ``_TapsPlain``, whose backward sums the
    taps' cotangents in the order of T queries of their own (the JAX
    package's order), for the CPU parity tests of the compact second
    derivative against the JAX field (``test_torch_port_values.py``,
    ``test_torch_port_train.py::test_second_grad_matches_jax``)."""
    if vol_cf.is_cuda:
        return trilinear_sample_cf(vol_cf, hwd, "zeros")
    return _TapsPlain.apply(vol_cf, hwd)


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


def channel0_view(vol_cf: torch.Tensor) -> torch.Tensor:
    """Channel 0 of a (C, H, W, D) volume as a (1, H, W, D) view, without a
    copy: on a channel-last volume the values one row stride apart
    (``row_stride``). It is sliced on the (H, W, D, C) view, so that
    autograd's zero-filled gradient of the slice is channel-last too and
    adds to the volume's other gradients without a transpose."""
    return vol_cf.permute(1, 2, 3, 0)[..., :1].permute(3, 0, 1, 2)


def first_channel(vol_cf: torch.Tensor) -> torch.Tensor:
    """Channel 0 of a (C, H, W, D) volume as a contiguous (1, H, W, D)
    plane, the sdf queries' volume. A channel-first volume gives a slice,
    a channel-last one a copy of ``channel0_view``."""
    if vol_cf.is_contiguous():
        return vol_cf[:1]
    return kernel_volume(channel0_view(vol_cf))


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


TRILINEAR_CF_MAX_CHANNELS = 2048   # the rows forward stages 4 points' rows
NARROW_MAX_CHANNELS = 3            # csrc/trilinear.cu: kNarrowMax


def _border(padding: str, C: int, name: str, instance: str) -> bool:
    """Whether ``padding`` is ``"border"``, which the values-only kernels
    implement in their narrow instances alone (C <= 3)."""
    if padding not in ("zeros", "border"):
        raise ValueError(f"{name}: padding must be 'zeros' or 'border', got "
                         f"{padding!r}")
    if padding == "border" and C > NARROW_MAX_CHANNELS:
        raise ValueError(f"{name}: 'border' padding is the narrow instance's "
                         f"({instance}, C <= {NARROW_MAX_CHANNELS}), got "
                         f"C = {C}")
    return padding == "border"


def _narrow(C: int, border: bool) -> bool:
    """The launchers' choice of the narrow instances: C <= 3 but for C = 1
    with zeros padding, which the plane kernels take."""
    return C <= NARROW_MAX_CHANNELS and (C > 1 or border)


def trilinear_cf_fwd(vol_cf: torch.Tensor, hwd: torch.Tensor,
                     padding: str = "zeros") -> torch.Tensor:
    """Launch ``csrc/trilinear.cu::trilinear_cf_fwd``, the values-only
    forward: an fp32 CUDA (C, H, W, D) volume that is channel-last with
    contiguous channels and any row stride (``row_stride``), (N, 3)
    fractional indices, ``padding`` -> vals (N, C). C = 1 with zeros
    padding takes the plane kernel (``plane_launches``); C <= 3 otherwise
    the narrow instance (``narrow_launches``), the only one with
    ``"border"`` padding, which clips the points itself; any other C a
    rows kernel."""
    border = _border(padding, vol_cf.shape[0], "trilinear_cf_fwd",
                     "values_fwd_narrow_kernel")
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
    C, H, W, D = vol_cf.shape
    if C > TRILINEAR_CF_MAX_CHANNELS:
        raise ValueError(f"trilinear_cf_fwd: at most "
                         f"{TRILINEAR_CF_MAX_CHANNELS} channels, got {C}")
    lib = _build.load("trilinear", _SIGNATURES)
    N = hwd.shape[0]
    vals = torch.empty((N, C), dtype=torch.float32, device=hwd.device)
    status = lib.trilinear_cf_fwd(
        _build.ptr(vol_cf), _build.ptr(hwd), _build.ptr(vals), N, C, H, W, D,
        row, int(border), _build.stream_ptr(hwd.device))
    _build.check(status, "trilinear_cf_fwd")
    trilinear_cf_fwd.launches += 1
    trilinear_cf_fwd.plane_launches += C == 1 and not border
    trilinear_cf_fwd.narrow_launches += _narrow(C, border)
    return vals


trilinear_cf_fwd.launches = 0
trilinear_cf_fwd.plane_launches = 0
trilinear_cf_fwd.narrow_launches = 0
_SIGNATURES["trilinear_cf_fwd"] = (
    _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32, _build.I32,
    _build.I32, _build.I32, _build.I64, _build.I32, _build.PTR)


def trilinear_bwd_plain(vol_cf, hwd, grad_vals, grad_grad0,
                        padding: str = "zeros", points: bool = False):
    """Plain PyTorch version of ``trilinear_bwd``: autograd through
    ``trilinear_sample_cf_with_grad_plain``; either cotangent may be None.
    With ``points``, (the volume's cotangent, the points' (N, 3))."""
    with torch.enable_grad():
        vol = vol_cf.detach().requires_grad_(True)
        pts = hwd.detach().requires_grad_(points)
        vals, grad0 = trilinear_sample_cf_with_grad_plain(vol, pts, padding)
        outs = [(o, g) for o, g in ((vals, grad_vals), (grad0, grad_grad0))
                if g is not None]
        leaves = (vol, pts) if points else (vol,)
        if not outs:
            got = tuple(torch.zeros_like(t) for t in leaves)
        else:
            got = torch.autograd.grad([o for o, _ in outs], leaves,
                                      [g for _, g in outs],
                                      allow_unused=True)
            got = tuple(torch.zeros_like(t) if g is None else g
                        for g, t in zip(got, leaves))
        return got if points else got[0]


def trilinear_bwd(vol_cf: torch.Tensor, hwd: torch.Tensor, grad_vals,
                  grad_grad0, points: bool = False):
    """Launch ``csrc/trilinear.cu::trilinear_bwd``: the (C, H, W, D)
    cotangent of a volume in the kernels' layout, in that layout, for
    cotangents ``grad_vals`` (N, C) and ``grad_grad0`` (N, 3) of
    ``trilinear_cf_with_grad_fwd`` (either may be None; with neither, zeros
    and no launch), zeros padding. The kernel accumulates into the
    zero-filled result itself; C = 1 takes the plane kernel
    (``plane_launches``), any other C the rows kernel. ``points``: the
    point instance (``points_launches``), which also reads the volume's
    corner rows and returns (the volume's cotangent, the points' (N, 3)).
    At C = 1 it is ``_plane_points`` (segments into an fp64 plane); at
    C > 1 (``trilinear_bwd_points``) its dots with the corner rows are
    taken in the rows kernel's walk (``points_walk_launches``), which sums
    the volume's cotangent on cells that many points share in fp64
    (``_hot_rows``) and adds those sums to the result."""
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
    if grad_vals is None and grad_grad0 is None:
        grad = torch.zeros((H, W, D, C), dtype=torch.float32,
                           device=hwd.device).permute(3, 0, 1, 2)
        return (grad, torch.zeros_like(hwd)) if points else grad
    if points and C == 1:
        grad, gpts = _plane_points(vol_cf, 1, hwd, grad_vals, grad_grad0,
                                   "trilinear_bwd")
    else:
        grad = torch.zeros((H, W, D, C), dtype=torch.float32,
                           device=hwd.device)
        lib = _build.load("trilinear", _SIGNATURES)
        if points:
            gpts = torch.empty((N, 3), dtype=torch.float32, device=hwd.device)
            hot = _hot_rows(C, H, W, D, hwd.device)
            status = lib.trilinear_bwd_points(
                _build.ptr(vol_cf), _build.ptr(hwd),
                _optional_ptr(grad_vals), _optional_ptr(grad_grad0),
                _build.ptr(grad), _build.ptr(gpts), N, C, H, W, D,
                *map(_build.ptr, hot), _build.stream_ptr(hwd.device))
        else:
            status = lib.trilinear_bwd(
                _build.ptr(hwd), _optional_ptr(grad_vals),
                _optional_ptr(grad_grad0), _build.ptr(grad), N, C, H, W, D,
                _build.stream_ptr(hwd.device))
        _build.check(status, "trilinear_bwd")
    trilinear_bwd.launches += 1
    trilinear_bwd.plane_launches += C == 1
    trilinear_bwd.points_launches += points
    trilinear_bwd.points_walk_launches += points and C > 1
    grad = grad.permute(3, 0, 1, 2)
    return (grad, gpts) if points else grad


def _optional_ptr(t):
    return _build.ptr(t) if t is not None else None


HOT_SLOTS = 1 << 15   # csrc/trilinear.cu: kHotSlots


def _hot_rows(C, H, W, D, device):
    """The C > 1 point instances' scratch for hot cells (``hot_add`` in
    ``csrc/trilinear.cu``): the points in each cell (H W D int32, zero),
    HOT_SLOTS voxel keys (-1 while free) and as many rows of C fp64 sums
    (zero). The C = 1 instances take ``_plane_points``' one fp64 plane."""
    return (torch.zeros((H, W, D), dtype=torch.int32, device=device),
            torch.full((HOT_SLOTS,), -1, dtype=torch.int32, device=device),
            torch.zeros((HOT_SLOTS, C), dtype=torch.float64, device=device))


def _plane_points(vol_cf, row, hwd, grad_vals, grad_grad0, name):
    """The C = 1 point instances (``csrc/trilinear.cu::
    trilinear_plane_points_bwd``): the volume's cotangent, a (1, H, W, D)
    view of an (H, W, D, 1) tensor, and the points' (N, 3), for the plane
    ``vol_cf`` read at ``row`` floats between voxels, (N, 3) points and the
    cotangents of the values (N, 1) and of grad0 (N, 3; None for the
    values-only instance), either of which may be None. Per call one fill
    (the zeroed fp64 plane that the kernel sums into) and two kernels: the
    segments and the fold into the fp32 gradient, which writes every
    element."""
    _, H, W, D = vol_cf.shape
    N = hwd.shape[0]
    dev = hwd.device
    acc = torch.zeros((H, W, D), dtype=torch.float64, device=dev)
    grad = torch.empty((H, W, D, 1), dtype=torch.float32, device=dev)
    gpts = torch.empty((N, 3), dtype=torch.float32, device=dev)
    lib = _build.load("trilinear", _SIGNATURES)
    status = lib.trilinear_plane_points_bwd(
        _build.ptr(vol_cf), row, _build.ptr(hwd), _optional_ptr(grad_vals),
        _optional_ptr(grad_grad0), _build.ptr(acc), _build.ptr(grad),
        _build.ptr(gpts), N, H, W, D, _build.stream_ptr(dev))
    _build.check(status, name)
    return grad, gpts


trilinear_bwd.launches = 0
trilinear_bwd.plane_launches = 0
trilinear_bwd.points_launches = 0
trilinear_bwd.points_walk_launches = 0
_SIGNATURES["trilinear_bwd"] = (
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32,
    _build.I32, _build.I32, _build.I32, _build.PTR)
_SIGNATURES["trilinear_plane_points_bwd"] = (
    _build.PTR, _build.I64, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
    _build.PTR, _build.PTR, _build.I64, _build.I32, _build.I32, _build.I32,
    _build.PTR)
_SIGNATURES["trilinear_bwd_points"] = (
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
    _build.I64, _build.I32, _build.I32, _build.I32, _build.I32, _build.PTR,
    _build.PTR, _build.PTR, _build.PTR)


def trilinear_cf_bwd_plain(vol_cf, hwd, grad_vals, points: bool = False,
                           padding: str = "zeros"):
    """Plain PyTorch version of ``trilinear_cf_bwd``: autograd through
    ``trilinear_sample_cf_plain`` with ``padding``. With ``points``, (the
    volume's cotangent, the points' cotangent, shaped as ``hwd``)."""
    with torch.enable_grad():
        vol = vol_cf.detach().requires_grad_(True)
        pts = hwd.detach().requires_grad_(points)
        vals = trilinear_sample_cf_plain(vol, pts, padding)
        if points:
            return torch.autograd.grad(vals, (vol, pts), grad_vals)
        return torch.autograd.grad(vals, vol, grad_vals)[0]


def trilinear_cf_bwd(vol_shape, hwd: torch.Tensor, grad_vals: torch.Tensor,
                     vol_cf=None, padding: str = "zeros"):
    """Launch ``csrc/trilinear.cu::trilinear_cf_bwd``, the backward of
    ``trilinear_cf_fwd``: ``vol_shape`` (C, H, W, D), (N, 3) fractional
    indices and ``grad_vals`` (N, C), ``padding`` -> the volume's cotangent
    as a (C, H, W, D) view of a contiguous channel-last (H, W, D, C) tensor.
    A row-strided forward (channel 0 of a wider volume, ``channel0_view``)
    gets this gradient of its C channels; autograd's backward of the slice
    scatters it into the wider volume's channel-last gradient. C = 1 with
    zeros padding takes the plane kernel (``plane_launches``); C <= 3
    otherwise the narrow instance (``narrow_launches``: lanes over points,
    each run of one cell summed by a segmented shuffle scan, then one
    float4 atomic a corner row into a zeroed (H, W, D, 4) scratch, which a
    second kernel folds into the gradient), the only one with ``"border"``
    padding, which clips the points itself; a C that is a multiple of 4,
    with 16-byte-aligned ``grad_vals``, the float4 rows kernel; any other
    C > 3 the walk kernel (``walk_launches``), which sums each run of
    points in one cell before its atomics. All but the narrow instance
    accumulate into the gradient after a zero fill.

    ``vol_cf``: the forward's volume (fp32, CUDA, ``row_stride``), for the
    point instance (``points_launches``): it reads each point's corners and
    returns (the volume's cotangent, the points' (N, 3)); at C = 1 with
    zeros padding that is ``_plane_points``, at C <= 3 otherwise the narrow
    instance (with ``"border"``, times the clip's derivative: 1 inside, 0.5
    at a tie, 0 outside), at C > 3 the walk kernel
    (``trilinear_cf_bwd_points``)."""
    C, H, W, D = vol_shape
    border = _border(padding, C, "trilinear_cf_bwd",
                     "values_bwd_narrow_kernel")
    narrow = _narrow(C, border)
    _build.require_cuda_tensor(hwd, "trilinear_cf_bwd points", torch.float32,
                               2)
    _build.require_cuda_tensor(grad_vals, "trilinear_cf_bwd grad_vals",
                               torch.float32, 2)
    N = hwd.shape[0]
    if hwd.shape[1] != 3 or tuple(grad_vals.shape) != (N, C) \
            or grad_vals.device != hwd.device:
        raise ValueError(f"trilinear_cf_bwd: expected (N, 3) points and "
                         f"({N}, {C}) grad_vals on one device, got "
                         f"{tuple(hwd.shape)} / {tuple(grad_vals.shape)}")
    if vol_cf is not None:
        row = row_stride(vol_cf)
        if row is None or tuple(vol_cf.shape) != tuple(vol_shape) or \
                not vol_cf.is_cuda or vol_cf.dtype != torch.float32:
            raise ValueError("trilinear_cf_bwd: the points' cotangent needs "
                             "the forward's fp32 CUDA volume, channel-last")
    if vol_cf is not None and C == 1 and not border:
        grad, gpts = _plane_points(vol_cf, row, hwd, grad_vals, None,
                                   "trilinear_cf_bwd")
    else:
        # the narrow instances sum into a zeroed (H, W, D, 4) scratch and
        # write every element of the gradient; the others accumulate into it
        grad = (torch.empty if narrow else torch.zeros)(
            (H, W, D, C), dtype=torch.float32, device=hwd.device)
        acc = torch.zeros((H, W, D, 4), dtype=torch.float32,
                          device=hwd.device) if narrow else None
        lib = _build.load("trilinear", _SIGNATURES)
        if vol_cf is not None:
            gpts = torch.empty((N, 3), dtype=torch.float32, device=hwd.device)
            hot = (None,) * 3 if narrow else _hot_rows(C, H, W, D, hwd.device)
            status = lib.trilinear_cf_bwd_points(
                _build.ptr(vol_cf), row, _build.ptr(hwd),
                _build.ptr(grad_vals), _build.ptr(grad), _optional_ptr(acc),
                _build.ptr(gpts), N, C, H, W, D, *map(_optional_ptr, hot),
                int(border), _build.stream_ptr(hwd.device))
        else:
            status = lib.trilinear_cf_bwd(
                _build.ptr(hwd), _build.ptr(grad_vals), _build.ptr(grad),
                _optional_ptr(acc), N, C, H, W, D, int(border),
                _build.stream_ptr(hwd.device))
        _build.check(status, "trilinear_cf_bwd")
    trilinear_cf_bwd.launches += 1
    trilinear_cf_bwd.plane_launches += C == 1 and not border
    trilinear_cf_bwd.narrow_launches += narrow
    trilinear_cf_bwd.points_launches += vol_cf is not None
    # the launcher's choice in csrc/trilinear.cu::trilinear_cf_bwd
    trilinear_cf_bwd.walk_launches += C > NARROW_MAX_CHANNELS and (
        vol_cf is not None or C % 4 != 0
        or grad_vals.data_ptr() % 16 != 0 or grad.data_ptr() % 16 != 0)
    grad = grad.permute(3, 0, 1, 2)
    return (grad, gpts) if vol_cf is not None else grad


trilinear_cf_bwd.launches = 0
trilinear_cf_bwd.plane_launches = 0
trilinear_cf_bwd.narrow_launches = 0
trilinear_cf_bwd.points_launches = 0
trilinear_cf_bwd.walk_launches = 0
_SIGNATURES["trilinear_cf_bwd_points"] = (
    _build.PTR, _build.I64, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
    _build.PTR, _build.I64, _build.I32, _build.I32, _build.I32, _build.I32,
    _build.PTR, _build.PTR, _build.PTR, _build.I32, _build.PTR)
_SIGNATURES["trilinear_cf_bwd"] = (
    _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.I64, _build.I32,
    _build.I32, _build.I32, _build.I32, _build.I32, _build.PTR)


class _TrilinearValues(torch.autograd.Function):
    """``trilinear_cf_fwd`` and ``trilinear_cf_bwd`` on a CUDA volume or
    (N, 3) points that need a gradient; points that do get theirs from the
    backward's point instance."""

    @staticmethod
    def forward(ctx, vol_cf, hwd, padding="zeros"):
        ctx.vol_shape = tuple(vol_cf.shape)
        ctx.points = hwd.requires_grad
        ctx.padding = padding
        ctx.save_for_backward(hwd, vol_cf if ctx.points else None)
        return trilinear_cf_fwd(vol_cf, hwd, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_vals):
        hwd, vol_cf = ctx.saved_tensors
        if ctx.points:
            return (*trilinear_cf_bwd(ctx.vol_shape, hwd,
                                      grad_vals.contiguous(), vol_cf,
                                      ctx.padding), None)
        return trilinear_cf_bwd(ctx.vol_shape, hwd, grad_vals.contiguous(),
                                padding=ctx.padding), None, None


class _TapsPlain(torch.autograd.Function):
    """The taps' one query of a CPU volume. Its backward sums the taps'
    cotangents one tap at a time, from the last to the first, as autograd
    sums T queries of their own: the second derivative's stencil cancels
    terms of order 1 / delta^2, so the order of that sum moves the volume's
    cotangent by more than fp32 rounding of its result. (The card's one
    backward launch sums in the order its atomics land.)"""

    @staticmethod
    def forward(ctx, vol_cf, hwd):
        ctx.save_for_backward(vol_cf, hwd)
        return trilinear_sample_cf(vol_cf, hwd, "zeros")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        vol_cf, hwd = ctx.saved_tensors
        points = ctx.needs_input_grad[1]
        total, g_pts = None, [None] * hwd.shape[-2]
        for t in reversed(range(hwd.shape[-2])):
            g = trilinear_cf_bwd_plain(vol_cf, hwd[..., t, :],
                                       grad[..., t, :], points)
            if points:
                g, g_pts[t] = g
            total = g if total is None else total + g
        return total, torch.stack(g_pts, -2) if points else None


class _TrilinearWithGrad(torch.autograd.Function):
    """The kernels on a CUDA volume, the plain versions on a CPU volume;
    (N, 3) points that need a gradient get theirs from the backward's point
    instance (on the CPU, the plain version's autograd)."""

    @staticmethod
    def forward(ctx, vol_cf, hwd, padding):
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
        points = ctx.needs_input_grad[1]
        if vol_cf.is_cuda:
            got = trilinear_bwd(
                vol_cf, hwd,
                None if grad_vals is None else grad_vals.contiguous(),
                None if grad_grad0 is None else grad_grad0.contiguous(),
                points)
        else:
            got = trilinear_bwd_plain(vol_cf, hwd, grad_vals, grad_grad0,
                                      ctx.padding, points)
        grad_vol, grad_pts = got if points else (got, None)
        return grad_vol, grad_pts, None


def trilinear_sample_cf_with_grad(vol_cf: torch.Tensor, hwd: torch.Tensor,
                                  padding: str = "zeros"):
    """Channel-first trilinear sampling with the analytic gradient of
    channel 0. vol (C, H, W, D) in any layout (a channel-last one is read
    as it is, any other copied: ``kernel_volume``), hwd (..., 3) -> vals
    (..., C) fp32, grad0 (..., 3) fp32 (d channel0 / d(h, w, d)); both
    differentiable with respect to the volume and the points."""
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
