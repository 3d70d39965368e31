"""The training slice's ops on the CPU, PyTorch port vs the JAX package:
values and gradients of bilinear sampling, SSIM, the multi-scale deformable
attention and trilinear-with-gradient sampling, the CPU path of the port's
``autograd.Function``s, and the row gather.

Inputs are numpy draws from a seed handed to both frameworks. Tolerances:
forward values 1e-5 abs (fp32, sums in another order); gradients
``max|d| <= 1e-4 * max|g_ref| + 1e-7`` per tensor (fp32 reductions over
many samples in another order). The CUDA kernels behind the Functions are
held against these plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.ops import interp as jinterp
from selfocc_tpu.ops.gather_rows import gather_rows as j_gather_rows
from selfocc_tpu.ops.msda import ms_deform_attn as j_msda
from selfocc_tpu.ops.ssim import ssim as j_ssim
from selfocc_tpu_torch.ops import gather_rows as tgather
from selfocc_tpu_torch.ops import interp as tinterp
from selfocc_tpu_torch.ops import msda as tmsda
from selfocc_tpu_torch.ops.ssim import ssim as t_ssim

T = torch.from_numpy


def assert_grad_close(got, ref, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    tol = 1e-4 * float(np.abs(ref).max()) + 1e-7
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{name}: max|d| {err:.3e} > {tol:.3e}"


def leaves(*arrays):
    return [T(np.array(a)).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_sample_grad_matches_jax(padding):
    rng = np.random.RandomState(11)
    img = rng.randn(6, 9, 3).astype(np.float32)
    xy = rng.uniform(-2, 11, (40, 2)).astype(np.float32)
    cot = rng.randn(40, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda i, p: jinterp.bilinear_sample(i, p, padding),
                       jnp.asarray(img), jnp.asarray(xy))
    g_img, g_xy = vjp(jnp.asarray(cot))
    ti, tp = leaves(img, xy)
    got = tinterp.bilinear_sample(ti, tp, padding)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(ti.grad, g_img, "img")
    assert_grad_close(tp.grad, g_xy, "xy")


def test_ssim_matches_jax():
    rng = np.random.RandomState(12)
    x = rng.rand(2, 5, 7, 3).astype(np.float32)
    y = rng.rand(2, 5, 7, 3).astype(np.float32)
    cot = rng.randn(2, 5, 7, 3).astype(np.float32)
    ref, vjp = jax.vjp(j_ssim, jnp.asarray(x), jnp.asarray(y))
    gx, gy = vjp(jnp.asarray(cot))
    tx, ty = leaves(x, y)
    got = t_ssim(tx, ty)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(tx.grad, gx, "x")
    assert_grad_close(ty.grad, gy, "y")


def _msda_case(seed, bs=2, q=37, heads=3, d=4, shapes=((6, 8), (3, 4)), p=5):
    rng = np.random.RandomState(seed)
    L = sum(h * w for h, w in shapes)
    value = rng.randn(bs, L, heads, d).astype(np.float32)
    # locations reach past [0, 1]: zeros padding and partly-outside corners
    loc = rng.uniform(-0.2, 1.2, size=(bs, q, heads, len(shapes), p, 2)
                      ).astype(np.float32)
    att = rng.rand(bs, q, heads, len(shapes), p).astype(np.float32)
    att = att / att.sum(axis=(-1, -2), keepdims=True)
    cot = rng.randn(bs, q, heads * d).astype(np.float32)
    return value, loc, att, shapes, cot


MSDA_CASES = [
    (0, {}),
    (1, dict(bs=1, q=53, heads=6, d=16, shapes=((9, 7), (5, 4), (3, 2)),
             p=12)),
    (2, dict(bs=3, q=20, heads=2, d=8, shapes=((4, 4),), p=3)),
    # the zh / wz point count (4 levels x 48) at a head width that is no
    # multiple of 4 (the kernels' scalar-lane instance)
    (3, dict(bs=1, q=5, heads=2, d=6, shapes=((6, 5), (3, 4), (2, 3), (1, 2)),
             p=48)),
]


@pytest.mark.parametrize("seed,kw", MSDA_CASES)
def test_msda_plain_grad_matches_jax_vjp(seed, kw):
    value, loc, att, shapes, cot = _msda_case(seed, **kw)
    ref, vjp = jax.vjp(lambda v, lc, a: j_msda(v, shapes, lc, a),
                       jnp.asarray(value), jnp.asarray(loc), jnp.asarray(att))
    refs = vjp(jnp.asarray(cot))
    tv, tl, ta = leaves(value, loc, att)
    got = tmsda.ms_deform_attn_plain(tv, shapes, tl, ta)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (got * T(cot)).sum().backward()
    for g, r, n in zip((tv.grad, tl.grad, ta.grad), refs,
                       ("value", "locations", "weights")):
        assert_grad_close(g, r, n)


@pytest.mark.parametrize("seed,kw", MSDA_CASES[:2])
def test_msda_function_cpu_path_equals_plain_autograd(seed, kw):
    value, loc, att, shapes, cot = _msda_case(seed, **kw)
    fv, fl, fa = leaves(value, loc, att)
    out = tmsda.ms_deform_attn(fv, shapes, fl, fa)
    (out * T(cot)).sum().backward()
    pv, pl, pa = leaves(value, loc, att)
    ref = tmsda.ms_deform_attn_plain(pv, shapes, pl, pa)
    (ref * T(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    for g, r, n in ((fv.grad, pv.grad, "value"), (fl.grad, pl.grad, "loc"),
                    (fa.grad, pa.grad, "weights")):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6,
                                   err_msg=n)
    # under no_grad the Function still computes the forward
    with torch.no_grad():
        np.testing.assert_array_equal(
            tmsda.ms_deform_attn(fv, shapes, fl, fa).numpy(),
            ref.detach().numpy())


def _vol_points(seed, C, shape=(7, 9, 5), n=500):
    rng = np.random.RandomState(seed)
    vol = rng.randn(C, *shape).astype(np.float32)
    hi = np.asarray(shape, np.float32)
    # a margin of points outside the volume, plus exact integer corners
    pts = (rng.uniform(-1.5, 1.5, (n, 3)) * (hi + 2) / 2 + (hi - 1) / 2)
    pts[:20] = np.round(pts[:20])
    gv = rng.randn(n, C).astype(np.float32)
    gg = rng.randn(n, 3).astype(np.float32)
    return vol, pts.astype(np.float32), gv, gg


def _ray_points(seed, C, shape=(7, 9, 5), rays=6, samples=40):
    """Monotone samples along rays that start inside the volume and leave
    it (the render's ray-major order, consecutive samples sharing cells),
    with cotangents."""
    rng = np.random.RandomState(seed)
    vol = rng.randn(C, *shape).astype(np.float32)
    hi = np.asarray(shape, np.float64) - 1
    o = rng.uniform(0.25, 0.75, (rays, 3)) * hi
    d = rng.randn(rays, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.sort(rng.uniform(0, 1.5 * hi.max(), (rays, samples)), axis=1)
    pts = (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)
    n = pts.shape[0]
    gv = rng.randn(n, C).astype(np.float32)
    gg = rng.randn(n, 3).astype(np.float32)
    return vol, pts.astype(np.float32), gv, gg


@pytest.mark.parametrize("C,points", [(1, "uniform"), (25, "uniform"),
                                      (1, "rays"), (25, "rays")],
                         ids=["1", "25", "1-rays", "25-rays"])
def test_trilinear_with_grad_plain_vjp_matches_jax(C, points):
    make = _vol_points if points == "uniform" else _ray_points
    vol, pts, gv, gg = make(20 + C, C)
    if points == "rays":  # some samples leave the volume
        assert not ((pts >= 0) & (pts <= np.asarray(vol.shape[1:]) - 1)
                    ).all()
    (rv, rg), vjp = jax.vjp(
        lambda v: jinterp.trilinear_sample_cf_with_grad(v, jnp.asarray(pts)),
        jnp.asarray(vol))
    (g_ref,) = vjp((jnp.asarray(gv), jnp.asarray(gg)))
    (tv,) = leaves(vol)
    vals, grad0 = tinterp.trilinear_sample_cf_with_grad_plain(tv, T(pts))
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(rv),
                               atol=1e-5)
    np.testing.assert_allclose(grad0.detach().numpy(), np.asarray(rg),
                               atol=1e-5)
    ((vals * T(gv)).sum() + (grad0 * T(gg)).sum()).backward()
    assert_grad_close(tv.grad, g_ref, "volume")


@pytest.mark.parametrize("which", ["both", "vals", "grad0",
                                   "both-channel-last"])
def test_trilinear_function_cpu_path_equals_plain_autograd(which):
    vol, pts, gv, gg = _vol_points(3, 5)
    channel_last = which.endswith("channel-last")
    which = which.split("-")[0]
    cots = {"vals": (gv, None), "grad0": (None, gg), "both": (gv, gg)}[which]

    def loss(fn, v):
        vals, grad0 = fn(v, T(pts))
        terms = [(o * T(c)).sum() for o, c in zip((vals, grad0), cots)
                 if c is not None]
        return sum(terms)

    (fv,) = leaves(vol)
    # the layout field.decode gives: the Function reads it without a copy
    fvol = fv.permute(1, 2, 3, 0).contiguous().permute(3, 0, 1, 2) \
        if channel_last else fv
    loss(tinterp.trilinear_sample_cf_with_grad, fvol).backward()
    (pv,) = leaves(vol)
    loss(tinterp.trilinear_sample_cf_with_grad_plain, pv).backward()
    np.testing.assert_allclose(fv.grad.numpy(), pv.grad.numpy(), atol=1e-6)
    # the bare backward wrapper with the same cotangents
    np.testing.assert_allclose(
        tinterp.trilinear_bwd_plain(
            T(vol), T(pts), *(None if c is None else T(c) for c in cots)
        ).numpy(), pv.grad.numpy(), atol=1e-6)


def _channel_last(vol):
    """A (C, H, W, D) tensor of ``vol``'s values laid out (H, W, D, C)."""
    return T(np.ascontiguousarray(vol.transpose(1, 2, 3, 0))
             ).permute(3, 0, 1, 2)


def test_kernel_volume_layouts():
    vol = np.random.RandomState(5).randn(3, 4, 5, 6).astype(np.float32)
    cl = _channel_last(vol)
    assert tinterp.kernel_volume(cl) is cl        # already channel-last
    for v in (T(vol), cl, cl[:1], T(vol)[:, 1:]):
        got = tinterp.kernel_volume(v)
        assert got.permute(1, 2, 3, 0).is_contiguous()
        np.testing.assert_array_equal(got.numpy(), v.numpy())
    # the copy is differentiable
    (leaf,) = leaves(vol)
    (tinterp.kernel_volume(leaf) * 2).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), np.full_like(vol, 2))


@pytest.mark.parametrize("layout", ["channel_first", "channel_last"])
def test_first_channel_plane_and_gradient_layout(layout):
    """The sdf plane is a contiguous (1, H, W, D) tensor of channel 0 whose
    gradient reaches the volume in the volume's own layout (so that it adds
    to the kernels' channel-last gradient without a transpose); with a
    full-volume query beside it the volume's gradient equals the plain
    one."""
    vol, pts, gv, gg = _ray_points(31, 4)

    def volume(leaf):
        return leaf if layout == "channel_first" else \
            leaf.permute(1, 2, 3, 0).contiguous().permute(3, 0, 1, 2)

    (leaf,) = leaves(vol)
    v = volume(leaf)
    seen = []
    v.register_hook(lambda g: seen.append(g.stride()))
    plane = tinterp.first_channel(v)
    assert plane.shape == (1,) + vol.shape[1:] and plane.is_contiguous()
    np.testing.assert_array_equal(plane.detach().numpy(), vol[:1])
    (plane * 3).sum().backward()
    assert seen == [v.stride()]

    (leaf,) = leaves(vol)
    v = volume(leaf)
    vals, grad0 = tinterp.trilinear_sample_cf_with_grad(v, T(pts))
    _, g_plane = tinterp.trilinear_sample_cf_with_grad(
        tinterp.first_channel(v), T(pts))
    ((vals * T(gv)).sum() + (grad0 * T(gg)).sum()
     + (g_plane * T(gg)).sum()).backward()
    (ref,) = leaves(vol)
    r_vals, r_grad0 = tinterp.trilinear_sample_cf_with_grad_plain(ref, T(pts))
    _, r_plane = tinterp.trilinear_sample_cf_with_grad_plain(ref[:1], T(pts))
    ((r_vals * T(gv)).sum() + (r_grad0 * T(gg)).sum()
     + (r_plane * T(gg)).sum()).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy(),
                               atol=1e-5)


def test_trilinear_function_refuses_point_gradients():
    vol, pts, _, _ = _vol_points(4, 2)
    with pytest.raises(NotImplementedError):
        tinterp.trilinear_sample_cf_with_grad(
            T(vol), T(pts).requires_grad_(True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [64, 128])
def test_gather_rows_plain_matches_pallas(dtype, block):
    # the cases of tests/test_gather_rows.py, Pallas in interpret mode
    rng = np.random.RandomState(0)
    R, C, N = 300, 24, 256
    table = jnp.asarray(rng.randn(R, C), dtype)
    idx = rng.randint(0, R, size=(N,)).astype(np.int32)
    ref = j_gather_rows(table, jnp.asarray(idx), block=block, inflight=8,
                        interpret=True)
    ttable = torch.from_numpy(np.array(table.astype(jnp.float32)))
    ttable = ttable.to(getattr(torch, dtype))
    got = tgather.gather_rows(ttable, T(idx), block=block)
    assert got.dtype == ttable.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(
        tgather.gather_rows_plain(ttable, T(idx)).float().numpy(),
        got.float().numpy())


def test_gather_rows_repeated_and_boundary_indices():
    rng = np.random.RandomState(1)
    R, C = 50, 8
    table = rng.randn(R, C).astype(np.float32)
    idx = np.asarray([0, 0, R - 1, R - 1, 7, 7, 7, 0] * 16, np.int32)
    ref = j_gather_rows(jnp.asarray(table), jnp.asarray(idx), block=32,
                        inflight=4, interpret=True)
    got = tgather.gather_rows(T(table), T(idx), block=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        tgather.gather_rows(T(table), T(idx[:100]), block=32)


def test_cellular_rays_jitter_and_background_match_jax():
    # the JAX sampler's uniforms, replayed from its key, drive the port's
    from selfocc_tpu.geometry.ray_sampler import RaySampler as JRaySampler
    from selfocc_tpu.models import neus as jneus
    from selfocc_tpu_torch.geometry.ray_sampler import RaySampler
    from selfocc_tpu_torch.models import neus as tneus
    kw = dict(ray_sample_mode="cellular", ray_number=(48, 100),
              ray_img_size=(768, 1600))
    key = jax.random.PRNGKey(4)
    ref = np.asarray(JRaySampler(**kw)(key))
    u = np.array([float(jax.random.uniform(k))
                  for k in jax.random.split(key, 4)], np.float32)
    got = RaySampler(**kw)(draws=u).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    assert got.min() >= 0 and got[:, 0].max() < 1600 and \
        got[:, 1].max() < 768
    # stratified jitter: the same (R, S + 1) uniforms
    rng = np.random.RandomState(9)
    near = rng.uniform(0, 2, 30).astype(np.float32)
    far = near + rng.uniform(0, 40, 30).astype(np.float32)
    segs = jneus.sample_uniform(jnp.asarray(near), jnp.asarray(far), 16, key)
    t_rand = np.array(jax.random.uniform(key, (30, 17), jnp.float32))
    tsegs = tneus.sample_uniform(T(near), T(far), 16, T(t_rand))
    np.testing.assert_allclose(tsegs.mids.numpy(), np.asarray(segs.mids),
                               rtol=1e-6, atol=1e-5)
    assert (np.diff(tsegs.starts.numpy(), axis=-1) >= 0).all()
    # the random background is the draw it is given, or a generator's
    draw = rng.rand(30, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tneus.background_color("random", (30, 3), "cpu", None, T(draw)),
        draw)
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    assert torch.equal(tneus.background_color("random", (30, 3), "cpu", g1),
                       tneus.background_color("random", (30, 3), "cpu", g2))
