"""PyTorch port vs the JAX package, op by op, on the CPU.

Inputs are drawn with numpy from a seed and fed to both. On the CPU every
kernel wrapper of ``selfocc_tpu_torch`` takes its plain PyTorch version; the
CUDA kernels themselves are held against those plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.geometry import mappings as jmap
from selfocc_tpu.geometry import projection as jproj
from selfocc_tpu.geometry import sh as jsh
from selfocc_tpu.geometry.ray_sampler import RaySampler as JRaySampler
from selfocc_tpu.models import neus as jneus
from selfocc_tpu.ops import interp as jinterp
from selfocc_tpu.ops.msda import ms_deform_attn as j_msda
from selfocc_tpu.ops.render_pallas import weights_from_alpha_pallas
from selfocc_tpu_torch.geometry import mappings as tmap
from selfocc_tpu_torch.geometry import projection as tproj
from selfocc_tpu_torch.geometry import sh as tsh
from selfocc_tpu_torch.geometry.ray_sampler import RaySampler as TRaySampler
from selfocc_tpu_torch.models import neus as tneus
from selfocc_tpu_torch.ops import interp as tinterp
from selfocc_tpu_torch.ops import render_weights
from selfocc_tpu_torch.ops.msda import ms_deform_attn as t_msda

T = torch.from_numpy


def _msda_case(seed, bs=2, q=37, heads=3, d=4, shapes=((6, 8), (3, 4)), p=5):
    """Shapes of ``tests/test_msda.py::_random_case``; locations reach past
    [0, 1] so zeros padding is exercised."""
    rng = np.random.RandomState(seed)
    L = sum(h * w for h, w in shapes)
    value = rng.randn(bs, L, heads, d).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(bs, q, heads, len(shapes), p, 2)
                      ).astype(np.float32)
    att = rng.rand(bs, q, heads, len(shapes), p).astype(np.float32)
    att = att / att.sum(axis=(-1, -2), keepdims=True)
    return value, loc, att, shapes


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(q=53)),
    (2, dict(bs=1, heads=6, d=16, shapes=((9, 7), (5, 4), (3, 2)), p=12)),
    (3, dict(bs=1, q=5, heads=2, d=6, shapes=((6, 5), (3, 4), (2, 3), (1, 2)),
             p=48)),
])
def test_ms_deform_attn_matches_jax(seed, kw):
    # fp32 sums in another order: atol 1e-5
    value, loc, att, shapes = _msda_case(seed, **kw)
    ref = np.asarray(j_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                            jnp.asarray(att)))
    got = t_msda(T(value), shapes, T(loc), T(att)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_ms_deform_attn_rejects_bad_shapes():
    value, loc, att, shapes = _msda_case(0)
    with pytest.raises(ValueError):
        t_msda(T(value), ((6, 8), (3, 5)), T(loc), T(att))
    with pytest.raises(ValueError):
        t_msda(T(value), shapes, T(loc), T(att[..., :-1]))


def _vol_points(seed, C, shape=(7, 9, 5), n=500):
    rng = np.random.RandomState(seed)
    vol = rng.randn(C, *shape).astype(np.float32)
    hi = np.asarray(shape, np.float32)
    # a margin of points outside the volume, plus exact integer corners
    pts = (rng.uniform(-1.5, 1.5, (n, 3)) * (hi + 2) / 2 + (hi - 1) / 2)
    pts[:20] = np.round(pts[:20])
    return vol, pts.astype(np.float32)


@pytest.mark.parametrize("C", [1, 5])
def test_trilinear_with_grad_matches_jax(C):
    # same corner order in both; fp32 rounding only: atol 1e-5
    vol, pts = _vol_points(C, C)
    rv, rg = jinterp.trilinear_sample_cf_with_grad(jnp.asarray(vol),
                                                   jnp.asarray(pts))
    tv, tg = tinterp.trilinear_sample_cf_with_grad(T(vol), T(pts))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(rg), atol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_trilinear_sample_cf_matches_jax(padding):
    vol, pts = _vol_points(3, 4)
    pts = pts.reshape(20, 25, 3)
    ref = jinterp.trilinear_sample_cf(jnp.asarray(vol), jnp.asarray(pts),
                                      padding)
    got = tinterp.trilinear_sample_cf(T(vol), T(pts), padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_sample_matches_jax(padding):
    rng = np.random.RandomState(4)
    img = rng.randn(6, 9, 2).astype(np.float32)
    xy = rng.uniform(-2, 11, (40, 2)).astype(np.float32)
    ref = jinterp.bilinear_sample(jnp.asarray(img), jnp.asarray(xy), padding)
    got = tinterp.bilinear_sample(T(img), T(xy), padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def _alpha_cases():
    rng = np.random.RandomState(0)
    yield rng.uniform(0, 1, size=(37, 19)).astype(np.float32)
    yield (np.r_[np.zeros(3), np.ones(3), 0.5 * np.ones(2)]
           .astype(np.float32)[None].repeat(4, 0))


@pytest.mark.parametrize("case", [0, 1], ids=["random", "saturated"])
def test_weights_forward_matches_pallas(case):
    # the Pallas kernel in interpret mode, as tests/test_render_pallas.py runs
    # it; same log-sum formula, atol 2e-5
    alpha = list(_alpha_cases())[case]
    ref = np.asarray(weights_from_alpha_pallas(jnp.asarray(alpha)))
    got = render_weights.weights_from_alpha(T(alpha)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # and the port's plain cumprod (models/neus.py) against the JAX one
    np.testing.assert_allclose(
        tneus.weights_from_alpha(T(alpha)).numpy(),
        np.asarray(jneus.weights_from_alpha(jnp.asarray(alpha))), atol=1e-6)


def test_weights_grad_matches_jax():
    # closed-form backward vs jax.grad through the Pallas custom_vjp: atol 1e-4
    rng = np.random.RandomState(1)
    alpha = rng.uniform(0.01, 0.99, size=(9, 13)).astype(np.float32)
    alpha[0, 3] = 0.0                     # the recompute-transmittance branch
    cot = rng.randn(9, 13).astype(np.float32)
    g_ref = jax.grad(lambda a: jnp.sum(weights_from_alpha_pallas(a) * cot))(
        jnp.asarray(alpha))
    a = T(alpha).requires_grad_(True)
    (render_weights.weights_from_alpha(a) * T(cot)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_ref), atol=1e-4)


def test_weights_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        render_weights.weights_from_alpha(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        render_weights.weights_from_alpha(torch.zeros(2, 4, 8))


def test_neus_eval_math_matches_jax():
    rng = np.random.RandomState(5)
    R, S = 23, 16
    origins = rng.uniform(-3, 3, (R, 3)).astype(np.float32)
    dirs = rng.randn(R, 3).astype(np.float32)
    dirs[0] = [1.0, 0.0, 0.0]                        # axis-parallel ray
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    aabb = (-10.0, -10.0, -1.0, 10.0, 10.0, 3.0)
    jn, jf = jneus.ray_aabb_near_far(jnp.asarray(origins), jnp.asarray(dirs),
                                     aabb)
    tn, tf = tneus.ray_aabb_near_far(T(origins), T(dirs), aabb)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    js = jneus.sample_uniform(jn, jf, S)
    ts = tneus.sample_uniform(tn, tf, S)
    np.testing.assert_allclose(ts.mids.numpy(), np.asarray(js.mids), rtol=1e-6)
    np.testing.assert_allclose(ts.deltas.numpy(), np.asarray(js.deltas),
                               rtol=1e-5, atol=1e-6)
    sdf = rng.randn(R, S).astype(np.float32)
    grad = rng.randn(R, S, 3).astype(np.float32)
    deltas = np.array(js.deltas)
    ja = jneus.neus_alpha(jnp.asarray(sdf), jnp.asarray(grad),
                          jnp.asarray(dirs), jnp.asarray(deltas), 2.7)
    ta = tneus.neus_alpha(T(sdf), T(grad), T(dirs), T(deltas), 2.7)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    vals = rng.randn(R, S, 4).astype(np.float32)
    w = np.asarray(ja)
    np.testing.assert_allclose(
        tneus.composite(T(w), T(vals)).numpy(),
        np.asarray(jneus.composite(jnp.asarray(w), jnp.asarray(vals))),
        atol=1e-5)


MAPPING = dict(nonlinear_mode="linear", h_size=[8, 2], h_range=[10.0, 5.0],
               h_half=False, w_size=[8, 0], w_range=[10.0, 0], w_half=False,
               d_size=[8, 0], d_range=[-1.0, 3.0, 3.0])


def test_linear_mapping_matches_jax():
    rng = np.random.RandomState(6)
    jm, tm = jmap.make_mapping(**MAPPING), tmap.make_mapping(**MAPPING)
    assert (tm.size_h, tm.size_w, tm.size_d) == (jm.size_h, jm.size_w,
                                                 jm.size_d)
    meter = rng.uniform(-16, 16, (50, 3)).astype(np.float32)
    meter[:5, :2] = 0.0                         # the sign() kink
    np.testing.assert_allclose(
        tm.meter2grid(T(meter)).numpy(),
        np.asarray(jm.meter2grid(jnp.asarray(meter))), rtol=1e-6, atol=1e-6)
    grid = rng.uniform(0, 20, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.grid2meter(T(grid)).numpy(),
                               np.asarray(jm.grid2meter(jnp.asarray(grid))),
                               rtol=1e-6, atol=1e-6)
    # the slope the field chains through equals jax.jvp (a separable map: a
    # ones tangent gives the Jacobian's diagonal), 0 where a coordinate is 0
    ones = np.ones_like(meter)
    _, jt = jax.jvp(jm.meter2grid, (jnp.asarray(meter),), (jnp.asarray(ones),))
    tt = tm.meter2grid_slope(T(meter))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt.numpy()[:5, :2] == 0).all()


def test_projection_and_rays_match_jax():
    rng = np.random.RandomState(7)
    ref = rng.uniform(-10, 10, (4, 30, 3)).astype(np.float32)
    l2i = rng.randn(1, 3, 4, 4).astype(np.float32)
    l2i[..., 3, :] = [0, 0, 0, 1]
    l2i[..., 2, 3] += 20.0                     # most points in front
    jc, jmask = jproj.point_sampling(jnp.asarray(ref), jnp.asarray(l2i),
                                     (64, 96))
    tc, tmask = tproj.point_sampling(T(ref), T(l2i), (64, 96))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    assert (tmask.numpy() == np.asarray(jmask)).all()
    rays = JRaySampler(ray_sample_mode="fixed", ray_number=(4, 6),
                       ray_img_size=(64, 96))()
    trays = TRaySampler(ray_sample_mode="fixed", ray_number=(4, 6),
                        ray_img_size=(64, 96))()
    np.testing.assert_array_equal(trays.numpy(), np.asarray(rays))
    jo, jd = jproj.rays_from_img2lidar(jnp.asarray(l2i), rays)
    to, td = tproj.rays_from_img2lidar(T(l2i), trays)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("deg,act", [(0, "relu"), (2, "sigmoid")])
def test_sh_render_matches_jax(deg, act):
    rng = np.random.RandomState(8)
    dirs = rng.randn(10, 1, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    feats = rng.randn(10, 7, 3 * (deg + 1) ** 2).astype(np.float32)
    ref = jsh.sh_render(jnp.asarray(dirs), jnp.asarray(feats), deg, act)
    got = tsh.sh_render(T(dirs), T(feats), deg, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
