"""``"border"`` padding of the port's lookups against the JAX package's, on
the CPU: the trilinear values-only query at C = 3 (the flow head's lookup,
``selfocc_tpu/models/heads.py:519-520`` over ``ops/interp.py:118-156``),
its plain backward ``trilinear_cf_bwd_plain`` and the bilinear lookup
(``losses/reproj.py``, ``losses/regularizers.py``).

JAX clips each index with ``jnp.clip`` (a maximum, then a minimum, each of
which passes half of the gradient at a tie) and clamps the upper corners
onto the face rows, so that a point on an upper face has slope 0 there.
The point sets put points exactly on every face, beyond the faces and on
interior knots, where only that rule decides the points' cotangent.
Inputs are numpy draws from a seed; tolerances: values 1e-5 abs,
cotangents 1e-4 of their largest reference magnitude + 1e-7. The card's
narrow instances are held against these plain versions by
``chip_smoke.py`` (``[kernels]``, ``[variants]``).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.ops import interp as jinterp
from selfocc_tpu_torch.models.heads import sample_border
from selfocc_tpu_torch.ops import interp as tinterp

from test_torch_port_threads import share_cores_with_xdist_workers
from test_torch_port_train_ops import assert_grad_close

share_cores_with_xdist_workers()

T = torch.from_numpy
SHAPE = (5, 6, 4)          # (H, W, D)
POINT_SETS = ("lower faces", "upper faces", "beyond", "interior knots",
              "uniform")


def border_points(kind, rng, shape=SHAPE, n=12):
    """(M, 3) fractional indices: on each lower or upper face (the other
    two indices at knots or between them), beyond the faces, at interior
    knots, or uniform over the volume and a margin around it."""
    size = np.asarray(shape, np.float32)
    if kind in ("lower faces", "upper faces", "beyond"):
        sets = []
        for ax in range(len(shape)):
            p = rng.uniform(0, 1, (n, len(shape))) * (size - 1)
            p[::2] = np.round(p[::2])
            if kind == "lower faces":
                p[:, ax] = 0.0
            elif kind == "upper faces":
                p[:, ax] = size[ax] - 1
            else:
                p[: n // 2, ax] = rng.uniform(-3, -0.01, n // 2)
                p[n // 2:, ax] = size[ax] - 1 + rng.uniform(0.01, 3, n // 2)
            sets.append(p)
        return np.concatenate(sets).astype(np.float32)
    if kind == "interior knots":
        return np.stack([rng.randint(1, s - 1, n * 3) for s in shape],
                        -1).astype(np.float32)
    return (rng.uniform(-2, 1, (n * 3, len(shape))) * 1.0
            + rng.uniform(0, 1, (n * 3, len(shape))) * (size + 2)
            ).astype(np.float32)


def jax_border_vjp(vol_cf, pts, cot):
    out, vjp = jax.vjp(lambda v, p: jinterp.trilinear_sample_cf(
        v, p, "border"), jnp.asarray(vol_cf), jnp.asarray(pts))
    return (np.asarray(out),) + tuple(np.asarray(g)
                                      for g in vjp(jnp.asarray(cot)))


def border_case(kind, seed):
    rng = np.random.RandomState(seed)
    vol = rng.randn(3, *SHAPE).astype(np.float32)
    pts = border_points(kind, rng)
    cot = rng.randn(len(pts), 3).astype(np.float32)
    return vol, pts, cot


@pytest.mark.parametrize("kind", POINT_SETS)
def test_trilinear_border_vjp_matches_jax(kind):
    vol, pts, cot = border_case(kind, 31)
    ref, g_vol, g_pts = jax_border_vjp(vol, pts, cot)
    tv = T(vol.copy()).requires_grad_(True)
    tp = T(pts.copy()).requires_grad_(True)
    got = tinterp.trilinear_sample_cf(tv, tp, "border")
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(tv.grad, g_vol, f"{kind}: volume")
    assert_grad_close(tp.grad, g_pts, f"{kind}: points")


@pytest.mark.parametrize("kind", POINT_SETS)
def test_trilinear_cf_bwd_plain_border_matches_jax(kind):
    vol, pts, cot = border_case(kind, 32)
    _, g_vol, g_pts = jax_border_vjp(vol, pts, cot)
    got_vol, got_pts = tinterp.trilinear_cf_bwd_plain(
        T(vol), T(pts), T(cot), points=True, padding="border")
    assert_grad_close(got_vol, g_vol, f"{kind}: volume")
    assert_grad_close(got_pts, g_pts, f"{kind}: points")
    assert torch.equal(tinterp.trilinear_cf_bwd_plain(
        T(vol), T(pts), T(cot), padding="border"), got_vol)


@pytest.mark.parametrize("kind", ("edges", "beyond and knots"))
def test_bilinear_border_vjp_matches_jax(kind):
    rng = np.random.RandomState(33)
    H, W = 6, 9
    img = rng.randn(H, W, 3).astype(np.float32)
    if kind == "edges":
        x = rng.uniform(0, W - 1, 24)
        y = rng.uniform(0, H - 1, 24)
        x[:6], y[6:12], x[12:18], y[18:] = 0.0, 0.0, W - 1.0, H - 1.0
        x[::3] = np.round(x[::3])
        xy = np.stack([x, y], -1)
        xy = np.concatenate([xy, [[0, 0], [W - 1, H - 1], [0, H - 1],
                                  [W - 1, 0]]])
    else:
        xy = np.concatenate([
            rng.uniform(-3, W + 2, (20, 2)),
            np.stack([rng.randint(1, W - 1, 8), rng.randint(1, H - 1, 8)],
                     -1)])
    xy = xy.astype(np.float32)
    cot = rng.randn(len(xy), 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda i, p: jinterp.bilinear_sample(i, p, "border"),
                       jnp.asarray(img), jnp.asarray(xy))
    g_img, g_xy = vjp(jnp.asarray(cot))
    ti = T(img.copy()).requires_grad_(True)
    tp = T(xy.copy()).requires_grad_(True)
    got = tinterp.bilinear_sample(ti, tp, "border")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(ti.grad, g_img, "img")
    assert_grad_close(tp.grad, g_xy, "xy")


def test_sample_border_is_the_jax_flow_lookup():
    # the head's lookup of a channel-last (H, W, D, 3) flow at (R, S, 3)
    # grid points, as the JAX head makes it: moveaxis, then the border query
    rng = np.random.RandomState(34)
    flow = rng.randn(*SHAPE, 3).astype(np.float32)
    pts = np.concatenate([border_points(k, rng) for k in POINT_SETS])
    pts = pts[: len(pts) // 4 * 4].reshape(4, -1, 3)
    cot = rng.randn(*pts.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda f, p: jinterp.trilinear_sample_cf(
        jnp.moveaxis(f, -1, 0), p, "border"), jnp.asarray(flow),
        jnp.asarray(pts))
    g_flow, g_pts = vjp(jnp.asarray(cot))
    tf = T(flow.copy()).requires_grad_(True)
    tp = T(pts.copy()).requires_grad_(True)
    got = sample_border(tf, tp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(tf.grad, g_flow, "flow")
    assert_grad_close(tp.grad, g_pts, "points")


@pytest.mark.parametrize("fn", ("trilinear_cf_fwd", "trilinear_cf_bwd"))
def test_border_is_refused_above_the_narrow_instances(fn):
    # "border" padding has kernels at C <= 3 alone: a wider border query
    # on the card raises, naming the instance, before any launch
    vol = torch.zeros((4,) + SHAPE)
    pts = torch.zeros((2, 3))
    call = {"trilinear_cf_fwd": lambda p: tinterp.trilinear_cf_fwd(
                vol, pts, p),
            "trilinear_cf_bwd": lambda p: tinterp.trilinear_cf_bwd(
                tuple(vol.shape), pts, torch.zeros((2, 4)), padding=p)}[fn]
    kernel = fn.replace("trilinear_cf", "values") + "_narrow_kernel"
    with pytest.raises(ValueError, match=kernel):
        call("border")
    with pytest.raises(ValueError, match="padding must be"):
        call("reflection")
