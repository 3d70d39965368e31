"""The rest of the NeuS head of the port against the JAX package on the
CPU, at ``tiny`` width: the points' cotangents of the trilinear queries'
plain versions, ``neus.sample_pdf`` / ``upsample_ts`` / ``merge_ts``, eval
renders with importance samples and with eval-time skipping, the annealed
AABB band, the sparsity losses, ``two_split``'s camera split, and two
training steps through the bridge: importance sampling with
``return_sample_sdf`` and ``AdaptiveSparsityLoss``; then numerical
gradients, ``beta_hand_tune``, ``anneal_aabb`` and ``return_surface_sdf``
with ``SparsityLoss`` (on the surface sdf) and ``HardSparsityLoss`` (on the
uniform sdf). Both steps run at a mid-schedule ``global_iter``, traced in
JAX as ``state.step`` is, so that both schedules are live.

Weights: the JAX init with numpy noise on every leaf (``perturb``), handed
to the port through ``bridge.from_jax_variables``; dropout 0; the head's
draws replayed from JAX's key splits. Tolerances: point cotangents, eval
renders and the neus functions' values within 1e-5 (1e-6 for the
functions) of their scale, the bin indices equal; losses rtol 1e-5;
gradients ``1e-4 * max|ref| + 1e-7`` per tensor; the sparsity losses rtol
1e-6. The JAX ``tiny`` step does not run with ``two_split``: its
reprojection loss reads every camera's images, and the split keeps half
of the cameras' weights, so ``two_split`` is held at the split itself.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu import losses as jlosses
from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.models import heads as jheads
from selfocc_tpu.models import neus as jneus
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.ops import interp as jinterp
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models import heads as theads
from selfocc_tpu_torch.models import neus as tneus
from selfocc_tpu_torch.models.segmentor import TPVSegmentor, check_ported
from selfocc_tpu_torch.ops import interp as tinterp
from selfocc_tpu_torch.utils import train_lib as ttrain
from test_torch_port_bev import _batch, assert_scaled_close
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import (jit_vjp, memoised_jax_init,  # noqa: F401
                            quick_jit)
from test_torch_port_train import (assert_grad_close, jax_draws, no_dropout,
                                   perturb)

share_cores_with_xdist_workers()

T = torch.from_numpy
# a mid-schedule step of tiny's 3516 x 11 iterations: the beta schedule at
# 0.458, the annealed band at 5 of its 11 stages
MID_ITER = 3516 * 5 + 123
IMPORTANCE = dict(num_samples_importance=8, return_sample_sdf=True)
OPTIONS = dict(use_numerical_gradients=True, beta_hand_tune=True,
               anneal_aabb=True, return_surface_sdf=True,
               return_uniform_sdf=True)
SKIP = dict(eval_skip_coarse=12, eval_skip_fine=10)


def with_head(cfg, **opts):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head, **opts)))


def importance_cfg(pkg_get):
    cfg = with_head(no_dropout(pkg_get("tiny")), **IMPORTANCE)
    conv = dict(cfg.loss_input_convertion, sample_sdf="sdfs",
                ms_depths="ms_depths", ts="ts")
    return dataclasses.replace(
        cfg, loss_cfgs=list(cfg.loss_cfgs) + [
            dict(type="AdaptiveSparsityLoss", weight=0.5, slack=0.3)],
        loss_input_convertion=conv)


def options_cfg(pkg_get):
    cfg = with_head(no_dropout(pkg_get("tiny")), **OPTIONS)
    conv = dict(cfg.loss_input_convertion, surface_sdf="surface_sdf",
                uniform_sdf="uniform_sdf")
    return dataclasses.replace(cfg, loss_cfgs=list(cfg.loss_cfgs) + [
        dict(type="SparsityLoss", weight=0.2, scale=0.7,
             input_dict={"density": "surface_sdf"}),
        dict(type="HardSparsityLoss", weight=0.3, scale=2.0, thresh=0.05,
             crop=((1, 2), (0, 1), (1, 0)),
             input_dict={"density": "uniform_sdf"})],
        loss_input_convertion=conv)


# ------------------------------------------------------ point cotangents
def _query_case(rng, C, N=400):
    vol = rng.randn(C, 6, 7, 5).astype(np.float32)
    pts = np.stack([rng.uniform(-1.3, 6.3, N), rng.uniform(-1.3, 7.3, N),
                    rng.uniform(-1.3, 5.3, N)], -1).astype(np.float32)
    # off the voxel knots, where the gradient is one-sided
    frac = pts - np.floor(pts)
    pts = np.where(np.minimum(frac, 1 - frac) < 1e-3, pts + 0.01, pts)
    return vol, pts.astype(np.float32)


@pytest.mark.parametrize("C", [1, 4, 25])
@pytest.mark.parametrize("fn", ["values", "with_grad"])
def test_point_cotangents_match_jax(fn, C):
    rng = np.random.RandomState(11 + C)
    vol, pts = _query_case(rng, C)
    gv = rng.randn(len(pts), C).astype(np.float32)
    gg = rng.randn(len(pts), 3).astype(np.float32)
    if fn == "values":
        _, vjp = jax.vjp(lambda p: jinterp.trilinear_sample_cf(
            jnp.asarray(vol), p), jnp.asarray(pts))
        (ref,) = vjp(jnp.asarray(gv))
        _, got = tinterp.trilinear_cf_bwd_plain(T(vol), T(pts), T(gv),
                                                points=True)
        public = tinterp.trilinear_sample_cf
        cots = (gv,)
    else:
        _, vjp = jax.vjp(lambda p: jinterp.trilinear_sample_cf_with_grad(
            jnp.asarray(vol), p), jnp.asarray(pts))
        (ref,) = vjp((jnp.asarray(gv), jnp.asarray(gg)))
        _, got = tinterp.trilinear_bwd_plain(T(vol), T(pts), T(gv), T(gg),
                                             points=True)
        public = tinterp.trilinear_sample_cf_with_grad
        cots = (gv, gg)
    assert_scaled_close(got.numpy(), ref, f"{fn} C={C}")
    # the public op takes the same cotangent through its autograd Function
    p = T(pts.copy()).requires_grad_(True)
    outs = public(T(vol), p)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * T(c)).sum() for o, c in zip(outs, cots)).backward()
    assert_scaled_close(p.grad.numpy(), ref, f"{fn} C={C} public")


def _crowded_rays(rng, R=64, S=48, near=24):
    """Ray-major points of R rays from one camera inside a cell of a
    9 x 9 x 9 grid: each ray's first ``near`` samples lie within 0.25 of the
    camera, so R * near of them share its cell (samples converging near a
    camera); the rest spread out to 5 cells away."""
    origin = np.array([4.3, 3.4, 4.6])
    d = rng.randn(R, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.concatenate([np.sort(rng.uniform(0.0, 0.25, (R, near)), 1),
                        np.sort(rng.uniform(0.3, 5.0, (R, S - near)), 1)], 1)
    pts = (origin + d[:, None] * t[..., None]).reshape(-1, 3)
    frac = pts - np.floor(pts)
    pts = np.where(np.minimum(frac, 1 - frac) < 1e-3, pts + 0.01, pts)
    return pts.astype(np.float32)


@pytest.mark.parametrize("layout", ["plane", "row_stride_25"])
@pytest.mark.parametrize("fn", ["values", "with_grad"])
def test_crowded_cell_cotangents_match_jax(fn, layout):
    # more than 1,000 points in one cell at C = 1, read from a plane or as
    # channel 0 of a channel-last 25-channel volume (channel0_view, as the
    # importance rounds read the sdf): both plain versions' cotangents (the
    # volume's, the points') against JAX's vjp; and their float64 runs,
    # which chip_smoke.py's float64_check takes as its reference, lie as
    # close to JAX's fp32 result as to the fp32 plain version's, within
    # that check's bound (twice the fp32 plain version's distance + 1e-7 of
    # the scale)
    rng = np.random.RandomState(17)
    pts = _crowded_rays(rng)
    cell = np.floor(pts).astype(np.int64)
    assert (cell == [4, 3, 4]).all(-1).sum() > 1000
    wide = rng.randn(9, 9, 9, 25).astype(np.float32)
    vol = np.ascontiguousarray(wide[..., 0])[None]
    tvol = (T(vol) if layout == "plane" else
            tinterp.channel0_view(T(wide).permute(3, 0, 1, 2)))
    assert tinterp.row_stride(tvol) == (1 if layout == "plane" else 25)
    gv = rng.randn(len(pts), 1).astype(np.float32)
    gg = rng.randn(len(pts), 3).astype(np.float32)
    if fn == "values":
        _, refs = jit_vjp(jinterp.trilinear_sample_cf,
                          (jnp.asarray(vol), jnp.asarray(pts)),
                          jnp.asarray(gv))

        def plain(v, p, dtype):
            return tinterp.trilinear_cf_bwd_plain(
                v.to(dtype), p.to(dtype), T(gv).to(dtype), points=True)
    else:
        _, refs = jit_vjp(jinterp.trilinear_sample_cf_with_grad,
                          (jnp.asarray(vol), jnp.asarray(pts)),
                          (jnp.asarray(gv), jnp.asarray(gg)))

        def plain(v, p, dtype):
            return tinterp.trilinear_bwd_plain(
                v.to(dtype), p.to(dtype), T(gv).to(dtype), T(gg).to(dtype),
                points=True)
    got = plain(tvol, T(pts), torch.float32)
    got64 = plain(tvol, T(pts), torch.float64)
    for which, g, g64, r in zip(("volume", "points"), got, got64, refs):
        r = np.asarray(r, np.float64)
        assert_scaled_close(g.numpy(), r, f"{fn} {layout} {which}")
        d_jax = float(np.abs(r - g64.numpy()).max())
        d_plain = float(np.abs(g.double().numpy() - g64.numpy()).max())
        scale = float(np.abs(g64.numpy()).max())
        assert d_jax <= 2.0 * d_plain + 1e-7 * scale, (
            f"{fn} {layout} {which}: JAX fp32 {d_jax:.3e} from float64, "
            f"fp32 plain {d_plain:.3e}")


def test_taps_point_cotangent_matches_per_tap_queries():
    # the taps' one query (trilinear_sample_taps) gives each tap the
    # cotangent of a query of its own
    rng = np.random.RandomState(3)
    vol, pts = _query_case(rng, 1, N=60)
    taps = (pts[:, None, :] + rng.uniform(-0.4, 0.4, (60, 6, 3))).astype(
        np.float32)
    g = rng.randn(60, 6, 1).astype(np.float32)
    p = T(taps.copy()).requires_grad_(True)
    (tinterp.trilinear_sample_taps(T(vol), p) * T(g)).sum().backward()
    for t in range(6):
        _, ref = tinterp.trilinear_cf_bwd_plain(T(vol), T(taps[:, t]),
                                                T(g[:, t]), points=True)
        assert torch.equal(p.grad[:, t], ref)


# --------------------------------------------------------- neus functions
def _bins(rng, R=30, S=20):
    near = rng.uniform(0.5, 2.0, R).astype(np.float32)
    ts = near[:, None] + np.cumsum(rng.uniform(0.05, 0.4, (R, S)), 1)
    return ts.astype(np.float32)


def _quantiles(ts, w, t):
    """The positions ``t`` (R, n) as quantiles of the piecewise-linear cdf
    of bins ``ts`` (R, S) and weights ``w`` (R, S - 1) (sample_pdf's, with
    its 1e-5 floor), in float64, and the bin of each."""
    w = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((len(w), 1)), np.cumsum(
        w / w.sum(-1, keepdims=True), -1)], -1)
    q = np.empty(t.shape)
    bins = np.empty(t.shape, np.int64)
    for r in range(len(t)):
        k = np.clip(np.searchsorted(ts[r], t[r], side="right") - 1, 0,
                    ts.shape[1] - 2)
        frac = (t[r] - ts[r, k]) / (ts[r, k + 1] - ts[r, k])
        q[r] = cdf[r, k] + frac * (cdf[r, k + 1] - cdf[r, k])
        bins[r] = k
    return q, bins


def assert_same_quantiles(got, ref, ts, w, what):
    """Each of ``got`` within 1e-6 of ``ref``'s scale, or within 1e-6 as a
    quantile of the reference's cdf, and in the same bin. A new position
    inherits the rounding of the cdf (~1 ulp: XLA's windowed sums and
    ``torch.cumsum`` add in other orders) times its bin's width over its
    probability: a bin of probability 1e-5 turns 1e-7 into 1e-2 of its
    width. Compared as quantiles, where the inverse cdf is ill-conditioned,
    the two packages agree."""
    qg, bg = _quantiles(ts, w, got)
    qr, br = _quantiles(ts, w, ref)
    near = np.abs(got.astype(np.float64) - ref) <= 1e-6 * np.abs(ref).max()
    bad = ~near & (np.abs(qg - qr) > 1e-6)
    assert not bad.any(), (f"{what}: {int(bad.sum())} positions apart, "
                           f"quantiles up to {np.abs(qg - qr)[bad].max()}")
    assert (bg == br).all(), what


def test_sample_pdf_matches_jax():
    rng = np.random.RandomState(4)
    ts = _bins(rng)
    w = (rng.uniform(size=(30, 19)) ** 4).astype(np.float32)
    w[0] = 0.0                                  # flat: every bin 1e-5
    ref = np.asarray(jneus.sample_pdf(jnp.asarray(ts), jnp.asarray(w), 13))
    got = tneus.sample_pdf(T(ts), T(w), 13).numpy()
    assert_same_quantiles(got, ref, ts, w, "sample_pdf")
    # the quantiles drawn, (i + 0.5) / 13, up to the fp32 positions'
    # rounding
    q, _ = _quantiles(ts, w, got)
    np.testing.assert_allclose(q, np.broadcast_to(
        (np.arange(13) + 0.5) / 13, q.shape), atol=1e-5)


def _upsample_weights(ts, sdf, inv_s):
    """upsample_ts's section weights in float64 (neus.py:116-135)."""
    ts, sdf = ts.astype(np.float64), sdf.astype(np.float64)
    mid = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (ts[:, 1:] - ts[:, :-1] + 1e-5)
    prev = np.concatenate([np.zeros_like(cos[:, :1]), cos[:, :-1]], -1)
    cos = np.clip(np.minimum(cos, prev), -1e3, 0.0)
    dist = ts[:, 1:] - ts[:, :-1]
    sig = lambda x: 1 / (1 + np.exp(-x))   # noqa: E731
    p = sig((mid - cos * dist * 0.5) * inv_s)
    n = sig((mid + cos * dist * 0.5) * inv_s)
    alpha = np.clip((p - n + 1e-5) / (p + 1e-5), 0, 1)
    trans = np.concatenate([np.ones_like(alpha[:, :1]), np.cumprod(
        1 - alpha + 1e-7, -1)[:, :-1]], -1)
    return alpha * trans


def test_upsample_and_merge_match_jax():
    rng = np.random.RandomState(5)
    ts = _bins(rng)
    sdf = np.cumsum(-rng.uniform(0.0, 0.3, ts.shape), 1).astype(np.float32)
    sdf += rng.uniform(0.5, 2.0, (30, 1)).astype(np.float32)
    ref = np.asarray(jneus.upsample_ts(jnp.asarray(ts), jnp.asarray(sdf), 9,
                                       16.0))
    got = tneus.upsample_ts(T(ts), T(sdf), 9, 16.0).numpy()
    assert_same_quantiles(got, ref, ts, _upsample_weights(ts, sdf, 16.0),
                          "upsample_ts")
    # the merge on the same positions: the same sort, and the cotangent
    # back to each input position
    cot = rng.randn(30, 29).astype(np.float32)
    merged, vjp = jax.vjp(jneus.merge_ts, jnp.asarray(ts), jnp.asarray(ref))
    g_ts, g_new = vjp(jnp.asarray(cot))
    tt = T(ts.copy()).requires_grad_(True)
    tn = T(ref.copy()).requires_grad_(True)
    out = tneus.merge_ts(tt, tn)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(merged))
    (out * T(cot)).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(g_ts))
    np.testing.assert_array_equal(tn.grad.numpy(), np.asarray(g_new))


# ------------------------------------------------------------- the models
def _jax_model(jcfg, batch):
    jmodel = JSegmentor(cfg=jcfg.model)
    variables = jeval.init_variables(
        jmodel, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = perturb(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]),
                        np.random.RandomState(0))
    return jmodel, variables, np_params


def _step(jcfg, tcfg, extra_draws=None):
    """One JAX loss-and-grad of ``jcfg`` (one jit) at the traced
    ``MID_ITER``, the port's model of ``tcfg`` with the same weights, the
    batch and the replayed draws."""
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, variables, np_params = _jax_model(jcfg, batch)
    rng = jax.random.PRNGKey(3)
    compute = jtrain.make_loss_fn(jmodel, jcfg)

    def with_outputs(params, it):
        tot, (ldict, bs) = compute(params, {}, variables["consts"], jbatch,
                                   rng, it)
        return tot, ldict
    (tot, ldict), grads = quick_jit(
        jax.value_and_grad(with_outputs, has_aux=True),
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.asarray(MID_ITER, jnp.int32))
    jres = {"total": float(tot),
            "losses": {k: float(v) for k, v in ldict.items()},
            "grads": from_jax_variables(
                {"params": jax.tree_util.tree_map(np.asarray, grads)})}
    draws = jax_draws(rng, jcfg)
    if extra_draws is not None:
        draws.update(extra_draws(rng, jcfg))
    tmodel = TPVSegmentor(tcfg.model)
    tmodel.load_state_dict(from_jax_variables({"params": np_params}),
                           strict=True)
    return dict(cfg=tcfg, tmodel=tmodel, batch=batch, draws=draws,
                jres=jres, jmodel=jmodel, variables=variables,
                params=np_params)


def _uniform_shift(rng, cfg):
    """The head's uniform_sdf shift (heads.py:503-506), replayed."""
    rng_h, _ = jax.random.split(jax.random.split(rng)[1])
    h = cfg.model.head
    shape = tuple(int((h.roi_aabb[i + 3] - h.roi_aabb[i]) / h.resolution)
                  for i in (1, 0, 2)) + (3,)
    return {"uniform_shift": np.array(jax.random.uniform(
        jax.random.split(rng_h)[1], shape))}


@pytest.fixture(scope="module")
def importance_step():
    return _step(importance_cfg(jget_config), importance_cfg(get_config))


@pytest.fixture(scope="module")
def options_step():
    return _step(options_cfg(jget_config), options_cfg(get_config),
                 _uniform_shift)


def _run_step(s, chunk=None):
    cfg, tmodel = s["cfg"], s["tmodel"]
    tbatch = {k: T(v.copy()) for k, v in s["batch"].items()}
    tmodel.train()
    if chunk is not None:
        tmodel.head.train_ray_chunk = chunk
    try:
        out = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                     tbatch[cfg.model.head.trans_kw], train=True,
                     draws=s["draws"], global_iter=MID_ITER)
    finally:
        tmodel.head.train_ray_chunk = cfg.model.head.train_ray_chunk
    tot, ldict = tlosses.MultiLoss(cfg.loss_cfgs)(
        ttrain.build_loss_inputs(cfg, out, tbatch))
    tmodel.zero_grad()
    tot.backward()
    return out, tot, ldict


def _assert_step(s, tot, ldict):
    jres = s["jres"]
    assert set(ldict) == set(jres["losses"])
    for k, v in jres["losses"].items():
        np.testing.assert_allclose(float(ldict[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tot.detach()), jres["total"], rtol=1e-5)
    params = dict(s["tmodel"].named_parameters())
    assert set(params) == set(jres["grads"])
    for name, ref in jres["grads"].items():
        assert params[name].grad is not None, name
        assert_grad_close(params[name].grad.numpy(), ref.numpy(), name)


def test_importance_step_matches_jax(importance_step):
    s = importance_step
    out, tot, ldict = _run_step(s)
    S = 16 + 8
    assert out["weights"].shape == (1, 2, 24, S)
    assert out["sample_sdf"].shape == (1, 2, 24, S)
    assert float(ldict["AdaptiveSparsityLoss"].detach()) > 0
    _assert_step(s, tot, ldict)


def test_importance_chunked_render_equals_dense(importance_step):
    # checkpointed chunks of 20 rays (the last padded) keep sample_sdf and
    # give the dense render's losses and gradients
    s = importance_step
    _, tot_d, _ = _run_step(s, 0)
    g_d = {n: p.grad.clone() for n, p in s["tmodel"].named_parameters()}
    out, tot_c, _ = _run_step(s, 20)
    assert out["sample_sdf"].shape == (1, 2, 24, 24)
    np.testing.assert_allclose(float(tot_c.detach()), float(tot_d.detach()),
                               rtol=1e-6)
    for n, p in s["tmodel"].named_parameters():
        assert_grad_close(p.grad.numpy(), g_d[n].numpy(), n)


def test_options_step_matches_jax(options_step):
    s = options_step
    assert not any(".deviation_network." in n
                   for n, _ in s["tmodel"].named_parameters())
    out, tot, ldict = _run_step(s)
    assert out["surface_sdf"].shape == (1, 2, 24)
    assert float(ldict["HardSparsityLoss"].detach()) > 0
    _assert_step(s, tot, ldict)


_JRENDER = {}


def _render(s, opts, vol, origin, direction, train, it=None, key=None,
            draws=None, jit=True):
    """The JAX head's render_rays (jitted once per option set, ``it`` a
    traced step, or eager) and the port's on one volume."""
    name = (tuple(sorted(opts.items())), train, jit)
    if name not in _JRENDER:
        jcfg = with_head(no_dropout(jget_config("tiny")), **opts)
        jmodel = JSegmentor(cfg=jcfg.model)

        def jrender(params, v, o, d, k, gi):
            return jmodel.apply(
                {"params": params, "consts": s["variables"]["consts"]},
                v, o, d, method=lambda m, v, o, d: m.head.render_rays(
                    v, o, d, rng=k, train=train, global_iter=gi))
        _JRENDER[name] = jax.jit(jrender) if jit else jrender
    ref = _JRENDER[name](
        jax.tree_util.tree_map(jnp.asarray, s["params"]), jnp.asarray(vol),
        jnp.asarray(origin), jnp.asarray(direction), key,
        None if it is None else jnp.asarray(it, jnp.int32))
    tmodel = TPVSegmentor(with_head(no_dropout(get_config("tiny")),
                                    **opts).model)
    tmodel.load_state_dict(s["tmodel"].state_dict(), strict=True)
    with torch.no_grad():
        got = tmodel.head.render_rays(T(vol), T(origin), T(direction),
                                      train=train, draws=draws,
                                      global_iter=it)
    return got, {k: np.asarray(v) for k, v in ref.items()}


def _render_case(rng, R=40):
    vol = rng.randn(1 + 3 + 5, 17, 17, 9).astype(np.float32)
    d = np.arange(9, dtype=np.float32)
    vol[0] = 0.6 * (d - 3.3) + 0.3 * vol[0]   # a surface across each ray
    origin = (rng.randn(R, 3) * 2.0).astype(np.float32)
    origin[:, 2] = rng.uniform(1.5, 2.5, R)
    direction = rng.randn(R, 3).astype(np.float32)
    direction[:, 2] = -np.abs(direction[:, 2]) - 0.3
    return vol, origin, direction * 1.7


@pytest.mark.parametrize("opts", [IMPORTANCE, SKIP],
                         ids=["importance", "skip"])
def test_eval_render_matches_jax(importance_step, opts):
    s = importance_step
    vol, origin, direction = _render_case(np.random.RandomState(6))
    # eager JAX: its jitted render rounds the importance positions of
    # low-probability bins otherwise, which moves the neighbouring
    # sections' weights by up to 8e-5 of their scale (JAX against itself)
    got, ref = _render(s, opts, vol, origin, direction, train=False,
                       jit=False)
    S = 24 if opts is IMPORTANCE else 10
    assert got["weights"].shape == (40, S)
    for k in ("depth", "weights", "ts", "acc"):
        assert_scaled_close(got[k].numpy(), ref[k], k)
    # deltas are differences of ts, with their rounding: held at ts' scale
    np.testing.assert_allclose(got["deltas"].numpy(), ref["deltas"], rtol=0,
                               atol=1e-5 * float(np.abs(ref["ts"]).max()))


def test_annealed_band_matches_jax(options_step):
    s = options_step
    vol, origin, direction = _render_case(np.random.RandomState(7), R=20)
    key = jax.random.PRNGKey(9)
    rest, sample_rng = jax.random.split(key)
    _, bkgd_rng = jax.random.split(rest)
    draws = {"t_rand": T(np.array(jax.random.uniform(
        sample_rng, (20, 17), jnp.float32))),
        "bkgd": T(np.array(jax.random.uniform(bkgd_rng, (20, 3),
                                              jnp.float32)))}
    total = s["cfg"].model.head.total_iters
    fars = []
    for it in (0, MID_ITER, total):
        got, ref = _render(s, OPTIONS, vol, origin, direction, True, it,
                           key, draws)
        for k in ("fars", "ts", "inv_s"):
            assert_scaled_close(got[k].numpy(), ref[k], f"{k} at {it}")
        # depth sums weights times positions: held at the positions' scale
        # (the early band's rays are nearly empty, depth ~1e-3)
        np.testing.assert_allclose(
            got["depth"].numpy(), ref["depth"], rtol=0,
            atol=1e-5 * float(np.abs(ref["ts"]).max()), err_msg=str(it))
        fars.append(got["fars"])
    # the band widens with the schedule
    assert (fars[0] <= fars[1] + 1e-6).all() and \
        (fars[1] <= fars[2] + 1e-6).all() and (fars[0] < fars[2]).any()


def test_beta_schedule_matches_jax():
    for it in (0, 1, MID_ITER, 3516 * 11, 10 ** 6):
        ref = float(jheads.beta_schedule(0.1, 0.195, 3516 * 11,
                                         jnp.asarray(it, jnp.int32)))
        assert theads.beta_schedule(0.1, 0.195, 3516 * 11, it) == ref


def test_two_split_matches_jax(importance_step):
    s = importance_step
    out, _, _ = _run_step(s)
    num = {k: (np.asarray(v.detach()) if torch.is_tensor(v)
               else [np.asarray(x.detach()) for x in v])
           for k, v in out.items() if k != "ms_rays"}
    ref = jheads.split_cams_for_losses(num, 2)
    got = theads.split_cams_for_losses(
        {k: v for k, v in out.items() if k != "ms_rays"}, 2)
    assert set(got) == set(ref)
    for k, v in ref.items():
        gv = got[k]
        if isinstance(v, list):
            for a, b in zip(gv, v):
                np.testing.assert_array_equal(a.detach().numpy(), b)
        else:
            np.testing.assert_array_equal(gv.detach().numpy(), v)
    # the head splits its own outputs with two_split on
    cfg = with_head(s["cfg"], two_split=True)
    tmodel = TPVSegmentor(cfg.model)
    tmodel.load_state_dict(s["tmodel"].state_dict(), strict=True)
    tbatch = {k: T(v.copy()) for k, v in s["batch"].items()}
    with torch.no_grad():
        split = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                       tbatch[cfg.model.head.trans_kw], train=True,
                       draws=s["draws"], global_iter=MID_ITER)
    for k in ("weights", "ts", "sample_sdf"):
        np.testing.assert_array_equal(split[k].numpy(), ref[k])
    np.testing.assert_array_equal(split["ms_colors"][0].numpy(),
                                  ref["ms_colors"][0])


# ---------------------------------------------------------- the losses
@pytest.mark.parametrize("name", ["SparsityLoss", "HardSparsityLoss",
                                  "AdaptiveSparsityLoss"])
def test_sparsity_losses_match_jax(name):
    rng = np.random.RandomState(8)
    if name == "AdaptiveSparsityLoss":
        kw = dict(slack=0.5)
        inputs = {"sdfs": rng.randn(1, 2, 6, 7).astype(np.float32),
                  "ts": np.cumsum(rng.uniform(0.1, 0.5, (1, 2, 6, 7)),
                                  -1).astype(np.float32),
                  "ms_depths": [rng.uniform(0.3, 1.5, (1, 2, 6)).astype(
                      np.float32)]}
        wrt = "sdfs"
    else:
        kw = dict(scale=0.8) if name == "SparsityLoss" else dict(
            scale=1.5, thresh=0.1, crop=((1, 2), (0, 3), (2, 1)))
        inputs = {"density": rng.randn(8, 9, 5).astype(np.float32)}
        wrt = "density"
    jl = getattr(jlosses, name)(weight=0.7, **kw)
    tl = tlosses.build_loss(dict(type=name, weight=0.7, **kw))

    def jf(x):
        return jl({**jax.tree_util.tree_map(jnp.asarray, inputs), wrt: x})
    ref, jg = jax.value_and_grad(jf)(jnp.asarray(inputs[wrt]))
    x = T(inputs[wrt].copy()).requires_grad_(True)
    targs = {k: ([T(a.copy()) for a in v] if isinstance(v, list)
                 else T(v.copy())) for k, v in inputs.items()}
    got = tl({**targs, wrt: x})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)


def test_check_ported_accepts_the_head_options():
    cfg = get_config("tiny")
    for opts in (IMPORTANCE, OPTIONS, SKIP, dict(two_split=True)):
        check_ported(with_head(cfg, **opts).model)
        TPVSegmentor(with_head(cfg, **opts).model)
