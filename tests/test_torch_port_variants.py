"""The model options that the port added last, against the JAX package on
the CPU: ``TPVPositionLifter``, ``CameraAwareSE`` (train- and eval-mode
BatchNorm, with and without its reduce conv), ``NonLinearMapping``
(``linear_upscale``: both directions, and the slope of ``meter2grid`` off
its knots and on them), the per-plane norms and FFNs of
``multi_plane_ffn_norm``, ``ray_sample_mode="random"`` (JAX's draws
replayed), each option alone in a ``tiny`` training step, one ``tiny``
model with all five at once (forward outputs, losses and every gradient
against one jitted JAX loss-and-grad) and the BEV flow head
(``estimate_flow``: its outputs and a vjp).

JAX's ``init_variables`` calls ``model.init`` without the cameras, which a
camera-aware encoder needs, so the all-options model is initialised here
with ``intrinsic`` / ``cam2ego``. Tolerances: op-level outputs 1e-5 of
their scale (bit-equal where the op is elementwise), losses rtol 1e-5,
gradients ``max|d| <= 1e-4 * max|g_ref| + 1e-7`` per tensor, as in
``test_torch_port_train.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.geometry.mappings import make_mapping as jmake_mapping
from selfocc_tpu.geometry.ray_sampler import RaySampler as JRaySampler
from selfocc_tpu.models import encoder as jenc
from selfocc_tpu.models.heads import NeuSHead as JNeuSHead
from selfocc_tpu.models.lifter import TPVPositionLifter as JPositionLifter
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import bridge
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.geometry.mappings import make_mapping
from selfocc_tpu_torch.geometry.ray_sampler import RaySampler
from selfocc_tpu_torch.models import encoder as tenc
from selfocc_tpu_torch.models.heads import NeuSHead
from selfocc_tpu_torch.models.initializers import init_weights
from selfocc_tpu_torch.models.lifter import TPVPositionLifter
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import train_lib as ttrain
from test_torch_port_threads import share_cores_with_xdist_workers
from test_torch_port_train import (assert_grad_close, no_dropout, perturb)
from torch_port_jax import (jit_apply, jit_vjp,  # noqa: F401
                            memoised_jax_init, quick_jit)

share_cores_with_xdist_workers()

T = torch.from_numpy
# the tiny grid (17 x 17 x 9) under the reference's NonLinearMapping: 6
# inner cells of 1 m and 2 outer cells growing to 10 m on each side, z from
# -1 m (6 cells of 0.4 m, 2 growing ones to 3 m)
NONLINEAR = dict(nonlinear_mode="linear_upscale", h_size=[6, 2],
                 h_range=[6.0, 4.0], h_half=False, w_size=[6, 2],
                 w_range=[6.0, 4.0], w_half=False, d_size=[6, 2],
                 d_range=[-1.0, 1.4, 3.0])
OPTIONS = ("position_lifter", "camera_aware", "linear_upscale",
           "multi_plane_ffn_norm", "random_rays")


def with_options(cfg, options=OPTIONS):
    """``cfg`` (either package's ``tiny``) with the model ``options`` on,
    by ``dataclasses.replace`` as a user's variant config would be."""
    m = cfg.model
    enc, head = m.encoder, m.head
    if "linear_upscale" in options:
        enc = dataclasses.replace(enc, mapping_args=dict(NONLINEAR))
        head = dataclasses.replace(head, mapping_args=dict(NONLINEAR))
    if "camera_aware" in options:
        enc = dataclasses.replace(enc, camera_aware=True)
    if "multi_plane_ffn_norm" in options:
        enc = dataclasses.replace(enc, multi_plane_ffn_norm=True)
    if "random_rays" in options:
        head = dataclasses.replace(head, ray_sample_mode="random")
    m = dataclasses.replace(m, encoder=enc, head=head)
    if "position_lifter" in options:
        m = dataclasses.replace(
            m, lifter_type="TPVPositionLifter", lifter_args=dict(
                tot_range=tuple(enc.pc_range),
                num_freqs=tuple(enc.pos_num_freqs),
                mapping_args=dict(enc.mapping_args)))
    return dataclasses.replace(cfg, model=m)


def tiny_batch(cfg):
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    return {k: np.asarray(v) for k, v in ds[0].items()
            if not isinstance(v, (str, dict))}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_scaled_close(got, ref, rtol=1e-5, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rtol * max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


# ------------------------------------------------------------ op level
@pytest.mark.parametrize("mapping", ["linear", "linear_upscale"])
def test_position_lifter_matches_jax(mapping):
    mapping_args = dict(NONLINEAR) if mapping == "linear_upscale" else \
        dict(get_config("tiny").model.encoder.mapping_args)
    kw = dict(tot_range=(-10.0, -10.0, -1.0, 10.0, 10.0, 3.0),
              num_freqs=(4, 3, 5), mapping_args=mapping_args)
    feats = [jnp.zeros((1, 2, 4, 6, 32))]
    jl = JPositionLifter(embed_dims=32, **kw)
    params = perturb(to_np(jl.init(jax.random.PRNGKey(0), feats)["params"]),
                     np.random.RandomState(1))
    ref = jl.apply({"params": to_jnp(params)}, feats)["representation"]
    tl = TPVPositionLifter(32, **kw)
    sd = {}
    for plane in ("hw", "zh", "wz"):
        bridge._linear(sd, f"position_layer_{plane}",
                       params[f"position_layer_{plane}"])
    tl.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tl([torch.zeros(1, 2, 4, 6, 32)])
    for g, r in zip(got, ref):
        assert_scaled_close(g.numpy(), r, 1e-6, "position lifter")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("mid", [32, 16], ids=["mid32", "mid16"])
def test_camera_aware_se_matches_jax(train, mid):
    # mid == embed_dims (the encoder's default) skips the reduce conv
    rng = np.random.RandomState(2)
    feats = [rng.randn(1, 2, h, w, 32).astype(np.float32)
             for h, w in ((8, 12), (4, 6))]
    batch = tiny_batch(get_config("tiny"))
    K, c2e = batch["intrinsic"], batch["cam2ego"]           # (1, N, 4, 4)
    jse = jenc.CameraAwareSE(in_channels=32, mid_channels=mid,
                             out_channels=32)
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(K), jnp.asarray(c2e))
    variables = to_np(jax.jit(jse.init, static_argnames="train")(
        jax.random.PRNGKey(0), *args, train=False))
    np_vars = {"params": perturb(variables["params"], rng),
               "batch_stats": perturb(variables["batch_stats"], rng)}
    ref, mutated = jse.apply(to_jnp(np_vars), *args, train=train,
                             mutable=["batch_stats"])
    tse = tenc.CameraAwareSE(32, mid, 32).train(train)
    sd = {}
    bridge._camera_se(sd, np_vars["params"], np_vars["batch_stats"])
    tse.load_state_dict({k[len("encoder.camera_se_net."):]: v
                         for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tse([T(f) for f in feats], T(K), T(c2e))
    for g, r in zip(got, ref):
        assert_scaled_close(g.numpy(), r, 1e-5, "CameraAwareSE")
    stats = {}
    bridge._camera_se(stats, np_vars["params"], to_np(
        mutated["batch_stats"]))
    for k, v in tse.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(
                v.numpy(), stats[f"encoder.camera_se_net.{k}"].numpy(),
                rtol=1e-5, atol=1e-6, err_msg=k)


def _knot_points(m):
    """Metric points on the mapping's knots and ties: each axis at 0, at
    +-range_inner (the inner / outer seam: ``minimum`` and ``maximum`` tie)
    and at the outer edge, z at its start, at the inner edge and at the
    top."""
    r_in = m.range_inner
    r_out = r_in + m.range_outer
    zs = m.z_ranges
    xs = [0.0, r_in, -r_in, r_out, -r_out, 0.5 * r_in]
    return np.array([[x, y, z] for x in xs for y in xs[:3]
                     for z in (zs[0], zs[1], zs[2], 0.0)], np.float32)


@pytest.mark.parametrize("points", ["random", "knots"])
def test_nonlinear_mapping_matches_jax(points):
    jm, tm = jmake_mapping(**NONLINEAR), make_mapping(**NONLINEAR)
    assert (tm.size_h, tm.size_w, tm.size_d) == \
        (jm.size_h, jm.size_w, jm.size_d) == (17, 17, 9)
    rng = np.random.RandomState(3)
    if points == "random":
        xyz = rng.uniform([-11, -11, -1.5], [11, 11, 3.5],
                          (4096, 3)).astype(np.float32)
    else:
        xyz = _knot_points(tm)
    got = tm.meter2grid(T(xyz)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.meter2grid(
        jnp.asarray(xyz))))
    grid = rng.uniform(0, [16, 16, 8], (4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.grid2meter(T(grid)).numpy(),
        np.asarray(jm.grid2meter(jnp.asarray(grid))))
    # the diagonal of the Jacobian, as the JAX field takes it: one eager
    # jax.jvp per metric axis (h <- y, w <- x, d <- z)
    cols = [np.asarray(jax.jvp(jm.meter2grid, (jnp.asarray(xyz),), (
        jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32)[k], xyz.shape),))[1])
        for k in range(3)]
    ref = np.stack([cols[1][:, 0], cols[0][:, 1], cols[2][:, 2]], -1)
    np.testing.assert_array_equal(tm.meter2grid_slope(T(xyz)).numpy(), ref)
    if points == "knots":
        # the rules the slope keeps: 0 at a coordinate of exactly 0, half
        # the tangent from each side of a tie, none from floor
        assert (ref[(xyz[:, 1] == 0), 0] == 0).all()
        inner = 1.0 / tm.hw_unit
        outer = 1.0 / (tm.hw_unit + tm.increase_unit)
        seam = np.abs(xyz[:, 0]) == np.float32(tm.range_inner)
        np.testing.assert_allclose(ref[seam, 1], 0.5 * inner + 0.5 * outer,
                                   rtol=1e-6)


def test_multi_plane_layer_matches_jax():
    # one encoder layer with per-plane LayerNorms and FFNs, random inputs
    H, W, D, C = 5, 7, 3, 16
    rng = np.random.RandomState(4)
    planes = [rng.randn(1, n, C).astype(np.float32)
              for n in (H * W, D * H, W * D)]
    pos = [rng.randn(1, n, C).astype(np.float32)
           for n in (H * W, D * H, W * D)]
    shapes = ((4, 6), (2, 3))
    value = rng.randn(2, sum(h * w for h, w in shapes), C).astype(np.float32)
    cvr = tenc.get_cross_view_ref_points(H, W, D, (2, 2, 2))
    refs, masks = [], []
    for n in (H * W, D * H, W * D):
        refs.append(rng.uniform(-0.1, 1.1, (2, n, 2, 2)).astype(np.float32))
        masks.append(rng.rand(2, n, 2) > 0.3)
    layer = jenc.TPVFormerLayer(
        embed_dims=C, num_heads=2, num_levels=2, num_points_cross=(2, 2, 2),
        num_points_self=2, feedforward_channels=24, img_spatial_shapes=shapes,
        tpv_size=(H, W, D), dropout=0.0, multi_plane_ffn_norm=True)
    args = (tuple(jnp.asarray(p) for p in planes), jnp.asarray(value),
            tuple(jnp.asarray(p) for p in pos), jnp.asarray(cvr),
            tuple(jnp.asarray(r) for r in refs),
            tuple(jnp.asarray(m) for m in masks))
    params = perturb(to_np(jax.jit(layer.init)(jax.random.PRNGKey(0), *args)[
        "params"]), rng)
    ref, _ = jit_apply(layer, {"params": to_jnp(params)}, *args)
    tl = tenc.TPVFormerLayer(C, 2, 2, (2, 2, 2), 2, 24, (H, W, D),
                             multi_plane=True).eval()
    sd = {}
    bridge._encoder_layer(sd, "l", params)
    assert all(f"l.norms.{j}.{i}.weight" in sd and f"l.ffns.{i}.layers.1."
               "weight" in sd for i in range(3) for j in range(3))
    tl.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tl([T(p) for p in planes], T(value), [T(p) for p in pos],
                 T(cvr), [T(r) for r in refs], [T(m) for m in masks], shapes)
    for g, r in zip(got, ref):
        # post-LayerNorm features through fp32 deformable attention
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


def test_random_rays_match_jax():
    kw = dict(ray_sample_mode="random", ray_number=(6, 10),
              ray_img_size=(48, 80))
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JRaySampler(**kw)(key))
    draws = np.array(jax.random.uniform(key, (60, 2), jnp.float32))
    got = RaySampler(**kw)(draws=draws).numpy()
    np.testing.assert_array_equal(got, ref)
    gen = torch.Generator().manual_seed(0)
    rays = RaySampler(**kw)(generator=gen)
    assert rays.shape == (60, 2)
    assert (rays >= 0).all() and (rays[:, 0] < 80).all() \
        and (rays[:, 1] < 48).all()


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("option", OPTIONS)
def test_each_option_alone_trains(option):
    # one port tiny step per option alone: builds, steps, finite, and the
    # option's parameters get gradients
    cfg = with_options(get_config("tiny"), (option,))
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    trainer = ttrain.Trainer(cfg, model)
    batch = {k: T(v.copy()) for k, v in tiny_batch(cfg).items()}
    m = trainer.step(batch, torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(v)) for k, v in m.items() if k != "times")
    own = {"position_lifter": "lifter.position_layer_hw.weight",
           "camera_aware": "encoder.camera_se_net.context_conv.weight",
           "multi_plane_ffn_norm": "encoder.layers.0.ffns.2.layers.1.weight"}
    if option in own:
        p = dict(model.named_parameters())[own[option]]
        assert p.grad is not None and float(p.grad.abs().sum()) > 0


def jax_draws(rng, cfg):
    """The head's uniforms of one JAX train step with random rays,
    replaying the key splits (``test_torch_port_train.jax_draws``)."""
    h = cfg.model.head
    _, fwd_rng = jax.random.split(rng)
    rng_h, ray_rng = jax.random.split(fwd_rng)
    n = h.ray_number[0] * h.ray_number[1]
    rays = jax.random.uniform(ray_rng, (n, 2), jnp.float32)
    R = cfg.num_cams * n
    rng_r, sample_rng = jax.random.split(rng_h)
    t_rand = jax.random.uniform(sample_rng, (R, h.num_samples + 1),
                                jnp.float32)
    _, bkgd_rng = jax.random.split(rng_r)
    bkgd = jax.random.uniform(bkgd_rng, (R, 3), jnp.float32)
    return {"random": np.array(rays), "t_rand": np.array(t_rand),
            "bkgd": np.array(bkgd)}


@pytest.fixture(scope="module")
def all_options_step():
    """One JAX ``tiny`` loss-and-grad with all five options (dropout 0),
    jitted once, and the port's step on the same weights and draws."""
    cfg = no_dropout(with_options(jget_config("tiny")))
    tcfg = no_dropout(with_options(get_config("tiny")))
    batch = tiny_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JSegmentor(cfg=cfg.model)
    key = jax.random.PRNGKey(42)
    variables = quick_jit(lambda b: jmodel.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        b["imgs"], b["lidar2img"], b[cfg.model.head.trans_kw], key, 0, True,
        intrinsic=b["intrinsic"], cam2ego=b["cam2ego"]), jbatch)
    rng = np.random.RandomState(0)
    np_vars = {"params": perturb(to_np(variables["params"]), rng),
               "batch_stats": perturb(to_np(variables["batch_stats"]), rng)}
    jkey = jax.random.PRNGKey(3)
    compute = jtrain.make_loss_fn(jmodel, cfg)
    (tot, (ldict, new_bs)), grads = quick_jit(
        lambda *a: jax.value_and_grad(compute, has_aux=True)(*a, 0),
        to_jnp(np_vars["params"]), to_jnp(np_vars["batch_stats"]),
        variables.get("consts"), jbatch, jkey)
    jres = {"total": float(tot),
            "losses": {k: float(v) for k, v in ldict.items()},
            "grads": from_jax_variables({"params": to_np(grads)}),
            "stats": from_jax_variables({"params": np_vars["params"],
                                         "batch_stats": to_np(new_bs)})}
    tmodel = TPVSegmentor(tcfg.model).train()
    tmodel.load_state_dict(from_jax_variables(np_vars), strict=True)
    tbatch = {k: T(v.copy()) for k, v in batch.items()}
    out = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                 tbatch[tcfg.model.head.trans_kw], train=True,
                 draws=jax_draws(jkey, cfg),
                 **ttrain.aug_kwargs(tbatch, camera_aware=True))
    ttot, tldict = tlosses.MultiLoss(tcfg.loss_cfgs)(
        ttrain.build_loss_inputs(tcfg, out, tbatch))
    ttot.backward()
    return jres, tmodel, float(ttot.detach()), {
        k: float(v.detach()) for k, v in tldict.items()}


def test_all_options_losses_match_jax(all_options_step):
    jres, _, total, losses = all_options_step
    assert set(losses) == set(jres["losses"])
    for k, v in jres["losses"].items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total, jres["total"], rtol=1e-5)


def test_all_options_gradients_match_jax(all_options_step):
    jres, tmodel, _, _ = all_options_step
    named = dict(tmodel.named_parameters())
    assert set(named) == set(jres["grads"])
    for name, g in jres["grads"].items():
        assert named[name].grad is not None, name
        assert_grad_close(named[name].grad.numpy(), g.numpy(), name)


def test_all_options_batchnorm_stats_match_jax(all_options_step):
    # the train-mode forward's running statistics (CameraAwareSE's
    # BatchNorm among them) against the JAX step's mutated batch_stats
    jres, tmodel, _, _ = all_options_step
    stats = {k: v for k, v in tmodel.state_dict().items() if "running" in k}
    assert any(k.startswith("encoder.camera_se_net.") for k in stats)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), jres["stats"][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ flow head
def _flow_heads():
    kw = dict(roi_aabb=(-10.0, -10.0, -1.0, 10.0, 10.0, 3.0),
              mapping_args=dict(get_config("tiny").model.head.mapping_args),
              resolution=1.0, num_samples=16, embed_dims=16,
              ray_sample_mode="cellular", ray_number=(4, 6),
              ray_img_size=(32, 48), render_bkgd="white", tpv=False)
    return JNeuSHead(estimate_flow=True, **kw), NeuSHead(estimate_flow=True,
                                                          **kw)


def _cameras():
    cams = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    f = 24.0
    K = np.array([[f, 0, 24, 0], [0, f, 16, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    look_x = np.array([[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0.3],
                       [0, 0, 0, 1]], np.float32)
    look_y = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0.3],
                       [0, 0, 0, 1]], np.float32)
    for i, c2w in enumerate((look_x, look_y)):
        cams[0, i] = c2w @ np.linalg.inv(K)
    return cams


@pytest.fixture(scope="module")
def flow_head():
    jhead, thead = _flow_heads()
    rng = np.random.RandomState(6)
    rep = (rng.randn(1, 17 * 17, 16) * 0.3).astype(np.float32)
    prev = rep + (0.1 * rng.randn(*rep.shape)).astype(np.float32)
    nxt = rep - (0.1 * rng.randn(*rep.shape)).astype(np.float32)
    cams = _cameras()
    key = jax.random.PRNGKey(0)
    variables = to_np(jax.jit(lambda r, c, p, n: jhead.init(
        key, r, c, key, 0, True, prev_rep=p, next_rep=n))(
            jnp.asarray(rep), jnp.asarray(cams), jnp.asarray(prev),
            jnp.asarray(nxt)))
    np_vars = {"params": perturb(variables["params"], rng),
               "batch_stats": perturb(variables["batch_stats"], rng)}
    sd = {}
    bridge._head(sd, np_vars["params"], np_vars["batch_stats"])
    thead.load_state_dict({k[len("head."):]: v for k, v in sd.items()},
                          strict=True)
    _, fwd_rng = jax.random.split(key)
    rng_h, ray_rng = jax.random.split(fwd_rng)
    cellular = [float(jax.random.uniform(k))
                for k in jax.random.split(ray_rng, 4)]
    _, sample_rng = jax.random.split(rng_h)
    t_rand = np.array(jax.random.uniform(sample_rng, (48, 17), jnp.float32))
    draws = {"cellular": np.asarray(cellular, np.float32), "t_rand": t_rand}
    return jhead, thead, np_vars, (rep, prev, nxt, cams), fwd_rng, draws


OUT_KEYS = ("curr2prev_flow", "curr2next_flow", "prev2curr_flow",
            "next2curr_flow", "prev_warp", "next_warp", "ms_depths")


def test_flow_head_outputs_match_jax(flow_head):
    jhead, thead, np_vars, (rep, prev, nxt, cams), jrng, draws = flow_head

    def run(variables, r):
        out, _ = jhead.apply(variables, r, jnp.asarray(cams), jrng, 0, True,
                             prev_rep=jnp.asarray(prev),
                             next_rep=jnp.asarray(nxt),
                             mutable=["batch_stats"])
        return {k: out[k] for k in OUT_KEYS}

    ref = jax.jit(run)(to_jnp(np_vars), jnp.asarray(rep))
    thead.train()
    with torch.no_grad():
        got = thead(T(rep), T(cams), train=True, draws=draws,
                    prev_rep=T(prev), next_rep=T(nxt))
    for k in OUT_KEYS:
        g = got[k][0] if k == "ms_depths" else got[k]
        r = ref[k][0] if k == "ms_depths" else ref[k]
        assert_scaled_close(g.numpy(), r, 1e-5, k)


def test_flow_head_vjp_matches_jax(flow_head):
    # the cotangents of the warped samples and the flows reach the flow
    # net's weights, the three planes and (through the border lookup at
    # C = 3) the flow volumes
    jhead, thead, np_vars, (rep, prev, nxt, cams), jrng, draws = flow_head
    rng = np.random.RandomState(7)
    keys = ("prev_warp", "next_warp", "curr2prev_flow", "next2curr_flow")

    def fn(params, r, p, n):
        out, _ = jhead.apply({"params": params,
                              "batch_stats": np_vars["batch_stats"]},
                             r, jnp.asarray(cams), jrng, 0, True,
                             prev_rep=p, next_rep=n, mutable=["batch_stats"])
        return {k: out[k] for k in keys}

    primals = (to_jnp(np_vars["params"]), jnp.asarray(rep),
               jnp.asarray(prev), jnp.asarray(nxt))
    shapes = jax.eval_shape(fn, *primals)
    cot = {k: rng.randn(*shapes[k].shape).astype(np.float32) for k in keys}
    _, (g_params, g_rep, g_prev, g_nxt) = jit_vjp(fn, primals, to_jnp(cot))
    thead.train()
    thead.zero_grad(set_to_none=True)
    leaves = [T(x.copy()).requires_grad_(True) for x in (rep, prev, nxt)]
    out = thead(leaves[0], T(cams), train=True, draws=draws,
                prev_rep=leaves[1], next_rep=leaves[2])
    torch.autograd.backward([out[k] for k in keys],
                            [T(cot[k]) for k in keys])
    for leaf, g, name in zip(leaves, (g_rep, g_prev, g_nxt),
                             ("rep", "prev_rep", "next_rep")):
        assert_grad_close(leaf.grad.numpy(), np.asarray(g), name)
    sd = {}
    bridge._head(sd, to_np(g_params), {})
    for name, p in thead.named_parameters():
        ref = sd[f"head.{name}"].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        assert_grad_close(got, ref, name)
