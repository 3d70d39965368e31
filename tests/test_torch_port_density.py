"""The density head of the port against the JAX package on the CPU, at
``tiny_nerfacc``: ``weights_from_alpha``'s plain pair against JAX
``neus.weights_from_alpha`` and its vjp (saturated rows included, and
against a float64 reference), ``occupancy_grid``, ``NeRFAccHead.
render_rays`` with JAX's replayed draws (outputs and the volume's
cotangent), a ``tiny_nerfacc`` forward and loss-and-grad through the
bridge, ``eval_iou --density`` (the uniform grid and Occ3D) and
``eval_depth`` against the JAX drivers, and one ``train`` step.

Weights: the JAX init with numpy noise on every leaf (``perturb``), handed
to the port through ``bridge.from_jax_variables``; dropout 0. Tolerances as
in ``tests/test_torch_port_train.py``: forward outputs within 1e-5 of their
scale, losses rtol 1e-5, gradients ``1e-4 * max|ref| + 1e-7`` per tensor.
"""
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import eval_depth as jeval_depth
import eval_iou as jeval_iou
from selfocc_tpu import losses as jlosses
from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.models import density_head as jdensity
from selfocc_tpu.models import neus as jneus
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import metrics as jmetrics
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import eval_depth, eval_iou, train
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.density_head import (NeRFAccHead,
                                                   occupancy_grid)
from selfocc_tpu_torch.models.segmentor import TPVSegmentor, check_ported
from selfocc_tpu_torch.ops.render_weights import (weights_from_alpha,
                                                  weights_from_alpha_plain,
                                                  weights_grad_plain)
from selfocc_tpu_torch.utils import eval_lib as teval
from selfocc_tpu_torch.utils import train_lib as ttrain
from test_torch_port_bev import _batch, assert_scaled_close
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init, quick_jit  # noqa: F401
from test_torch_port_train import (assert_grad_close, jax_draws, no_dropout,
                                   perturb)

share_cores_with_xdist_workers()

T = torch.from_numpy
CHUNK = 96           # rays per render chunk in the driver runs
THRESH = 0.5         # the density threshold of the eval_iou runs


# ------------------------------------------------------------ the weights
def _alpha_rows(rng, R=64, S=40):
    """Alpha in [0, 1] with saturated rows: exactly 1 mid-ray, 1 - 1 ulp,
    every sample 1, exact zeros, every sample 0."""
    alpha = (rng.uniform(size=(R, S)) ** 3).astype(np.float32)
    alpha[0, 10] = 1.0
    alpha[1, 5:9] = np.float32(1.0) - np.float32(2 ** -24)
    alpha[2] = 1.0
    alpha[3, ::3] = 0.0
    alpha[4] = 0.0
    alpha[5, 20:] = 0.999
    return alpha


def _float64_weights(a):
    """The weights in float64 of (R, S) float64 alpha ``a``."""
    b = 1.0 - a + 1e-7
    trans = torch.cat([torch.ones_like(b[:, :1]),
                       torch.cumprod(b, -1)[:, :-1]], -1)
    return a * trans


def test_weights_from_alpha_plain_matches_jax_and_float64():
    rng = np.random.RandomState(0)
    alpha = _alpha_rows(rng)
    g = rng.randn(*alpha.shape).astype(np.float32)
    ref, vjp = jax.vjp(jneus.weights_from_alpha, jnp.asarray(alpha))
    (g_ref,) = vjp(jnp.asarray(g))
    ta = T(alpha.copy()).requires_grad_(True)
    w = weights_from_alpha(ta)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    (w * T(g)).sum().backward()
    assert_grad_close(ta.grad.numpy(), g_ref, "alpha")
    # float64: the same fp32 alpha, weights and their exact vjp
    a64 = torch.from_numpy(alpha).double().requires_grad_(True)
    w64 = _float64_weights(a64)
    (g64,) = torch.autograd.grad(w64, a64, torch.from_numpy(g).double())
    np.testing.assert_allclose(w.detach().numpy(), w64.detach().numpy(),
                               rtol=0, atol=1e-6)
    # each row within 1e-5 of its own cotangent's scale: the recurrence
    # keeps the digits where alpha saturates (rows 0-2, 5)
    got = ta.grad.double()
    scale = g64.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    assert float(((got - g64).abs() / scale).max()) <= 1e-5
    # the plain backward entry is the same function
    assert torch.equal(weights_grad_plain(T(alpha), T(g)), ta.grad)
    assert torch.equal(weights_from_alpha_plain(T(alpha)), w.detach())


def test_weights_from_alpha_refuses_cpu_kernels():
    # on a CPU tensor the wrapper takes its plain versions; the kernels take
    # CUDA tensors only
    from selfocc_tpu_torch.ops.render_weights import (neus_weights_bwd,
                                                      neus_weights_fwd)
    a = torch.rand(4, 8)
    with pytest.raises(ValueError):
        neus_weights_fwd(a)
    with pytest.raises(ValueError):
        neus_weights_bwd(a, torch.rand(4, 8))


@pytest.mark.parametrize("thre", [0.0, THRESH])
def test_occupancy_grid_matches_jax(thre):
    rng = np.random.RandomState(1)
    vol = (rng.randn(3, 9, 11, 7) * 4.0).astype(np.float32)
    vol[0, 0, 0, :] = [-200.0, -90.0, -30.0, 0.0, 30.0, 90.0, 200.0]
    got = occupancy_grid(T(vol), thre).numpy()
    ref = np.asarray(jdensity.occupancy_grid(jnp.asarray(vol), thre))
    dens = np.asarray(jax.nn.softplus(jnp.asarray(vol[0])))
    # a density that rounds to the threshold may fall either way
    may = np.abs(dens - thre) <= 1e-6 * max(thre, 1e-30)
    assert got.shape == ref.shape == (9, 11, 7)
    assert not ((got != ref) & ~may).any()


# ------------------------------------------------------- tiny_nerfacc
@pytest.fixture(scope="module")
def density_step():
    """One JAX ``tiny_nerfacc`` forward and loss-and-grad (dropout 0, one
    jit), the bridged port model, the batch and the draws."""
    cfg = no_dropout(jget_config("tiny_nerfacc"))
    tcfg = no_dropout(get_config("tiny_nerfacc"))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JSegmentor(cfg=cfg.model)
    variables = jeval.init_variables(jmodel, cfg, jbatch)
    np_params = perturb(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]),
                        np.random.RandomState(0))
    rng = jax.random.PRNGKey(3)
    loss_fn = jlosses.MultiLoss(cfg.loss_cfgs)

    def compute(params):
        drop_rng, fwd_rng = jax.random.split(rng)
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": {},
             "consts": variables["consts"]},
            jbatch["imgs"], jbatch["lidar2img"],
            jbatch[cfg.model.head.trans_kw], fwd_rng, 0, True,
            rngs={"dropout": drop_rng}, mutable=["batch_stats"])
        tot, ldict = loss_fn(jtrain.build_loss_inputs(cfg, out, jbatch))
        keep = {"depth": out["ms_depths"][0], "rgb": out["ms_colors"][0],
                "acc": out["ms_accs"][0], "weights": out["weights"],
                "ts": out["ts"], "deltas": out["deltas"],
                "sem": out["sem"][0]}
        return tot, (ldict, keep)
    (tot, (ldict, outs)), grads = quick_jit(
        jax.value_and_grad(compute, has_aux=True),
        jax.tree_util.tree_map(jnp.asarray, np_params))
    jres = {"total": float(tot),
            "losses": {k: float(v) for k, v in ldict.items()},
            "outs": {k: np.asarray(v) for k, v in outs.items()},
            "grads": from_jax_variables(
                {"params": jax.tree_util.tree_map(np.asarray, grads)})}
    tmodel = TPVSegmentor(tcfg.model)
    tmodel.load_state_dict(from_jax_variables({"params": np_params}),
                           strict=True)
    return dict(cfg=tcfg, tmodel=tmodel, batch=batch,
                draws=jax_draws(rng, cfg), jres=jres, params=np_params,
                consts=jax.tree_util.tree_map(np.asarray,
                                              variables["consts"]),
                jmodel=jmodel)


def test_render_rays_matches_jax(density_step):
    # the training render on one volume with replayed draws: every output,
    # then the volume's cotangent of depth, rgb, sem and the weights
    s = density_step
    head = s["tmodel"].head
    assert isinstance(head, NeRFAccHead)
    rng = np.random.RandomState(2)
    C = 1 + 3 + 5
    vol = rng.randn(C, 17, 17, 9).astype(np.float32)
    vol[0] = vol[0] * 3.0 - 1.0                  # densities 0 .. ~10
    R, S = 40, head.num_samples
    origin = (rng.randn(R, 3) * 2.0).astype(np.float32)
    direction = rng.randn(R, 3).astype(np.float32) * 1.7
    direction[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [1e-12, 1, 0]]
    # render_rays splits the key for the jitter, then for the background
    key = jax.random.PRNGKey(9)
    rest, sample_rng = jax.random.split(key)
    _, bkgd_rng = jax.random.split(rest)
    draws = {"t_rand": np.asarray(jax.random.uniform(
        sample_rng, (R, S + 1), jnp.float32)),
        "bkgd": np.asarray(jax.random.uniform(bkgd_rng, (R, 3),
                                              jnp.float32))}
    cots = {k: rng.randn(*shape).astype(np.float32) for k, shape in
            (("depth", (R,)), ("rgb", (R, 3)), ("sem", (R, 5)),
             ("weights", (R, S)))}
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, s["params"]),
             "consts": s["consts"]}

    def jrender(v):
        return s["jmodel"].apply(
            jvars, v, jnp.asarray(origin), jnp.asarray(direction),
            method=lambda m, v, o, d: m.head.render_rays(
                v, o, d, rng=key, train=True))
    ref, vjp = jax.vjp(jrender, jnp.asarray(vol))
    (g_ref,) = vjp({k: (jnp.asarray(cots[k]) if k in cots
                        else jnp.zeros_like(v)) for k, v in ref.items()})
    base = T(np.ascontiguousarray(np.moveaxis(vol, 0, -1))) \
        .requires_grad_(True)
    got = head.render_rays(base.permute(3, 0, 1, 2), T(origin),
                           T(direction), train=True,
                           draws={k: T(v.copy()) for k, v in draws.items()})
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert_scaled_close(got[k].detach().numpy(), v, k)
    sum(((got[k] * T(c)).sum() for k, c in cots.items())).backward()
    assert_grad_close(np.moveaxis(base.grad.numpy(), -1, 0), g_ref,
                      "volume")


def test_tiny_nerfacc_step_matches_jax(density_step):
    s = density_step
    cfg, tmodel, jres = s["cfg"], s["tmodel"], s["jres"]
    tbatch = {k: T(v.copy()) for k, v in s["batch"].items()}
    tmodel.train()
    out = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                 tbatch[cfg.model.head.trans_kw], train=True,
                 draws=s["draws"])
    got = {"depth": out["ms_depths"][0], "rgb": out["ms_colors"][0],
           "acc": out["ms_accs"][0], "weights": out["weights"],
           "ts": out["ts"], "deltas": out["deltas"], "sem": out["sem"][0]}
    for k, ref in jres["outs"].items():
        assert_scaled_close(got[k].detach().numpy(), ref, k)
    tot, ldict = tlosses.MultiLoss(cfg.loss_cfgs)(
        ttrain.build_loss_inputs(cfg, out, tbatch))
    assert set(ldict) == set(jres["losses"])
    for k, v in jres["losses"].items():
        np.testing.assert_allclose(float(ldict[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tot.detach()), jres["total"], rtol=1e-5)
    tmodel.zero_grad()
    tot.backward()
    params = dict(tmodel.named_parameters())
    assert set(params) == set(jres["grads"])
    assert not any(".deviation_network." in n for n in params)
    for name, ref in jres["grads"].items():
        assert params[name].grad is not None, name
        assert_grad_close(params[name].grad.numpy(), ref.numpy(), name)


# ------------------------------------------------------------ drivers
@pytest.fixture
def driver_weights(density_step, tmp_path, monkeypatch):
    """The perturbed weights for both drivers: the JAX one restores them
    (``restore_eval_variables``), the port reads them as a ``train.py``
    checkpoint (``--ckpt-path``)."""
    s = density_step
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, s["params"]),
             "consts": jax.tree_util.tree_map(jnp.asarray, s["consts"])}
    monkeypatch.setattr(jeval, "restore_eval_variables",
                        lambda *a, **kw: jvars)
    path = str(tmp_path / "port.pt")
    torch.save({"model": from_jax_variables({"params": s["params"]})}, path)
    return path


def _occupancy_flips(t, j, what):
    """Density grids within 1e-5 of their scale; occupancy (>= THRESH)
    equal but where the density lies within 1e-5 of the threshold."""
    assert_scaled_close(t, j, what)
    occ_t, occ_j = t >= THRESH, j >= THRESH
    may = (np.abs(j - THRESH) < 1e-5) | (np.abs(t - THRESH) < 1e-5)
    assert not ((occ_t != occ_j) & ~may).any(), what
    return int((occ_t != occ_j).sum())


def test_eval_iou_density_grid_matches_jax(driver_weights, tmp_path,
                                           monkeypatch):
    # the synthetic scene's uniform grid (tests/test_drivers.py:342-349)
    flags = ["--py-config", "tiny_nerfacc", "--synthetic", "--num-samples",
             "1", "--resolution", "1.0", "--density", "--thresh",
             str(THRESH)]
    seen = {"j": [], "t": [], "iou": []}
    for cls, tag in ((jeval.GridOccEvaluator, "j"),
                     (teval.GridOccEvaluator, "t")):
        orig = cls.query_grid

        def rec(self, *a, _orig=orig, _tag=tag, **kw):
            out = _orig(self, *a, **kw)
            seen[_tag].append(np.asarray(out["sdf"]))
            return out
        monkeypatch.setattr(cls, "query_grid", rec)
    orig_epoch = jmetrics.IoU._after_epoch

    def epoch(self, logger=None):
        seen["iou"].append(orig_epoch(self, logger))
        return seen["iou"][-1]
    monkeypatch.setattr(jmetrics.IoU, "_after_epoch", epoch)
    monkeypatch.setattr(sys, "argv", ["eval_iou.py", *flags, "--work-dir",
                                      str(tmp_path / "j"), "--no-shard"])
    jeval_iou.main()
    res = eval_iou.main(flags + ["--device", "cpu", "--ckpt-path",
                                 driver_weights])
    (j,), (t,) = seen["j"], seen["t"]
    assert float(j.min()) >= 0.0 and float(t.min()) >= 0.0   # densities
    if _occupancy_flips(t, j, "density grid") == 0:
        assert res["iou"] == seen["iou"][-1]


def test_eval_iou_density_occ3d_matches_jax(driver_weights, tmp_path,
                                            monkeypatch):
    flags = ["--py-config", "tiny_nerfacc", "--synthetic", "--num-samples",
             "1", "--resolution", "1.0", "--occ3d", "--use-mask", "--sem",
             "--density", "--thresh", str(THRESH)]
    seen = {"j": [], "t": [], "jm": []}
    for cls, tag, name in (
            (jeval.GridOccEvaluator, "j", "query_grid_occ3d"),
            (teval.GridOccEvaluator, "t", "query_grid_occ3d_device")):
        orig = getattr(cls, name)

        def rec(self, *a, _orig=orig, _tag=tag, **kw):
            out = _orig(self, *a, **kw)
            seen[_tag].append({k: np.asarray(v) for k, v in out.items()})
            return out
        monkeypatch.setattr(cls, name, rec)
    orig_epoch = jmetrics.MeanIoU._after_epoch

    def epoch(self, logger=None):
        seen["jm"].append(self)
        return orig_epoch(self, logger)
    monkeypatch.setattr(jmetrics.MeanIoU, "_after_epoch", epoch)
    monkeypatch.setattr(sys, "argv", ["eval_iou.py", *flags, "--work-dir",
                                      str(tmp_path / "j"), "--no-shard"])
    jeval_iou.main()
    res = eval_iou.main(flags + ["--device", "cpu", "--ckpt-path",
                                 driver_weights])
    (j,), (t,) = seen["j"], seen["t"]
    n_occ = _occupancy_flips(t["sdf_r"], j["sdf_r"], "sdf_r")
    top = np.sort(t["logits_r"].astype(np.float64), -1)
    gap = top[..., -1] - top[..., -2]
    assert not ((t["sem_r"] != j["sem_r"]) & ~(gap < 1e-5)).any()
    n_sem = int((t["sem_r"] != j["sem_r"]).sum())
    jiou, jmiou = seen["jm"]
    for tm, jm in ((res["iou_metric"], jiou), (res["miou_metric"], jmiou)):
        for k in ("total_seen", "total_correct", "total_positive"):
            assert np.abs(getattr(tm, k) - getattr(jm, k)).max() <= \
                n_occ + n_sem, k


def test_eval_depth_on_tiny_nerfacc_matches_jax(driver_weights, tmp_path,
                                                monkeypatch):
    seen = []
    orig_render = jeval.ChunkedRenderer.render

    def render(self, *a, **kw):
        out = orig_render(self, *a, **kw)
        seen.append(np.asarray(out["depth"]))
        return out
    monkeypatch.setattr(jeval.ChunkedRenderer, "render", render)
    argv = ["eval_depth.py", "--py-config", "tiny_nerfacc", "--synthetic",
            "--num-samples", "1", "--batch", str(CHUNK), "--no-shard",
            "--work-dir", str(tmp_path / "j")]
    monkeypatch.setattr(sys, "argv", argv)
    jeval_depth.main()
    res = eval_depth.main(["--py-config", "tiny_nerfacc", "--synthetic",
                           "--num-samples", "1", "--batch", str(CHUNK),
                           "--device", "cpu", "--ckpt-path", driver_weights])
    np.testing.assert_allclose(res["last_depth"].numpy().reshape(-1),
                               seen[-1], rtol=1e-4, atol=1e-5)
    # --depth-metric-tgt max: both drivers exit with the same message
    monkeypatch.setattr(sys, "argv", argv + ["--depth-metric-tgt", "max"])
    with pytest.raises(SystemExit) as jexit:
        jeval_depth.main()
    with pytest.raises(SystemExit) as texit:
        eval_depth.main(["--py-config", "tiny_nerfacc", "--synthetic",
                         "--depth-metric-tgt", "max", "--device", "cpu"])
    assert str(texit.value) == str(jexit.value)
    assert "nerfacc head has no argmax-weight depth" in str(texit.value)


def test_train_step_on_the_density_head(tmp_path):
    train.main(["--py-config", "tiny_nerfacc", "--synthetic", "--max-steps",
                "1", "--device", "cpu", "--work-dir", str(tmp_path)])
    state = torch.load(tmp_path / "ckpts" / "latest.pt", map_location="cpu")
    assert state["step"] == 1
    assert any(k.startswith("head.radiance_field.") for k in state["model"])
    assert all(torch.isfinite(v).all() for v in state["model"].values())


def test_density_recipes_are_ported():
    for name in ("nuscenes_occ_density", "tiny_nerfacc"):
        check_ported(get_config(name).model)
