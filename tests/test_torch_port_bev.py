"""The BEV path of the port against the JAX package on the CPU, at
``tiny_bev``: the single-plane deformable self-attention, the BEV encoder
(its geometry tables, the ``ref_2d`` transpose quirk, the plane it
returns), the ``tpv=False`` decode, a ``tiny_bev`` training forward and
loss-and-grad through the bridge, and the ``eval_depth`` and ``eval_iou``
drivers on ``tiny_bev`` against the JAX drivers.

Weights: the JAX init with numpy noise on every leaf (``perturb``), handed
to the port through ``bridge.from_jax_variables``; dropout 0; the head's
draws replayed from JAX's key splits (``jax_draws``). Tolerances as in
``tests/test_torch_port_train.py``: forward outputs within 1e-5 of their
scale, losses rtol 1e-5, gradients ``1e-4 * max|ref| + 1e-7`` per tensor.
"""
import dataclasses
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
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.encoder import \
    DeformableSelfAttention as JSelfAttention
from selfocc_tpu.models.field import TPVSDFField as JField
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import metrics as jmetrics
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import bridge, eval_depth, eval_iou
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.encoder import (DeformableSelfAttention,
                                              bev_ref_2d)
from selfocc_tpu_torch.models.field import TPVSDFField
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.ops.interp import row_stride
from selfocc_tpu_torch.utils import eval_lib as teval
from selfocc_tpu_torch.utils import train_lib as ttrain
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import (jit_vjp, memoised_jax_init,  # noqa: F401
                            quick_jit)
from test_torch_port_train import (assert_grad_close, jax_draws, no_dropout,
                                   perturb)

share_cores_with_xdist_workers()

T = torch.from_numpy
CHUNK = 96           # rays per render chunk in the driver runs


def assert_scaled_close(got, ref, what, rtol=1e-5):
    """Within ``rtol`` of the reference's largest magnitude."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rtol * max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e}"


def _batch(cfg):
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    return {k: np.asarray(v) for k, v in ds[0].items()
            if not isinstance(v, (str, dict))}


# ------------------------------------------------------------------ modules
def _self_attn_sd(p):
    def lin(q):
        return {"weight": T(np.ascontiguousarray(np.asarray(q["kernel"]).T)),
                "bias": T(np.array(q["bias"]))}
    sd = {}
    for name, q in (("sampling_offsets", p["heads"]["sampling_offsets"]),
                    ("attention_weights", p["heads"]["attention_weights"]),
                    ("value_proj", p["value_proj"]),
                    ("output_proj", p["output_proj"])):
        for k, v in lin(q).items():
            sd[f"{name}.{k}"] = v
    return sd


@pytest.mark.parametrize("hw", [(5, 7), (6, 6)], ids=["5x7", "6x6"])
def test_deformable_self_attention_matches_jax(hw):
    # a 5 x 7 plane puts the (h_norm, w_norm) reference points read as
    # (x, y) at other cells than a 'fixed' order would
    h, w = hw
    C, H, P, Q = 16, 4, 3, h * w
    rng = np.random.RandomState(1)
    query = rng.randn(1, Q, C).astype(np.float32)
    pos = rng.randn(1, Q, C).astype(np.float32)
    ref_2d = bev_ref_2d(h, w).numpy()
    cot = rng.randn(1, Q, C).astype(np.float32)
    jmod = JSelfAttention(C, H, P, dropout=0.0)
    params = perturb(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda q, p, r: jmod.init(jax.random.PRNGKey(0), q, p, r, (h, w)))(
        jnp.asarray(query), jnp.asarray(pos), jnp.asarray(ref_2d))[
            "params"]), rng, scale=0.5)

    def f(q, p):
        return jmod.apply({"params": params}, q, p, jnp.asarray(ref_2d),
                          (h, w))
    ref, (g_q, g_p) = jit_vjp(f, (jnp.asarray(query), jnp.asarray(pos)),
                              jnp.asarray(cot))
    tmod = DeformableSelfAttention(C, H, P)
    tmod.load_state_dict(_self_attn_sd(params), strict=True)
    tq, tp = (T(x.copy()).requires_grad_(True) for x in (query, pos))
    got = tmod(tq, tp, T(ref_2d), (h, w))
    assert_scaled_close(got.detach().numpy(), ref, "self-attention")
    (got * T(cot)).sum().backward()
    assert_grad_close(tq.grad.numpy(), g_q, "query")
    assert_grad_close(tp.grad.numpy(), g_p, "query_pos")


def test_bev_decode_matches_jax():
    # tpv=False: each cell's MLP emits (D, C_out) channels; the volume is a
    # permuted view of channel-last output (no transpose for the kernels)
    cfg = get_config("tiny_bev")
    h = cfg.model.head
    kw = dict(mapping_args=h.mapping_args, embed_dims=h.embed_dims,
              color_dims=h.color_dims, sem_dims=h.sem_dims,
              density_layers=h.density_layers, sh_deg=h.sh_deg)
    jf = JField(tpv=False, **kw)
    rng = np.random.RandomState(2)
    H, W, D = 17, 17, 9
    bev = rng.randn(1, H * W, h.embed_dims).astype(np.float32)
    variables = jf.init(jax.random.PRNGKey(0), jnp.asarray(bev),
                        method="decode")
    params = perturb(jax.tree_util.tree_map(np.asarray,
                                            variables["params"]), rng)
    ref = np.asarray(jf.apply({"params": params}, jnp.asarray(bev),
                              method="decode"))
    tf = TPVSDFField(tpv=False, variance=False, **kw)
    sd = {}
    bridge._field(sd, params, "f")
    tf.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    vol = tf.decode(T(bev))
    assert vol.shape == ref.shape == (1, 1 + 3 + h.sem_dims, H, W, D)
    assert_scaled_close(vol.detach().numpy(), ref, "decode")
    assert row_stride(vol[0]) == vol.shape[1]
    assert vol.permute(0, 2, 3, 4, 1).is_contiguous()


# ------------------------------------------------------- tiny_bev step
@pytest.fixture(scope="module")
def bev_step():
    """One JAX ``tiny_bev`` forward and loss-and-grad (dropout 0, one jit),
    the bridged port model, the batch, the draws and the consts."""
    cfg = no_dropout(jget_config("tiny_bev"))
    tcfg = no_dropout(get_config("tiny_bev"))
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
                "sem": out["sem"][0], "eik_grad": out["eik_grad"],
                "second_grad": out["second_grad"]}
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


def test_bev_geometry_tables_equal_jax(bev_step):
    # the positional features, the pillars and the (h, w)-ordered self
    # reference points (the quirk kept for checkpoint parity)
    enc = bev_step["tmodel"].encoder
    consts = bev_step["consts"]["encoder"]
    np.testing.assert_array_equal(enc.ref_2d.numpy(), consts["ref_2d"])
    np.testing.assert_allclose(enc.ref_3d.numpy(), consts["ref_3d"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(enc.positional_encoding.fourier.numpy(),
                               consts["fourier_feat"], rtol=0, atol=1e-6)
    H = W = 17
    gh, gw = enc.ref_2d[:, 0].reshape(H, W), enc.ref_2d[:, 1].reshape(H, W)
    assert torch.equal(gh[:, 0], torch.arange(H) / (H - 1.0))
    assert torch.equal(gw[0], torch.arange(W) / (W - 1.0))


def test_bev_encoder_matches_jax(bev_step):
    # lifter -> backbone -> BEV encoder: the plane the field decodes
    s = bev_step
    b = s["batch"]
    ref = s["jmodel"].apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, s["params"]),
         "consts": s["consts"]}, jnp.asarray(b["imgs"]),
        jnp.asarray(b["lidar2img"]), method="get_representation")
    s["tmodel"].eval()
    with torch.no_grad():
        got = s["tmodel"].get_representation(T(b["imgs"]), T(b["lidar2img"]))
    assert got.shape == ref.shape == (1, 17 * 17, 32)
    assert_scaled_close(got.numpy(), ref, "BEV plane")


def test_tiny_bev_step_matches_jax(bev_step):
    s = bev_step
    cfg, tmodel, jres = s["cfg"], s["tmodel"], s["jres"]
    tbatch = {k: T(v.copy()) for k, v in s["batch"].items()}
    tmodel.train()
    out = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                 tbatch[cfg.model.head.trans_kw], train=True,
                 draws=s["draws"])
    got = {"depth": out["ms_depths"][0], "rgb": out["ms_colors"][0],
           "acc": out["ms_accs"][0], "weights": out["weights"],
           "sem": out["sem"][0], "eik_grad": out["eik_grad"],
           "second_grad": out["second_grad"]}
    for k, ref in jres["outs"].items():
        # second_grad divides sdf differences 0.01 m apart by 1e-4
        assert_scaled_close(got[k].detach().numpy(), ref, k,
                            rtol=1e-4 if k == "second_grad" else 1e-5)
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
    for name, ref in jres["grads"].items():
        assert params[name].grad is not None, name
        assert_grad_close(params[name].grad.numpy(), ref.numpy(), name)


# ------------------------------------------------------------ drivers
@pytest.fixture
def driver_weights(bev_step, tmp_path, monkeypatch):
    """The perturbed weights for both drivers: the JAX one restores them
    (``restore_eval_variables``), the port reads them as a ``train.py``
    checkpoint (``--ckpt-path``)."""
    s = bev_step
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, s["params"]),
             "consts": jax.tree_util.tree_map(jnp.asarray, s["consts"])}
    monkeypatch.setattr(jeval, "restore_eval_variables",
                        lambda *a, **kw: jvars)
    path = str(tmp_path / "port.pt")
    torch.save({"model": from_jax_variables({"params": s["params"]})}, path)
    return path


def test_eval_depth_on_tiny_bev_matches_jax(driver_weights, tmp_path,
                                            monkeypatch):
    seen = {"table": [], "depth": []}
    orig_epoch = jmetrics.DepthMetric._after_epoch
    orig_render = jeval.ChunkedRenderer.render

    def epoch(self, logger=None):
        seen["table"].append(orig_epoch(self, logger))
        return seen["table"][-1]

    def render(self, *a, **kw):
        out = orig_render(self, *a, **kw)
        seen["depth"].append(np.asarray(out["depth"]))
        return out
    monkeypatch.setattr(jmetrics.DepthMetric, "_after_epoch", epoch)
    monkeypatch.setattr(jeval.ChunkedRenderer, "render", render)
    monkeypatch.setattr(sys, "argv", [
        "eval_depth.py", "--py-config", "tiny_bev", "--synthetic",
        "--num-samples", "1", "--batch", str(CHUNK), "--no-shard",
        "--work-dir", str(tmp_path / "j")])
    jeval_depth.main()
    res = eval_depth.main(["--py-config", "tiny_bev", "--synthetic",
                           "--num-samples", "1", "--batch", str(CHUNK),
                           "--device", "cpu", "--ckpt-path", driver_weights])
    # the prepare's rounding carries through the render (test_torch_port_
    # occ.py::test_torch_ckpt_gives_the_jax_depth)
    np.testing.assert_allclose(res["last_depth"].numpy().reshape(-1),
                               seen["depth"][-1], rtol=1e-4, atol=1e-5)
    (ref,) = seen["table"]
    got = res["metric"]
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        if k.endswith(("a1", "a2", "a3")):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_eval_iou_on_tiny_bev_matches_jax(driver_weights, tmp_path,
                                          monkeypatch):
    # the Occ3D path with semantics: the resampled sdf and classes, and the
    # IoU tables up to voxels a 1-ulp grid shift may flip
    flags = ["--py-config", "tiny_bev", "--synthetic", "--num-samples", "1",
             "--resolution", "1.0", "--occ3d", "--use-mask", "--sem"]
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
    assert_scaled_close(t["sdf_r"], j["sdf_r"], "sdf_r")
    flip = 1e-5
    occ_j, occ_t = j["sdf_r"] <= 0.0, t["sdf_r"] <= 0.0
    may = (np.abs(j["sdf_r"]) < flip) | (np.abs(t["sdf_r"]) < flip)
    assert not ((occ_j != occ_t) & ~may).any()
    n_occ = int((occ_j != occ_t).sum())
    top = np.sort(t["logits_r"].astype(np.float64), -1)
    gap = top[..., -1] - top[..., -2]
    assert not ((t["sem_r"] != j["sem_r"]) & ~(gap < flip)).any()
    n_sem = int((t["sem_r"] != j["sem_r"]).sum())
    jiou, jmiou = seen["jm"]
    for tm, jm in ((res["iou_metric"], jiou), (res["miou_metric"], jmiou)):
        for k in ("total_seen", "total_correct", "total_positive"):
            assert np.abs(getattr(tm, k) - getattr(jm, k)).max() <= \
                n_occ + n_sem, k


def test_bev_recipes_are_ported():
    from selfocc_tpu_torch.models.segmentor import check_ported
    for name in ("nuscenes_occ_bev", "tiny_bev"):
        check_ported(get_config(name).model)
    # the BEV encoder refuses camera_aware, as the JAX segmentor does
    cfg = get_config("tiny_bev")
    enc = dataclasses.replace(cfg.model.encoder, camera_aware=True)
    with pytest.raises(ValueError, match="camera_aware"):
        TPVSegmentor(dataclasses.replace(cfg.model, encoder=enc))
