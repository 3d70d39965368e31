"""The SemanticKITTI recipe of the port against the JAX package on the CPU:
the values-only trilinear query's volume gradient, ``SoftSparsityLoss``, a
KITTI-shaped training step, ``build_dataset`` on a fabricated odometry
tree, and the ``eval_iou_kitti``, ``eval_depth`` and
``eval_novel_depth_kitti`` drivers.

The KITTI-shaped model is ``tiny`` with ``kitti_occ``'s options, built here
from each package's ``tiny`` with ``dataclasses.replace`` (neither config
module is edited): the ``h_half`` mapping over a front-only box, one
camera, the compact second derivative, ``return_uniform_sdf`` with the five
KITTI losses, ``color_dims = 3``, no semantic head, ``_KITTI_IMG_NORM``, the
recipe's dataset arguments pointed at the fixture, and dropout 0. The head's
draws (ray grid, jitter, background, the uniform grid's shift) are made in
JAX by replaying its key splits and handed to the port.

Tolerances: the query's gradient within 1e-5 of its largest value; the
loss rtol 1e-6; the step's losses rtol 1e-5 and every gradient within 1e-4
of its largest value + 1e-7, with the step's gradient held as that of its
four other losses and the compact second derivative's cotangent held at
the field. The compact stencil divides differences of sdf taps 0.01 apart
by 1e-4, and at samples whose taps share a cell (a true second derivative
of 0) the rounding of the decoded volume sets the sign of ``|.|``'s
gradient: the two packages' volumes differ by up to 1.2e-6 (their
encoders' fp32 sums), which moves the whole step's encoder gradients by up
to 1.5x that tolerance (the port against itself with its volume moved by
two ulps: 0.45x; without SecondGradLoss: 0.09x; on a CPU). Dataset
items equal; the occupancy eval's
voxels equal but where |sdf| < 1e-5 (the grid axes are within 1 ulp of
JAX's fp32 ``linspace``); novel-view depths within rtol 1e-4, atol 1e-5 and
their tables as in ``test_torch_port_novel.py``. The fixture's poses step
1.0123 m, not whole metres, so that no render sample lies on a voxel knot
(see ``test_torch_port_novel.py``).
"""
import dataclasses
import os
import random
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs import experiments as jexp
from selfocc_tpu.data import build_dataset as jbuild
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.losses.regularizers import \
    SoftSparsityLoss as JSoftSparsityLoss
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.ops.interp import trilinear_sample_cf as jtrilinear
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import eval_iou_kitti, eval_novel_depth
from selfocc_tpu_torch import eval_novel_depth_kitti
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs import experiments as texp
from selfocc_tpu_torch.data import build_dataset as tbuild
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.ops import interp as tinterp
from selfocc_tpu_torch.utils import train_lib as ttrain

from test_kitti_dataset import _make_mini_kitti
from test_torch_port_novel import CHUNK, assert_tables_close, jax_weights
from test_torch_port_train import assert_grad_close, jax_draws, perturb
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy
KITTI_PC = (-10.0, 0.0, -1.0, 10.0, 10.0, 3.0)   # tiny's box, front only
SDF_TIE = 1e-5


def kitti_tiny(exp, root=None, recipe="kitti_occ"):
    """``tiny`` widths with ``kitti_occ``'s options, from the package whose
    ``configs.experiments`` is ``exp``; with ``root``, the dataset
    arguments of ``recipe`` pointed at that SemanticKITTI tree (sequence 00
    for both splits)."""
    cfg, k, r = exp.tiny(), exp.kitti_occ(), getattr(exp, recipe)()
    mapping = dict(cfg.model.head.mapping_args, h_half=True)
    loss_cfgs = []
    for c in k.loss_cfgs:
        c = dict(c)
        if "img_size" in c:
            c.update(img_size=list(cfg.img_size),
                     ray_resize=list(cfg.num_rays))
        loss_cfgs.append(c)
    enc = dataclasses.replace(cfg.model.encoder, mapping_args=mapping,
                              pc_range=KITTI_PC, num_cams=1, dropout=0.0)
    head = dataclasses.replace(
        cfg.model.head, roi_aabb=KITTI_PC, mapping_args=mapping,
        use_compact_2nd_grad=True, return_uniform_sdf=True, return_sem=False,
        color_dims=3, sem_dims=0)
    extra = {} if root is None else dict(
        data_path=root, sequences=["00"],
        imageset=os.path.join(root, "dataset"))
    return dataclasses.replace(
        cfg, name="kitti_tiny",
        model=dataclasses.replace(cfg.model, encoder=enc, head=head),
        loss_cfgs=loss_cfgs,
        loss_input_convertion=dict(k.loss_input_convertion), num_cams=1,
        sem=False, dataset_type=k.dataset_type,
        wrapper_args=dict(k.wrapper_args),
        train_dataset_args=dict(r.train_dataset_args, **extra),
        val_dataset_args=dict(r.val_dataset_args, **extra))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return _make_mini_kitti(tmp_path_factory.mktemp("kitti"), step=1.0123,
                            with_voxels=True, img_hw=(64, 96))


# ------------------------------------------------------- the values query

def _query_case(C, seed):
    rng = np.random.RandomState(seed)
    vol = rng.randn(C, 7, 9, 5).astype(np.float32)
    pts = np.stack([rng.uniform(-1.2, 7.2, 300), rng.uniform(-1.2, 9.2, 300),
                    rng.uniform(-1.2, 5.2, 300)], -1).astype(np.float32)
    pts[:40] = np.floor(pts[:40]) + rng.uniform(0.3, 0.7, (40, 3))
    return vol, pts


@pytest.mark.parametrize("case", ["C1", "C4", "channel0-row-stride4"])
def test_values_query_gradient_matches_jax(case):
    C = 1 if case == "C1" else 4
    vol, pts = _query_case(C, {"C1": 1, "C4": 2}.get(case, 3))
    strided = case.startswith("channel0")
    out_c = 1 if strided else C
    cot = np.random.RandomState(9).randn(300, out_c).astype(np.float32)

    def jloss(v):
        v = v[:1] if strided else v
        return jnp.sum(jtrilinear(v, jnp.asarray(pts)) * jnp.asarray(cot))
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(vol)))
    # the decode's layout: channel-last memory seen as (C, H, W, D)
    leaf = T(np.ascontiguousarray(np.moveaxis(vol, 0, -1))).requires_grad_()
    tvol = leaf.permute(3, 0, 1, 2)
    q = tinterp.channel0_view(tvol) if strided else tvol
    vals = tinterp.trilinear_sample_cf(q, T(pts))
    (vals * T(cot)).sum().backward()
    got = leaf.grad.permute(3, 0, 1, 2).numpy()
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    # the plain backward the card's kernel is held against
    plain = tinterp.trilinear_cf_bwd_plain(q.detach(), T(pts), T(cot))
    np.testing.assert_allclose(plain.numpy(), ref[:out_c], rtol=0, atol=tol)
    if strided:
        # the other channels get exact zeros, and the volume's gradient
        # stays channel-last
        assert not got[1:].any()
        assert leaf.grad.is_contiguous()


def test_values_query_refuses_point_gradients():
    # the kernels' Function takes CUDA volumes only; on the CPU the values
    # query gives the points the plain version's cotangent (the importance
    # rounds' sdf queries need it)
    vol, pts = _query_case(1, 4)
    with pytest.raises(ValueError):
        tinterp._TrilinearValues.apply(T(vol), T(pts).requires_grad_())
    p = T(pts).requires_grad_()
    g = torch.randn(len(pts), vol.shape[0],
                    generator=torch.Generator().manual_seed(0))
    (tinterp.trilinear_sample_cf(T(vol), p) * g).sum().backward()
    _, ref = tinterp.trilinear_cf_bwd_plain(T(vol), T(pts), g, points=True)
    assert torch.equal(p.grad, ref)


# ----------------------------------------------------------- the sparsity

def test_soft_sparsity_loss_matches_jax():
    sdf = np.random.RandomState(10).randn(10, 20, 4).astype(np.float32)
    jl = JSoftSparsityLoss(weight=0.005, input_dict={"density": "u"})
    tl = tlosses.build_loss(dict(type="SoftSparsityLoss", weight=0.005,
                                 input_dict={"density": "u"}))
    ref, jg = jax.value_and_grad(lambda s: jl({"u": s}))(jnp.asarray(sdf))
    x = T(sdf.copy()).requires_grad_()
    got = tl({"u": x})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-12)


# ------------------------------------------------------- the training step

@pytest.fixture(scope="module")
def kitti_step():
    """One JAX KITTI-shaped loss-and-grad and the port's model, batch and
    draws (the uniform grid's shift included)."""
    jcfg, tcfg = kitti_tiny(jexp), kitti_tiny(texp)
    ds = SyntheticDataset(num_cams=1, input_size=jcfg.input_size,
                          img_size=jcfg.img_size, num_classes=5, length=1)
    batch = {k: np.asarray(v) for k, v in ds[0].items()
             if not isinstance(v, (str, dict))}
    jmodel = JSegmentor(cfg=jcfg.model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jeval.init_variables(jmodel, jcfg, jbatch)
    params = perturb(jax.tree_util.tree_map(np.asarray, variables["params"]),
                     np.random.RandomState(0))
    # centre the random sdf (median about 1.27) on 0: surfaces inside the
    # box, and uniform points of negative sdf for SoftSparsityLoss
    params["head"]["field"]["density_out"]["bias"][0] -= 1.25
    rng = jax.random.PRNGKey(3)
    compute = jtrain.make_loss_fn(jmodel, jcfg)

    def without_second_grad(*args):
        tot, (ldict, aux) = compute(*args)
        return tot - ldict["SecondGradLoss"], (ldict, aux)
    (tot, (ldict, _)), grads = jax.jit(jax.value_and_grad(
        without_second_grad, has_aux=True), static_argnums=5)(
        jax.tree_util.tree_map(jnp.asarray, params), {},
        variables["consts"], jbatch, rng, 0)
    draws = jax_draws(rng, jcfg)
    # the head's uniform_sdf shift: uniform(split(rng)[1], xyz.shape) with
    # the head's rng after its ray split (heads.py:434, :503-506)
    rng_h, _ = jax.random.split(jax.random.split(rng)[1])
    h = jcfg.model.head
    shape = tuple(int((h.roi_aabb[i + 3] - h.roi_aabb[i]) / h.resolution)
                  for i in (1, 0, 2)) + (3,)
    draws["uniform_shift"] = np.array(jax.random.uniform(
        jax.random.split(rng_h)[1], shape))
    tmodel = TPVSegmentor(tcfg.model)
    tmodel.load_state_dict(from_jax_variables({"params": params}),
                           strict=True)
    jres = {"losses": {k: float(v) for k, v in ldict.items()},
            "grads": from_jax_variables(
                {"params": jax.tree_util.tree_map(np.asarray, grads)})}
    return tcfg, tmodel, batch, draws, jres, jmodel, variables


def test_kitti_train_step_matches_jax(kitti_step):
    # the losses, and the gradient of the step less its SecondGradLoss (see
    # test_kitti_compact_second_grad_matches_jax for that one)
    cfg, tmodel, batch, draws, jres, _, _ = kitti_step
    assert sorted(jres["losses"]) == sorted(
        ["ReprojLossMonoMultiNew", "RGBLossMS", "EikonalLoss",
         "SecondGradLoss", "SoftSparsityLoss"])
    tbatch = {k: T(v.copy()) for k, v in batch.items()}
    tmodel.train()
    out = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                 tbatch[cfg.model.head.trans_kw], train=True, draws=draws)
    assert out["uniform_sdf"].shape == (10, 20, 4)
    tot, ldict = tlosses.MultiLoss(cfg.loss_cfgs)(
        ttrain.build_loss_inputs(cfg, out, tbatch))
    assert set(ldict) == set(jres["losses"])
    for k, v in jres["losses"].items():
        np.testing.assert_allclose(float(ldict[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
    tmodel.zero_grad()
    (tot - ldict["SecondGradLoss"]).backward()
    params = dict(tmodel.named_parameters())
    assert set(params) == set(jres["grads"])
    for name, ref in jres["grads"].items():
        assert params[name].grad is not None, name
        assert_grad_close(params[name].grad.numpy(), ref.numpy(), name)


def test_kitti_compact_second_grad_matches_jax(kitti_step):
    # the compact second derivative of the h_half field and its cotangent
    # against the JAX field's on one volume (tolerances of
    # test_torch_port_train.py::test_second_grad_matches_jax)
    _, tmodel, _, _, _, jmodel, variables = kitti_step
    rng = np.random.RandomState(8)
    vol = rng.randn(4, 9, 17, 9).astype(np.float32)
    xyz = np.stack([rng.uniform(-11.0, 11.0, 400), rng.uniform(-1.0, 11.0, 400),
                    rng.uniform(-1.5, 3.5, 400)], -1).astype(np.float32)
    cot = rng.randn(400, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jmodel.apply(
        variables, v, jnp.asarray(xyz), method=lambda m, v, x:
        m.head.field.second_grad(v, x, 0.01)), jnp.asarray(vol))
    (g_ref,) = vjp(jnp.asarray(cot))
    leaf = T(np.ascontiguousarray(np.moveaxis(vol, 0, -1))).requires_grad_()
    got = tmodel.head.field.second_grad(leaf.permute(3, 0, 1, 2), T(xyz),
                                        0.01)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4 * scale + 1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(leaf.grad.permute(3, 0, 1, 2).numpy(), g_ref,
                      "second_grad")


def test_kitti_model_has_no_colour_projection_or_semantics():
    # color_dims == 3 SH coefficients: no color_proj; sem_dims 0: a
    # 4-channel volume, no semantic output
    model = TPVSegmentor(texp.kitti_occ().model)
    field = model.head.field
    assert field.color_proj is None and field.sem_dims == 0
    assert field.density_net[-1].out_features == 4
    assert field.grid_shape == (257, 257, 33)


def test_kitti_recipes_build_and_refuse_only_the_sample_sdf():
    # the sample sdf is ported now; the reference's NonLinearMapping is
    # ported too, but it has one symmetric h / w axis, so on KITTI's half
    # axes both packages refuse it
    from selfocc_tpu.geometry.mappings import make_mapping as jmake_mapping
    for name in ("kitti_occ", "kitti_novel_depth"):
        TPVSegmentor(texp.get_config(name).model)
    cfg = texp.kitti_occ()
    head = dataclasses.replace(cfg.model.head, return_sample_sdf=True)
    TPVSegmentor(dataclasses.replace(cfg.model, head=head))
    mapping = dict(cfg.model.head.mapping_args,
                   nonlinear_mode="linear_upscale")
    head = dataclasses.replace(cfg.model.head, mapping_args=mapping)
    with pytest.raises(ValueError, match="linear_upscale"):
        TPVSegmentor(dataclasses.replace(cfg.model, head=head))
    with pytest.raises(AssertionError):
        jmake_mapping(**mapping)


# -------------------------------------------------------------- the data

def _items_equal(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _items_equal(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _items_equal(g, r)
    elif isinstance(ref, str):
        assert got == ref
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("phase", ["train", "val", "novel_eval"])
def test_build_dataset_items_match_jax(kitti_root, phase):
    recipe = "kitti_novel_depth" if phase == "novel_eval" else "kitti_occ"
    jds = jbuild(kitti_tiny(jexp, kitti_root, recipe), phase)
    tds = tbuild(kitti_tiny(texp, kitti_root, recipe), phase)
    assert len(tds) == len(jds) == {"train": 8, "val": 2,
                                    "novel_eval": 2}[phase]
    for i in range(len(jds)):
        items = []
        for ds in (jds, tds):
            random.seed(i)
            np.random.seed(i)
            items.append(ds[i])
        _items_equal(items[1], items[0])


def test_missing_tree_names_it(tmp_path):
    cfg = kitti_tiny(texp, str(tmp_path / "nowhere"))
    for phase in ("train", "val", "novel_eval"):
        with pytest.raises(FileNotFoundError,
                           match=str(tmp_path / "nowhere" / "dataset")):
            tbuild(cfg, phase)


# ------------------------------------------------------------ the drivers

@pytest.fixture(scope="module")
def kitti_weights(kitti_root, tmp_path_factory):
    """The JAX init with noise, as each driver's --torch-ckpt."""
    jcfg = kitti_tiny(jexp, kitti_root)
    sample = {k: np.asarray(v) for k, v in jbuild(jcfg, "val")[0].items()
              if not isinstance(v, (str, dict))}
    _, _, tpth, jpth = jax_weights(jcfg, sample,
                                   tmp_path_factory.mktemp("w"), "kitti")
    return tpth, jpth


def test_eval_iou_kitti_matches_jax(kitti_root, kitti_weights, tmp_path,
                                    monkeypatch):
    import eval_iou_kitti as jdriver
    import train as jtrain_driver
    from selfocc_tpu.utils import scenerf_metric as jscenerf
    tpth, jpth = kitti_weights
    jcfg = kitti_tiny(jexp, kitti_root)
    seen = {"sdf": [], "stats": [], "iou": []}
    orig_fwd = jeval.GridOccEvaluator.forward_occ
    orig_stats = jscenerf.SSCMetrics.get_stats

    def forward_occ(self, *a, **kw):
        out = orig_fwd(self, *a, **kw)
        seen["sdf"].append(np.asarray(out["sdf"]))
        return out

    def get_stats(self):
        seen["stats"].append(orig_stats(self))
        return seen["stats"][-1]
    monkeypatch.setattr(jeval.GridOccEvaluator, "forward_occ", forward_occ)
    monkeypatch.setattr(jscenerf.SSCMetrics, "get_stats", get_stats)
    monkeypatch.setattr(jeval, "load_model_for_eval",
                        lambda name, ckpt="": (jcfg,
                                               JSegmentor(cfg=jcfg.model)))
    # the JAX driver reads token and sequence from ``as_arrays(item)``,
    # which drops strings, and would score no frame: keep them
    monkeypatch.setattr(jtrain_driver, "as_arrays", lambda item: {
        k: (v if isinstance(v, str) else jnp.asarray(v))
        for k, v in item.items() if not isinstance(v, dict)})
    monkeypatch.setattr(sys, "argv", [
        "eval_iou_kitti.py", "--py-config", "kitti_tiny", "--num-samples",
        "2", "--torch-ckpt", jpth, "--kitti-root", kitti_root,
        "--work-dir", str(tmp_path / "j")])
    jdriver.main()
    monkeypatch.setattr(eval_iou_kitti, "get_config",
                        lambda name: kitti_tiny(texp, kitti_root))
    res = eval_iou_kitti.main(["--num-samples", "2", "--device", "cpu",
                               "--torch-ckpt", tpth, "--kitti-root",
                               kitti_root])
    sdf_j = seen["sdf"][-1]
    assert res["sdf"].shape == sdf_j.shape == (256, 256, 32)
    occ_j = eval_iou_kitti.crop_prediction((sdf_j <= 0).astype(np.int32))
    differ = res["pred_occ"] != occ_j
    assert (np.abs(sdf_j[differ]) < SDF_TIE).all()
    assert (np.abs(res["sdf"][differ]) < SDF_TIE).all()
    np.testing.assert_allclose(res["sdf"], sdf_j, rtol=1e-4, atol=1e-5)
    (ref,) = seen["stats"]
    assert res["stats"]["iou"] > 0
    if not differ.any():
        for k in ("precision", "recall", "iou", "iou_ssc_mean"):
            assert res["stats"][k] == ref[k], k
        np.testing.assert_array_equal(res["stats"]["iou_ssc"],
                                      ref["iou_ssc"])


def test_eval_depth_kitti_matches_jax(kitti_root, kitti_weights, tmp_path,
                                     monkeypatch):
    # eval_depth on a SemanticKITTI val frame: its lidar depth (the val
    # split's return_depth), the same bridged weights, the JAX driver handed
    # an as_arrays that keeps the item's strings
    import eval_depth as jdriver
    import train as jtrain_driver
    from selfocc_tpu.utils import metrics as jmetrics
    from selfocc_tpu_torch import eval_depth
    tpth, jpth = kitti_weights
    jcfg = kitti_tiny(jexp, kitti_root)
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
    monkeypatch.setattr(jeval, "load_model_for_eval",
                        lambda name, ckpt="": (jcfg,
                                               JSegmentor(cfg=jcfg.model)))
    monkeypatch.setattr(jtrain_driver, "as_arrays", lambda item: {
        k: (v if isinstance(v, str) else jnp.asarray(v))
        for k, v in item.items() if not isinstance(v, dict)})
    monkeypatch.setattr(sys, "argv", [
        "eval_depth.py", "--py-config", "kitti_tiny", "--num-samples", "2",
        "--batch", str(CHUNK), "--no-shard", "--torch-ckpt", jpth,
        "--work-dir", str(tmp_path / "j")])
    jdriver.main()
    monkeypatch.setattr(eval_depth, "get_config",
                        lambda name: kitti_tiny(texp, kitti_root))
    res = eval_depth.main(["--py-config", "kitti_tiny", "--num-samples", "2",
                           "--batch", str(CHUNK), "--device", "cpu",
                           "--torch-ckpt", tpth])
    np.testing.assert_allclose(res["last_depth"].numpy().reshape(-1),
                               seen["depth"][-1], rtol=1e-4, atol=1e-5)
    (ref,) = seen["table"]
    got = res["metric"]
    assert set(got) == set(ref) and ref
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        if k.endswith(("a1", "a2", "a3")):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert res["rays"] == 2 * 8 * 12


def test_eval_novel_depth_kitti_matches_jax(kitti_root, kitti_weights,
                                            tmp_path, monkeypatch):
    import eval_novel_depth_kitti as jdriver
    tpth, jpth = kitti_weights
    jcfg = kitti_tiny(jexp, kitti_root, "kitti_novel_depth")
    seen = []
    orig_run = jeval.run_novel_depth_eval

    def run(*a, **kw):
        seen.append(orig_run(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(jeval, "run_novel_depth_eval", run)
    monkeypatch.setattr(jeval, "load_model_for_eval",
                        lambda name, ckpt="": (jcfg,
                                               JSegmentor(cfg=jcfg.model)))
    monkeypatch.setattr(sys, "argv", [
        "eval_novel_depth_kitti.py", "--num-samples", "2", "--batch",
        str(CHUNK), "--torch-ckpt", jpth, "--work-dir", str(tmp_path / "j")])
    jdriver.main()
    (buckets,) = seen
    ref = {b: [float(np.mean(buckets[b][k])) for k in
               ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")]
           for b in buckets}
    monkeypatch.setattr(eval_novel_depth, "get_config",
                        lambda name: kitti_tiny(texp, kitti_root,
                                                "kitti_novel_depth"))
    res = eval_novel_depth_kitti.main(
        ["--num-samples", "2", "--batch", str(CHUNK), "--device", "cpu",
         "--torch-ckpt", tpth])
    assert_tables_close(res["table"], ref)
    # frame 0 sees the 7 frames after it, frame 5 the 2 after it
    assert len(res["render_s"]) == 9 and res["rays"] == 8 * 12
