"""The depth recipes of the port against the JAX package on the CPU: the
loader's focal ratios and flip in the training step, ``EdgeLoss3DMS``,
``build_dataset`` for KITTI-raw (``Kitti_Raw_Stereo``, ``Kitti_Raw``) on a
fabricated raw tree, a KITTI-raw-shaped training step from a loader batch,
``eval_depth`` with raw / ``--flip`` / ``--depth-metric-tgt max`` /
``--save-depth`` on that tree, and a ``nuscenes_depth`` item with its input
crop.

The KITTI-raw-shaped model is ``tiny`` with ``kitti_raw_depth``'s options,
built here from each package's ``tiny`` with ``dataclasses.replace``
(neither config module is edited): the ``h_half`` mapping over a front-only
box, one camera, one sdf channel (no colour, no semantics, no second
derivative), the recipe's three losses (``ReprojLossMonoMultiNew``,
``EikonalLoss``, ``EdgeLoss3DMS``), ``_KITTI_IMG_NORM``, the recipe's
dataset arguments pointed at the fixture (its 64 x 96 crop), a 0.5 resize
with ``pad_scale_rate`` (0.5149, 0.5013), so that the loader's focal ratios
are 0.9711 / 0.9975 as ``kitti_raw_depth``'s are 0.9712 / 0.9975, and
dropout 0. The head's draws are made in JAX by replaying its key splits
and handed to the port.

Tolerances: the step's losses rtol 1e-5 and every parameter gradient within
1e-4 of its largest value + 1e-7 (``test_torch_port_train.py``);
``EdgeLoss3DMS`` rtol 1e-6 and its input gradients within 1e-6 of their
largest value; dataset items equal; ``eval_depth``'s depths within rtol
1e-4, atol 1e-5 of JAX's and its tables as in ``test_torch_port_novel.py``
(rtol 1e-4, atol 1e-6; the threshold accuracies exactly); ``max_depth``
equal but on rays whose two largest ``w / deltas`` lie within 1e-6 of each
other. The fixture's poses step 1.0123 m, not whole metres, so that no
render sample lies on a voxel knot (see ``test_torch_port_novel.py``).
"""
import dataclasses
import os
import random
import sys

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs import experiments as jexp
from selfocc_tpu.data import build_dataset as jbuild
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.losses.regularizers import EdgeLoss3DMS as JEdgeLoss
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import metrics as jmetrics
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import eval_depth
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs import experiments as texp
from selfocc_tpu_torch.data import build_dataset as tbuild
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import train_lib as ttrain
from selfocc_tpu_torch.utils.runtime import host_arrays

from test_nuscenes_dataset import _make_mini_nuscenes
from test_torch_port_data import nusc_cfg
from test_torch_port_novel import (CHUNK, RTOL, ATOL, TABLE_ATOL, TABLE_RTOL,
                                   TIE, jax_weights)
from test_torch_port_train import (assert_grad_close, jax_draws, no_dropout,
                                   perturb)
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy
DAY = "2011_09_26"
DRIVES = ("2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync")
RAW_PC = (-10.0, 0.0, -1.0, 10.0, 10.0, 3.0)   # tiny's box, front only
FOCAL = (0.5, 0.4817)                          # kitti_occ's loader ratios


def make_raw_tree(tmp, n=8, img_hw=(72, 104), step=1.0123):
    """A KITTI-raw tree in the layout of ``tests/test_kitti_raw_dataset.py``
    (one day, two drives of ``n`` frames ``step`` metres apart along the
    camera's z, textured ``image_02`` / ``image_03`` PNGs, 400-point
    velodyne scans in front of the car, KITTI-like calibrations with a
    0.54 m baseline, ORB-SLAM pose files) and its eigen_zhou split: every
    4th frame of each drive, both sides, in ``test_files.txt``, the others
    in ``train_files.txt``. Returns (root, pose dir, split dir). Each frame
    carries noise of its own: with smooth images alone the neighbours are
    so alike that the automask takes the identity loss at every ray, and
    the reprojection loss becomes an SSIM of near-equal images whose fp32
    cancellation puts two correct implementations 2e-5 apart."""
    root, poses = os.path.join(tmp, "raw"), os.path.join(tmp, "poses", DAY)
    split = os.path.join(tmp, "splits", "eigen_zhou")
    for d in (poses, split):
        os.makedirs(d)
    H, W = img_hw
    y = np.linspace(0, 1, H)[:, None]
    x = np.linspace(0, 1, W)[None]
    lines = {"train_files.txt": [], "test_files.txt": []}
    for d, drive in enumerate(DRIVES):
        seq = os.path.join(root, DAY, drive)
        for sub in ("image_02/data", "image_03/data", "velodyne_points/data"):
            os.makedirs(os.path.join(seq, sub))
        rows = []
        for i in range(n):
            r = np.random.RandomState(100 * d + i)
            for c, cam in enumerate(("image_02", "image_03")):
                img = np.stack(np.broadcast_arrays(
                    120 + 80 * np.sin(6 * x + 0.3 * i + c) * y,
                    140 + 60 * np.cos(4 * y + 2 * x + 0.1 * i),
                    160 - 100 * y + 30 * np.sin(9 * x * y + 0.2 * i + d)),
                    -1) + r.uniform(-40, 40, (H, W, 3))
                cv2.imwrite(os.path.join(seq, cam, "data", f"{i:010d}.png"),
                            img.clip(0, 255).astype(np.uint8))
            pts = np.stack([r.uniform(2, 30, 400), r.uniform(-10, 10, 400),
                            r.uniform(-1.7, 2, 400), r.uniform(0, 1, 400)], 1)
            pts.astype(np.float32).tofile(os.path.join(
                seq, "velodyne_points", "data", f"{i:010d}.bin"))
            pose = np.eye(4)
            pose[2, 3] = step * i
            rows.append(" ".join(f"{v:.9e}" for v in pose[:3].reshape(-1)))
            name = "train_files.txt" if i % 4 else "test_files.txt"
            lines[name] += [f"{DAY}/{drive} {i} l", f"{DAY}/{drive} {i} r"]
        with open(os.path.join(poses, f"{drive}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, DAY, "calib_cam_to_cam.txt"), "w") as f:
        f.write("P_rect_02: 60 0 52 2.7 0 60 34 0.1 0 0 1 0.003\n"
                "P_rect_03: 60 0 52 -32.4 0 60 34 0.1 0 0 1 0.003\n"
                "R_rect_00: 0.9999 0.0098 -0.0074 -0.0099 0.9999 -0.0043 "
                "0.0074 0.0044 1.0\n")
    with open(os.path.join(root, DAY, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0 -0.08 -0.27\n")
    for name, rows in lines.items():
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    return root, os.path.dirname(poses), split


def raw_tiny(exp, tree=None, dtype="Kitti_Raw_Stereo"):
    """``tiny`` widths with ``kitti_raw_depth``'s options (module
    docstring), from the package whose ``configs.experiments`` is ``exp``;
    with ``tree`` (``make_raw_tree``'s), the recipe's dataset arguments
    pointed at it."""
    cfg, r = exp.tiny(), exp.kitti_raw_depth()
    mapping = dict(cfg.model.head.mapping_args, h_half=True)
    loss_cfgs = [dict(c, img_size=list(cfg.img_size),
                      ray_resize=list(cfg.num_rays)) if "img_size" in c
                 else dict(c) for c in r.loss_cfgs]
    enc = dataclasses.replace(cfg.model.encoder, mapping_args=mapping,
                              pc_range=RAW_PC, num_cams=1, dropout=0.0)
    head = dataclasses.replace(
        cfg.model.head, roi_aabb=RAW_PC, mapping_args=mapping,
        return_second_grad=False, return_sem=False, color_dims=0,
        sem_dims=0)
    train_ds, val_ds = dict(r.train_dataset_args), dict(r.val_dataset_args)
    if tree is not None:
        root, poses, split = tree
        for args, name in ((train_ds, "train_files.txt"),
                           (val_ds, "test_files.txt")):
            args.update(data_path=root, pose_path=poses,
                        crop_size=list(cfg.img_size),
                        split_path=os.path.join(split, name))
    return dataclasses.replace(
        cfg, name="raw_tiny",
        model=dataclasses.replace(cfg.model, encoder=enc, head=head),
        loss_cfgs=loss_cfgs, loss_input_convertion=dict(
            r.loss_input_convertion), num_cams=1, sem=False,
        dataset_type=dtype, scale_rate=0.5,
        wrapper_args=dict(r.wrapper_args, pad_img_size=list(cfg.input_size),
                          pad_scale_rate=[0.5149, 0.5013]),
        train_dataset_args=train_ds, val_dataset_args=val_ds)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    return make_raw_tree(str(tmp_path_factory.mktemp("kitti_raw")))


def seeded_item(ds, i):
    """Item ``i`` after seeding Python's and numpy's generators with ``i``
    (the stereo side and the photometric augmentation draw from them)."""
    random.seed(i)
    np.random.seed(i)
    return ds[i]


def jax_loss_and_grad(jcfg, batch, params, variables, rng):
    """The JAX step's losses and parameter gradients (bridged to the
    port's names) on a numpy batch."""
    jmodel = JSegmentor(cfg=jcfg.model)
    compute = jtrain.make_loss_fn(jmodel, jcfg)
    (_, (ldict, _)), grads = jax.jit(jax.value_and_grad(
        compute, has_aux=True), static_argnums=5)(
        jax.tree_util.tree_map(jnp.asarray, params), {},
        variables["consts"], {k: jnp.asarray(v) for k, v in batch.items()},
        rng, 0)
    return {"losses": {k: float(v) for k, v in ldict.items()},
            "grads": from_jax_variables(
                {"params": jax.tree_util.tree_map(np.asarray, grads)})}


def port_trainer(tcfg, params):
    """The port's ``Trainer`` on the JAX parameters, with no clipping, so
    that the parameters' ``.grad`` after ``step`` are the loss's
    gradients."""
    model = TPVSegmentor(tcfg.model)
    model.load_state_dict(from_jax_variables({"params": params}),
                          strict=True)
    return ttrain.Trainer(dataclasses.replace(tcfg, grad_max_norm=1e30),
                          model)


def assert_step_matches(trainer, batch, draws, jres):
    metrics = trainer.step({k: T(np.array(v)) for k, v in batch.items()},
                           None, draws=draws)
    assert set(jres["losses"]) <= set(metrics)
    for k, v in jres["losses"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5,
                                   err_msg=k)
    params = dict(trainer.model.named_parameters())
    assert set(params) == set(jres["grads"])
    for name, ref in jres["grads"].items():
        assert params[name].grad is not None, name
        assert_grad_close(params[name].grad.numpy(), ref.numpy(), name)


# ------------------------------------------- the loader's focal ratios

@pytest.fixture(scope="module")
def tiny_focal():
    """A ``tiny`` batch carrying ``kitti_occ``'s focal ratios (0.5 /
    0.4817) and the loader's ``flip`` (False), the perturbed JAX init and
    the JAX step's losses and gradients on it."""
    jcfg = no_dropout(jexp.tiny())
    ds = SyntheticDataset(num_cams=jcfg.num_cams, input_size=jcfg.input_size,
                          img_size=jcfg.img_size, num_classes=5, length=1)
    batch = host_arrays(ds[0])
    n = jcfg.num_cams
    batch.update(flip=np.asarray(False),
                 focal_ratios_x=np.full((n,), FOCAL[0], np.float32),
                 focal_ratios_y=np.full((n,), FOCAL[1], np.float32))
    variables = jeval.init_variables(
        JSegmentor(cfg=jcfg.model), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = perturb(jax.tree_util.tree_map(np.asarray, variables["params"]),
                     np.random.RandomState(0))
    rng = jax.random.PRNGKey(3)
    jres = jax_loss_and_grad(jcfg, batch, params, variables, rng)
    return batch, params, jax_draws(rng, jcfg), jres


def test_train_step_takes_the_focal_ratios(tiny_focal):
    # the port's Trainer.step on a batch with focal_ratios_x/y != 1: the
    # JAX step scales the projected reference points by them
    batch, params, draws, jres = tiny_focal
    trainer = port_trainer(no_dropout(texp.tiny()), params)
    assert_step_matches(trainer, batch, draws, jres)


def test_flip_and_focal_reach_the_loss(tiny_focal):
    # the port's counterpart of tests/test_train_lib.py::
    # test_flip_and_focal_plumbed_into_loss: flip changes the loss, the
    # ratios change it, and ratio 1.0 is no ratio at all
    batch, params, draws, _ = tiny_focal
    cfg = no_dropout(texp.tiny())
    model = TPVSegmentor(cfg.model)
    model.load_state_dict(from_jax_variables({"params": params}))
    model.train()
    loss_fn = tlosses.MultiLoss(cfg.loss_cfgs)
    base = {k: T(np.array(v)) for k, v in batch.items()
            if not k.startswith(("flip", "focal"))}
    ones = torch.ones(cfg.num_cams)

    def loss(**aug):
        b = dict(base, **aug)
        with torch.no_grad():
            out = model(b["imgs"], b["lidar2img"], b["temImg2lidar"],
                        train=True, draws=draws, **ttrain.aug_kwargs(b))
            return float(loss_fn(ttrain.build_loss_inputs(cfg, out, b))[0])

    off = loss(flip=torch.tensor(False))
    assert loss(flip=torch.tensor(True)) != off
    half = loss(focal_ratios_x=0.5 * ones, focal_ratios_y=0.5 * ones)
    assert half != off
    np.testing.assert_allclose(
        loss(focal_ratios_x=ones, focal_ratios_y=ones), off, rtol=1e-6)
    assert loss() == off


# ------------------------------------------------------ EdgeLoss3DMS

@pytest.mark.parametrize("inf_mask", [False, True])
def test_edge_loss_matches_jax(inf_mask):
    rng = np.random.RandomState(4)
    h, w, img = (6, 9), 54, (40, 72)
    inputs = {
        "curr_imgs": rng.rand(1, 2, 30, 50, 3).astype(np.float32),
        "ms_depths": [rng.uniform(1, 30, (1, 2, w)).astype(np.float32)
                      for _ in range(2)],
        "ms_rays": np.stack([rng.uniform(-2, 74, w), rng.uniform(-2, 42, w)],
                            -1).astype(np.float32)}
    kw = dict(weight=0.01, img_size=list(img), ray_resize=list(h))
    if inf_mask:
        inputs["ms_accs"] = [rng.rand(1, 2, w).astype(np.float32)
                             for _ in range(2)]
        inputs["max_depths"] = [np.float32(40.0), np.float32(45.0)]
        kw.update(use_inf_mask=True, input_dict={
            k: k for k in ("curr_imgs", "ms_depths", "ms_rays", "ms_accs",
                           "max_depths")})
    jl = JEdgeLoss(**kw)
    tl = tlosses.build_loss(dict(kw, type="EdgeLoss3DMS"))
    diff = ["curr_imgs", "ms_depths"] + (["ms_accs"] if inf_mask else [])
    ref, jg = jax.value_and_grad(lambda d: jl(dict(inputs, **d)))(
        {k: jax.tree_util.tree_map(jnp.asarray, inputs[k]) for k in diff})
    leaves = {k: (T(inputs[k].copy()).requires_grad_() if k == "curr_imgs"
                  else [T(x.copy()).requires_grad_() for x in inputs[k]])
              for k in diff}
    got = tl(dict({k: (T(np.asarray(v)) if k != "max_depths" else
                       [torch.tensor(x) for x in v])
                   for k, v in inputs.items()}, **leaves))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    for k in diff:
        tg = [leaves[k].grad] if k == "curr_imgs" else \
            [x.grad for x in leaves[k]]
        rg = [jg[k]] if k == "curr_imgs" else jg[k]
        for g, r in zip(tg, rg):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=1e-6 * float(np.abs(r).max()),
                                       err_msg=k)


# ----------------------------------------------------- the raw loader

def _items_equal(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, (str, tuple)):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("dtype", ["Kitti_Raw_Stereo", "Kitti_Raw"])
def test_kitti_raw_items_match_jax(raw_tree, dtype, phase):
    jds = jbuild(raw_tiny(jexp, raw_tree, dtype), phase)
    tds = tbuild(raw_tiny(texp, raw_tree, dtype), phase)
    assert len(tds) == len(jds) == {"train": 24, "val": 8}[phase]
    for i in range(len(jds)):
        ref, got = seeded_item(jds, i), seeded_item(tds, i)
        _items_equal(got, ref)
    assert got["imgs"].shape == (1, 1, 32, 48, 3)
    np.testing.assert_allclose(got["focal_ratios_x"], [0.5 / 0.5013])
    np.testing.assert_allclose(got["focal_ratios_y"], [0.5 / 0.5149])
    if phase == "val":
        # the eigen-cropped lidar depth, of a length of its own per frame
        assert got["depth_loc"].shape[:2] == got["depth_gt"].shape
        assert got["depth_mask"].any()


def test_kitti_raw_train_items_take_the_stereo_side(raw_tree):
    # Kitti_Raw_Stereo swaps prev / next supervision for the other camera
    # on some draws of the stereo side; Kitti_Raw never does
    seen = {}
    for dtype in ("Kitti_Raw_Stereo", "Kitti_Raw"):
        ds = tbuild(raw_tiny(texp, raw_tree, dtype), "train").dataset
        paths = [seeded_item(ds, i)[1] for i in range(len(ds))]
        seen[dtype] = sum(
            ("image_03" in m["prev_imgs_path"][0]) !=
            ("image_03" in m["curr_imgs_path"][0]) or
            ("image_03" in m["next_imgs_path"][0]) !=
            ("image_03" in m["curr_imgs_path"][0]) for m in paths)
    assert seen["Kitti_Raw_Stereo"] > 0 and seen["Kitti_Raw"] == 0


# ------------------------------------------ the KITTI-raw-shaped step

def test_kitti_raw_train_step_matches_jax(raw_tree):
    # a loader batch (its focal ratios 0.9975 / 0.9711) through the port's
    # Trainer.step against the JAX step: the three losses and every
    # parameter gradient
    jcfg, tcfg = raw_tiny(jexp, raw_tree), raw_tiny(texp, raw_tree)
    ref = host_arrays(seeded_item(jbuild(jcfg, "train"), 5))
    batch = host_arrays(seeded_item(tbuild(tcfg, "train"), 5))
    _items_equal(batch, ref)
    assert float(batch["focal_ratios_y"][0]) < 0.98
    variables = jeval.init_variables(
        JSegmentor(cfg=jcfg.model), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = perturb(jax.tree_util.tree_map(np.asarray, variables["params"]),
                     np.random.RandomState(1))
    rng = jax.random.PRNGKey(5)
    jres = jax_loss_and_grad(jcfg, batch, params, variables, rng)
    assert sorted(jres["losses"]) == ["EdgeLoss3DMS", "EikonalLoss",
                                      "ReprojLossMonoMultiNew"]
    assert all(np.isfinite(v) and v != 0 for v in jres["losses"].values())
    assert_step_matches(port_trainer(tcfg, params), batch,
                        jax_draws(rng, jcfg), jres)


# ------------------------------------------------------- eval_depth

@pytest.fixture(scope="module")
def raw_weights(raw_tree, tmp_path_factory):
    """The JAX init with noise, as each driver's --torch-ckpt."""
    jcfg = raw_tiny(jexp, raw_tree)
    sample = host_arrays(jbuild(jcfg, "val")[0])
    _, _, tpth, jpth = jax_weights(jcfg, sample,
                                   tmp_path_factory.mktemp("w"), "raw")
    return tpth, jpth


def run_jax_eval_depth(monkeypatch, jcfg, jpth, work, flags):
    """The JAX ``eval_depth.py`` on the fixture: its metric table and each
    render's depth (and max_depth) maps, in order."""
    import eval_depth as jdriver
    import train as jtrain_driver
    seen = {"table": [], "renders": []}
    orig_epoch = jmetrics.DepthMetric._after_epoch
    orig_render = jeval.ChunkedRenderer.render

    def epoch(self, logger=None):
        seen["table"].append(orig_epoch(self, logger))
        return seen["table"][-1]

    def render(self, *a, **kw):
        out = orig_render(self, *a, **kw)
        seen["renders"].append({k: np.asarray(v) for k, v in out.items()})
        return out
    with monkeypatch.context() as m:
        m.setattr(jmetrics.DepthMetric, "_after_epoch", epoch)
        m.setattr(jeval.ChunkedRenderer, "render", render)
        m.setattr(jeval, "load_model_for_eval",
                  lambda name, ckpt="": (jcfg, JSegmentor(cfg=jcfg.model)))
        # a KITTI-raw item's ``sequence`` is a tuple of strings, which the
        # JAX driver's ``as_arrays`` cannot hold: drop it
        m.setattr(jtrain_driver, "as_arrays", lambda item: {
            k: jnp.asarray(v) for k, v in host_arrays(item).items()})
        m.setattr(sys, "argv", [
            "eval_depth.py", "--py-config", "raw_tiny", "--num-samples", "2",
            "--batch", str(CHUNK), "--no-shard", "--torch-ckpt", jpth,
            "--work-dir", work] + flags)
        jdriver.main()
    return seen


def assert_table_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        if k.endswith(("a1", "a2", "a3")):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=TABLE_RTOL,
                                       atol=TABLE_ATOL, err_msg=k)


@pytest.mark.parametrize("mode", ["raw", "flip", "max"])
def test_eval_depth_on_kitti_raw_matches_jax(raw_tree, raw_weights, mode,
                                             tmp_path, monkeypatch):
    tpth, jpth = raw_weights
    flags = {"raw": [], "flip": ["--flip", "--save-depth"],
             "max": ["--depth-metric-tgt", "max", "--save-depth"]}[mode]
    jwork, twork = str(tmp_path / "j"), str(tmp_path / "t")
    seen = run_jax_eval_depth(monkeypatch, raw_tiny(jexp, raw_tree), jpth,
                              jwork, flags)
    tcfg = raw_tiny(texp, raw_tree)
    monkeypatch.setattr(eval_depth, "get_config", lambda name: tcfg)
    res = eval_depth.main(["--py-config", "raw_tiny", "--num-samples", "2",
                           "--batch", str(CHUNK), "--device", "cpu",
                           "--torch-ckpt", tpth, "--work-dir", twork]
                          + flags)
    rh, rw = tcfg.eval_num_rays
    renders = seen["renders"][-2:] if mode == "flip" else seen["renders"][-1:]
    ref = np.mean([r["depth"] for r in renders], 0).reshape(1, rh, rw)
    np.testing.assert_allclose(res["last_depth"].numpy(), ref, rtol=RTOL,
                               atol=ATOL)
    assert res["rays"] == 2 * rh * rw * (2 if mode == "flip" else 1)
    if mode == "max":
        got = res["last_max_depth"].numpy().reshape(-1)
        want = renders[-1]["max_depth"]
        differ = got != want
        # a flip of the argmax is allowed on ties only: the JAX render's
        # two largest w / deltas of those rays within TIE of each other
        assert differ.mean() < 0.05, differ.mean()
        assert_ties(monkeypatch, tcfg, tpth, raw_tree, np.nonzero(differ)[0],
                    TIE)
    assert_table_close(res["metric"], seen["table"][-1])
    if mode != "raw":
        for name in ["depth_0001.npy"] + (["depth_max_0001.npy"]
                                          if mode == "max" else []):
            j, t = (np.load(os.path.join(d, name)) for d in (jwork, twork))
            assert t.shape == j.shape == (1, rh, rw)
            if name == "depth_0001.npy":
                np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def assert_ties(monkeypatch, tcfg, tpth, raw_tree, rays, tie):
    """The rays ``rays`` of the last val frame, where the port's max_depth
    differs from JAX's, have two largest ``w / deltas`` within ``tie``
    (relative) of each other in the port's render."""
    if not len(rays):
        return
    from selfocc_tpu_torch.utils.eval_lib import (enable_max_depth,
                                                  eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    from selfocc_tpu_torch.utils.runtime import load_weights, to_device
    cfg = enable_max_depth(tcfg)
    model = eval_depth.build_model(cfg, 42, torch.device("cpu"))
    load_weights(model, torch_ckpt=tpth)
    batch = to_device(tbuild(cfg, "val")[1], "cpu")
    origin, direction = rays_for_cams(eval_trans_mats(batch, cfg),
                                      eval_ray_grid(cfg))
    with torch.no_grad():
        volume = model.prepare(batch["imgs"], batch["lidar2img"])
        r = model.render_rays(volume, origin[rays], direction[rays],
                              geo_only=True, outputs=("weights", "deltas"))
    ratio = (r["weights"] / r["deltas"]).sort(-1, descending=True)[0]
    gap = (ratio[:, 0] - ratio[:, 1]) / ratio[:, 0]
    assert bool((gap <= tie).all()), gap


def test_eval_depth_median_exits(monkeypatch, tmp_path):
    # as the JAX driver, which exits before it renders
    import eval_depth as jdriver
    monkeypatch.setattr(sys, "argv", [
        "eval_depth.py", "--py-config", "tiny", "--synthetic",
        "--depth-metric-tgt", "median", "--work-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="median"):
        jdriver.main()
    with pytest.raises(SystemExit, match="median"):
        eval_depth.main(["--py-config", "tiny", "--synthetic",
                         "--depth-metric-tgt", "median", "--device", "cpu"])


# ------------------------------------------------------ nuscenes_depth

@pytest.mark.parametrize("phase", ["train", "val"])
def test_nuscenes_depth_items_match_jax(tmp_path, phase):
    # nuscenes_depth's 896 x 1600 input crop of 900 x 1600 supervision, at
    # the fixture's scale: a 60 x 96 input crop of the 64 x 96 images
    data_path, pkl, _ = _make_mini_nuscenes(tmp_path, with_lidar=True)
    extra = dict(input_img_crop_size=[60, 96])
    jds = jbuild(nusc_cfg(jexp.get_config, "nuscenes_depth", data_path, pkl,
                          **extra), phase)
    tds = tbuild(nusc_cfg(texp.get_config, "nuscenes_depth", data_path, pkl,
                          **extra), phase)
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        got = seeded_item(tds, i)
        _items_equal(got, seeded_item(jds, i))
    # the input crop, resized by the recipe's scale rate and padded to 32
    cfg = texp.nuscenes_depth()
    h, w = (int(60 * cfg.scale_rate), int(96 * cfg.scale_rate))
    assert got["imgs"].shape == (1, 6, -(-h // 32) * 32, -(-w // 32) * 32, 3)
    assert got["curr_imgs"].shape == (1, 6, 64, 96, 3)
