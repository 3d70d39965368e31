"""The port's drivers on real-format data against the JAX package on the
CPU, at ``tiny``: ``eval_depth`` on a fabricated nuScenes val split, the
novel-view depth eval (``eval_novel_depth``, ``--depth-tgt raw|max``, the
real temporal_v2 split and ``--synthetic``), the head's ``max_depth``,
training from the loader with a mid-epoch ``--iter-resume``, and
``--resnet-pth``.

Both packages get the same weights: the JAX init (seed 42) with numpy noise
on every leaf but the tiny backbone's, saved as a reference checkpoint that
each driver loads with ``--torch-ckpt`` (the port's with the tiny backbone
added, as in ``test_torch_port_occ.py``). Tolerances: depths within rtol
1e-4, atol 1e-5 of JAX's, the eval-depth parity tolerance of
``test_torch_port_occ.py::test_torch_ckpt_gives_the_jax_depth``; the metric
tables within rtol 1e-4 (atol 1e-6) of JAX's, the threshold accuracies
(a1-a3) exactly; ``max_depth`` exactly, except on rays whose two largest
``w / deltas`` lie within 1e-6 (relative) of each other, where fp32 order
may pick either sample.

Knots. The fabricated datasets have round numbers (camera heights, ego
steps, the synthetic offsets), and some of their samples fall exactly on a
voxel knot of the ``tiny`` grid. There the trilinear sdf gradient has two
one-sided values, and a 1-ulp difference in the sample's coordinate picks
either, changing that sample's alpha and the ray's depth (up to 0.25 m
here). ``test_depths_differ_only_at_knot_samples`` shows that this is the
only difference; the table comparisons run where no sample is on a knot:
the val split's cameras 1.23 cm higher, synthetic offsets off the round
metres.
"""
import pickle
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data import build_dataset as jbuild
from selfocc_tpu.data.synthetic import SyntheticDataset as JSynthetic
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import metrics as jmetrics
from selfocc_tpu.utils.ref_export import export_reference_state_dict
from selfocc_tpu_torch import eval_depth, eval_novel_depth, train
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.heads import max_depth
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import eval_lib as teval
from selfocc_tpu_torch.utils.runtime import get_logger

from test_novel_eval_datasets import make_nuscenes_eval_fixture
from test_nuscenes_dataset import _make_mini_nuscenes
from test_torch_port_data import novel_cfg, nusc_cfg, write_sem_maps
from test_torch_port_occ import _tiny_pth
from test_torch_port_slice import _noisy

OFFSETS = (-1.9, -0.9, 1.1, 2.1)   # synthetic ego offsets, off the knots
RTOL, ATOL = 1e-4, 1e-5          # depth, as test_torch_ckpt_gives_the_jax_depth
TABLE_RTOL, TABLE_ATOL = 1e-4, 1e-6
TIE = 1e-6                       # relative gap of w / deltas that may flip
CHUNK = 96


def six_cams(cfg):
    """``tiny`` with the six cameras of a nuScenes rig."""
    return dataclasses.replace(cfg, num_cams=6, model=dataclasses.replace(
        cfg.model, encoder=dataclasses.replace(cfg.model.encoder,
                                               num_cams=6)))


def jax_weights(cfg, sample, tmp_path, name):
    """The JAX init with noise off the backbone: (params, the JAX variables,
    the port's --torch-ckpt file, the JAX driver's --torch-ckpt file)."""
    jmodel = JSegmentor(cfg=cfg.model)
    init = jeval.init_variables(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in sample.items()}, 42)
    params = jax.tree_util.tree_map(np.asarray, init["params"])
    params = dict(_noisy({k: v for k, v in params.items()
                          if k != "img_backbone"}, np.random.RandomState(5)),
                  img_backbone=params["img_backbone"])
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "consts": init["consts"]}
    jpth = str(tmp_path / f"{name}_jax.pth")
    torch.save({"state_dict": export_reference_state_dict(
        {"params": params})}, jpth)
    return params, jvars, _tiny_pth(params, tmp_path, f"{name}_port.pth"), \
        jpth


def raise_cameras(pkl, dz):
    """Move every camera of a ``_make_mini_nuscenes`` split ``dz`` metres
    up (off the knots of the tiny grid, see the module docstring)."""
    with open(pkl, "rb") as f:
        data = pickle.load(f)
    for scene in data["infos"].values():
        for sample in scene:
            for name, sensor in sample["data"].items():
                if name.startswith("CAM"):
                    t = sensor["calib"]["translation"]
                    sensor["calib"]["translation"] = [t[0], t[1], t[2] + dz]
    with open(pkl, "wb") as f:
        pickle.dump(data, f)


def arrays(item):
    return {k: np.asarray(v) for k, v in item.items()
            if not isinstance(v, (str, dict))}


@pytest.fixture(scope="module")
def novel(tmp_path_factory):
    """tiny (two cameras) on a fabricated temporal_v2 split: the JAX model
    with return_max_depth and a renderer giving depth and max_depth."""
    tmp = tmp_path_factory.mktemp("novel")
    root, pkl = make_nuscenes_eval_fixture(tmp, n_frames=3, num_cams=2)
    jcfg = novel_cfg(jget_config, "tiny", root, pkl)
    tcfg = novel_cfg(get_config, "tiny", root, pkl)
    jcfg, jmodel = jeval.enable_max_depth(jcfg)
    jds = jbuild(jcfg, "novel_eval")
    sample = {k: np.asarray(v) for k, v in
              jeval.novel_eval_first_sample(jds, jcfg, True).items()}
    params, jvars, tpth, _ = jax_weights(jcfg, sample, tmp, "novel")
    renderer = jeval.ChunkedRenderer(jmodel, jvars, chunk=CHUNK, shard=False,
                                     outputs=("depth", "max_depth"))
    return dict(jcfg=jcfg, tcfg=tcfg, jds=jds, jmodel=jmodel, jvars=jvars,
                params=params, tpth=tpth, renderer=renderer, sample=sample)


def assert_tables_close(got, ref):
    assert sorted(got) == sorted(ref) and ref
    for b in ref:
        g, r = np.asarray(got[b]), np.asarray(ref[b])
        np.testing.assert_allclose(g[:4], r[:4], rtol=TABLE_RTOL,
                                   atol=TABLE_ATOL, err_msg=f"bucket {b}")
        np.testing.assert_array_equal(g[4:], r[4:], err_msg=f"bucket {b}")


@pytest.mark.parametrize("synthetic", [False, True], ids=["real", "synthetic"])
@pytest.mark.parametrize("tgt", ["raw", "max"])
def test_novel_depth_table_matches_jax(novel, monkeypatch, tgt, synthetic):
    key = "depth" if tgt == "raw" else "max_depth"
    if synthetic:
        c = novel["jcfg"]
        jds = JSynthetic(num_cams=c.num_cams, input_size=c.input_size,
                         img_size=c.img_size,
                         num_classes=max(c.num_classes,
                                         c.model.head.sem_dims), length=64)
    else:
        jds = novel["jds"]
    logger = get_logger()
    buckets = jeval.run_novel_depth_eval(
        jds, not synthetic, novel["jcfg"], novel["renderer"], logger,
        num_samples=2, offsets=OFFSETS, depth_key=key)
    ref = {b: [float(np.mean(buckets[b][k])) for k in teval.BUCKET_KEYS]
           for b in buckets}
    monkeypatch.setattr(eval_novel_depth, "get_config",
                        lambda name: novel["tcfg"])
    res = eval_novel_depth.main(
        ["--py-config", "tiny", "--num-samples", "2", "--batch", str(CHUNK),
         "--depth-tgt", tgt, "--device", "cpu", "--torch-ckpt",
         novel["tpth"], "--offsets", *map(str, OFFSETS)]
        + (["--synthetic"] if synthetic else []))
    assert_tables_close(res["table"], ref)
    # two frames: four ego offsets each, or 1 + 2 temporal neighbours
    assert len(res["render_s"]) == (8 if synthetic else 3)
    assert len(res["prepare_s"]) == 2


def _render_both(novel, vol, o, d):
    """The JAX head's and the port's geo-only render of rays (o, d) against
    the JAX-decoded volume ``vol`` (handed to the port in the decode's
    channel-last layout); the port's model has return_max_depth."""
    jout = jax.jit(lambda v, vo, o, d: novel["jmodel"].apply(
        v, vo, o, d, geo_only=True, method="render_rays"))(
            novel["jvars"], vol, o, d)
    tmodel = TPVSegmentor(teval.enable_max_depth(novel["tcfg"]).model).eval()
    tmodel.load_state_dict(from_jax_variables({"params": novel["params"]}))
    tvol = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(vol), 0, -1))).permute(3, 0, 1, 2)
    with torch.no_grad():
        tout = tmodel.render_rays(tvol, torch.from_numpy(np.asarray(o)),
                                  torch.from_numpy(np.asarray(d)),
                                  geo_only=True)
    return {k: np.asarray(v) for k, v in jout.items()}, \
        {k: v.numpy() for k, v in tout.items()}, tmodel


def _knot_rays(tmodel, o, d, ts):
    """Rays with a sample within 1e-5 (grid units) of a voxel knot along
    some axis, in float64."""
    o, d, ts = (np.asarray(x, np.float64) for x in (o, d, ts))
    pos = o[:, None] + d[:, None] / np.linalg.norm(d, axis=-1)[:, None, None] \
        * (ts * np.linalg.norm(d, axis=-1)[:, None])[..., None]
    grid = tmodel.head.field.mapping.meter2grid(
        torch.from_numpy(pos)).numpy()
    return (np.abs(grid - np.round(grid)) < 1e-5).any(-1).any(-1)


def test_depths_differ_only_at_knot_samples(novel):
    # the synthetic scene's neighbour at a 2 m offset puts samples exactly
    # on knots of the tiny grid: the two packages' depths differ there,
    # and only there
    c = novel["jcfg"]
    ds = JSynthetic(num_cams=c.num_cams, input_size=c.input_size,
                    img_size=c.img_size, num_classes=5, length=64)
    item = arrays(ds[1])
    vol = novel["renderer"].prepare(jnp.asarray(item["imgs"]),
                                    jnp.asarray(item["lidar2img"]))
    knots = 0
    for off in (-2.0, 1.0, 2.0):
        nb = ds.novel_view_sample(1, off)
        o, d = jeval.rays_for_cams(jnp.asarray(nb["temImg2lidar"]),
                                   jeval.eval_ray_grid(c))
        jout, tout, tmodel = _render_both(novel, vol, o, d)
        on_knot = _knot_rays(tmodel, o, d, jout["ts"])
        differ = ~np.isclose(tout["depth"], jout["depth"], rtol=RTOL,
                             atol=ATOL)
        assert not (differ & ~on_knot).any(), off
        knots += int(differ.sum())
    assert knots > 0


def _top2_gap(w, deltas):
    eps = np.finfo(np.float32).eps
    r = np.where(deltas < eps, 0.0, w) / np.maximum(deltas, eps)
    top = np.sort(r, -1)
    return (top[:, -1] - top[:, -2]) / np.maximum(np.abs(top[:, -1]), 1e-30)


def test_max_depth_matches_the_jax_head(novel):
    # the head's render on the JAX-decoded volume (handed over in the
    # decode's channel-last layout), rays of both frames' neighbours
    cfg, jr = novel["jcfg"], novel["renderer"]
    vol = jr.prepare(jnp.asarray(novel["sample"]["imgs"]),
                     jnp.asarray(novel["sample"]["lidar2img"]))
    _, _, metas = novel["jds"][1]
    rays = jeval.eval_ray_grid(cfg)
    o, d = jeval.rays_for_cams(jnp.asarray(metas["temImg2lidars"][0],
                                           jnp.float32)[None], rays)
    jout, tout, tmodel = _render_both(novel, vol, o, d)
    got, ref = tout["max_depth"], jout["max_depth"]
    np.testing.assert_allclose(tout["depth"], jout["depth"], rtol=RTOL,
                               atol=ATOL)
    near_tie = _top2_gap(jout["weights"], jout["deltas"]) < TIE
    differ = got != ref
    assert not (differ & ~near_tie).any(), int((differ & ~near_tie).sum())
    assert differ.sum() <= 0.01 * differ.size
    # a zero volume: every sample has the same alpha, so the weights fall
    # along the ray and both heads take the first sample
    jz, tz, _ = _render_both(novel, jnp.zeros_like(vol), o, d)
    np.testing.assert_array_equal(tz["max_depth"], jz["max_depth"])
    np.testing.assert_array_equal(tz["max_depth"], tz["ts"][:, 0])


def _jax_max_depth(weights, ts, deltas):
    # JAX heads.py:379-386, the head's max_depth lines on its own inputs
    eps = jnp.finfo(jnp.float32).eps
    w = jnp.where(deltas < eps, 0.0, weights)
    idx = jnp.argmax(w / jnp.maximum(deltas, eps), axis=-1)
    return jnp.take_along_axis(ts, idx[..., None], axis=-1)[..., 0]


def test_max_depth_ties_take_the_first_sample():
    # w / deltas tied between two or more samples, exactly: both take the
    # first; a sample with deltas < eps never wins
    rng = np.random.RandomState(3)
    R, S = 64, 16
    deltas = np.full((R, S), 0.5, np.float32)
    w = rng.uniform(0, 0.2, (R, S)).astype(np.float32)
    for r in range(R):
        a, b = sorted(rng.choice(S, 2, replace=False))
        w[r, a] = w[r, b] = 0.9                       # a two-way tie
        if r % 4 == 0:
            w[r, (b + 1) % S] = 0.9                   # a three-way one
        if r % 5 == 0:
            deltas[r, a] = 0.0                        # the first is excluded
            w[r, a] = 5.0
    deltas[::7] = 0.25                                # ties in w / deltas
    ts = np.cumsum(deltas, -1).astype(np.float32)
    got = max_depth(*(torch.from_numpy(x) for x in (w, ts, deltas)))
    ref = _jax_max_depth(*(jnp.asarray(x) for x in (w, ts, deltas)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_eval_depth_on_the_val_split_matches_jax(tmp_path, monkeypatch):
    import eval_depth as jdriver
    data_path, pkl, roots = _make_mini_nuscenes(tmp_path, with_lidar=True)
    raise_cameras(pkl, 0.0123)
    jcfg = six_cams(nusc_cfg(jget_config, "tiny", data_path, pkl))
    tcfg = six_cams(nusc_cfg(get_config, "tiny", data_path, pkl))
    sample = arrays(jbuild(jcfg, "val")[0])
    _, _, tpth, jpth = jax_weights(jcfg, sample, tmp_path, "val")
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
    monkeypatch.setattr(sys, "argv", [
        "eval_depth.py", "--py-config", "tiny", "--num-samples", "2",
        "--batch", str(CHUNK), "--no-shard", "--torch-ckpt", jpth,
        "--work-dir", str(tmp_path / "j")])
    jdriver.main()
    monkeypatch.setattr(eval_depth, "get_config", lambda name: tcfg)
    res = eval_depth.main(["--py-config", "tiny", "--num-samples", "2",
                           "--batch", str(CHUNK), "--device", "cpu",
                           "--torch-ckpt", tpth])
    np.testing.assert_allclose(res["last_depth"].numpy().reshape(-1),
                               seen["depth"][-1], rtol=RTOL, atol=ATOL)
    (ref,) = seen["table"]
    got = res["metric"]
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        if k.endswith(("a1", "a2", "a3")):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=TABLE_RTOL,
                                       atol=TABLE_ATOL, err_msg=k)
    assert res["rays"] == 2 * 6 * 8 * 12


@pytest.fixture(scope="module")
def sweeps_cfg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    data_path, pkl, _ = _make_mini_nuscenes(tmp, with_lidar=True)
    return six_cams(nusc_cfg(get_config, "tiny", data_path, pkl, dict(
        sem_from=write_sem_maps(data_path, 5), sem_apply_lut=False)))


def test_iter_resume_repeats_no_item(sweeps_cfg, tmp_path, monkeypatch):
    # an uninterrupted run of 5 steps (one epoch has 6 items); a run
    # resumed from its step-2 checkpoint to step 3; a second resume from
    # that run's checkpoint to step 5: the same items in the same order,
    # each once, and the same losses
    monkeypatch.setattr(train, "get_config", lambda name: sweeps_cfg)
    base = ["--py-config", "tiny", "--device", "cpu", "--print-freq", "1",
            "--prefetch", "2"]
    a = train.main(base + ["--max-steps", "5", "--ckpt-freq-iters", "2",
                           "--work-dir", str(tmp_path / "a")])
    ckpts = sorted(os.listdir(tmp_path / "a" / "ckpts"))
    assert ckpts == ["final.pt", "iter_2.pt", "iter_4.pt", "latest.pt"]
    st = torch.load(tmp_path / "a" / "ckpts" / "iter_2.pt")
    assert (st["step"], st["epoch"], st["last_iter"]) == (2, 0, 2)
    b = train.main(base + ["--max-steps", "3", "--ckpt-freq-iters", "1",
                           "--iter-resume", "--work-dir",
                           str(tmp_path / "b"), "--resume-from",
                           str(tmp_path / "a" / "ckpts" / "iter_2.pt")])
    c = train.main(base + ["--max-steps", "5", "--iter-resume",
                           "--work-dir", str(tmp_path / "c"),
                           "--resume-from", str(tmp_path / "b")])
    assert len(set(a["items"])) == 5
    assert b["items"] == a["items"][2:3] and c["items"] == a["items"][3:5]
    for k, v in a["metrics"].items():
        if k not in ("times", "lr"):
            assert torch.equal(c["metrics"][k], v), k
    # without --iter-resume the epoch starts again from its first item
    d = train.main(base + ["--max-steps", "3", "--work-dir",
                           str(tmp_path / "d"), "--resume-from",
                           str(tmp_path / "a" / "ckpts" / "iter_2.pt")])
    assert d["items"] == a["items"][:1]


def test_epoch_checkpoints(sweeps_cfg, tmp_path, monkeypatch):
    monkeypatch.setattr(train, "get_config", lambda name: sweeps_cfg)
    res = train.main(["--py-config", "tiny", "--device", "cpu", "--epochs",
                      "2", "--max-steps", "8", "--prefetch", "0",
                      "--work-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path / "ckpts")) == [
        "epoch_1.pt", "final.pt", "latest.pt"]
    st = torch.load(tmp_path / "ckpts" / "epoch_1.pt")
    assert (st["step"], st["epoch"], st["last_iter"]) == (6, 1, 0)
    assert sorted(res["items"][:6]) == list(range(6))
    assert res["items"][6:] == list(np.random.RandomState(43).permutation(
        6)[:2])


def _torchvision_resnet50_state_dict(seed=0):
    """Random tensors under torchvision's ResNet-50 names and shapes (the
    port's backbone keys, plus ``num_batches_tracked`` and ``fc``)."""
    from selfocc_tpu_torch.models.resnet import ResNet50
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in ResNet50().state_dict().items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.05
        if k.endswith("running_var"):
            x = np.abs(x) + 0.5
        sd[k] = torch.from_numpy(x)
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_resnet_pth_matches_the_jax_import(tmp_path):
    from selfocc_tpu.utils.checkpoint import load_torch_resnet50 as jload
    from selfocc_tpu_torch.bridge import _backbone
    from selfocc_tpu_torch.utils.checkpoint import load_torch_resnet50
    sd = _torchvision_resnet50_state_dict()
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    cfg = get_config("nuscenes_occ")
    model = train.build_trainer(cfg, 0, torch.device("cpu")).model
    assert load_torch_resnet50(model, path) == len(sd) - 2 - 53
    params, stats = jload({}, {}, path)
    ref = {}
    _backbone(ref, params["img_backbone"], stats["img_backbone"])
    got = model.img_backbone.state_dict()
    assert set(ref) == {f"img_backbone.{k}" for k in got}
    for k, v in got.items():
        torch.testing.assert_close(v, ref[f"img_backbone.{k}"], rtol=0,
                                   atol=0, msg=k)
    # a shape that differs, or a missing key, is refused before loading
    before = {k: v.clone() for k, v in got.items()}
    for bad in ({**sd, "layer1.0.conv1.weight": torch.zeros(64, 64, 3, 3)},
                {k: v for k, v in sd.items() if k != "layer4.2.bn3.bias"}):
        torch.save(bad, path)
        with pytest.raises(RuntimeError, match="torchvision ResNet-50"):
            load_torch_resnet50(model, path)
        for k, v in model.img_backbone.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_resnet_pth_through_the_driver(sweeps_cfg, tmp_path, monkeypatch):
    # the driver loads it only into a resnet50 backbone; a path given
    # that does not exist is an error
    cfg = dataclasses.replace(get_config("nuscenes_occ"),
                              train_dataset_args=sweeps_cfg.train_dataset_args)
    monkeypatch.setattr(train, "get_config", lambda name: cfg)
    monkeypatch.setattr(train, "train", lambda *a, **kw: {"ok": True})
    with pytest.raises(SystemExit, match="not found"):
        train.main(["--py-config", "x", "--device", "cpu", "--resnet-pth",
                    str(tmp_path / "absent.pth")])
    path = str(tmp_path / "resnet50.pth")
    sd = _torchvision_resnet50_state_dict(1)
    torch.save(sd, path)
    loaded = {}
    orig = train.build_trainer

    def build(*a):
        loaded["t"] = orig(*a)
        return loaded["t"]
    monkeypatch.setattr(train, "build_trainer", build)
    assert train.main(["--py-config", "x", "--device", "cpu",
                       "--resnet-pth", path]) == {"ok": True}
    torch.testing.assert_close(
        loaded["t"].model.img_backbone.layer2[1].conv2.weight,
        sd["layer2.1.conv2.weight"], rtol=0, atol=0)
