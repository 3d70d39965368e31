"""The port's vis and index tools against the JAX package's on the CPU:
``apply_novel_view``, ``save_depth_map`` and the port's magma table,
``write_ply`` and ``export_gt``, a ``tiny`` novel-view render (the port
with the JAX weights, against the JAX ``ChunkedRenderer``), ``vis_3d``'s
occupancy against the JAX ``forward_occ``, the four drivers on ``--device
cpu`` (as ``tests/test_drivers.py`` runs the JAX ones: ``--synthetic``, the
fabricated Occ3D tree, the mini nuScenes tree's scene walk), the exits
that name what is missing (matplotlib for ``--png``, the codec or the
frames of ``generate_videos``, the nuScenes devkit) and
``build_sweep_infos`` on a fabricated devkit object.

Both packages get the same weights: the JAX init (seed 42) with numpy
noise on every leaf but the backbone's (the reference export has no tiny
backbone, ``test_torch_port_occ``); the port's drivers read them as a
``--torch-ckpt``."""
import dataclasses
import logging
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import examine_sweeps as jsweeps
import vis_3d as jvis3d
import vis_pics as jvis_pics
from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.synthetic import SyntheticDataset as JSynthetic
from selfocc_tpu.geometry.projection import apply_novel_view as japply
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu_torch import (examine_sweeps, generate_videos, vis_3d,
                               vis_3d_scene, vis_pics)
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs import experiments as texp
from selfocc_tpu_torch.data.synthetic import SyntheticDataset
from selfocc_tpu_torch.geometry.projection import apply_novel_view
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import eval_lib as teval
from selfocc_tpu_torch.utils.magma import MAGMA, magma
from test_nuscenes_dataset import _make_mini_nuscenes
from test_torch_port_occ import _tiny_pth
from test_torch_port_slice import _noisy
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import jit_apply, memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy
NOVEL = (1.0123, 0.5, 0.3, 10.0)      # off voxel knots
TIE = 1e-5                            # |sdf| below which a voxel may flip


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny synthetic frame the port's drivers read (item 0 of the
    64-item dataset), the JAX model and noisy variables, the bridged port
    model and the same weights as a reference checkpoint."""
    cfg = jget_config("tiny")
    ds = JSynthetic(num_cams=cfg.num_cams, input_size=cfg.input_size,
                    img_size=cfg.img_size,
                    num_classes=max(cfg.num_classes, cfg.model.head.sem_dims),
                    length=64)
    batch = {k: np.asarray(v) for k, v in ds[0].items()
             if not isinstance(v, (str, dict))}
    jmodel = JSegmentor(cfg=cfg.model)
    init = jeval.init_variables(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, 42)
    params = jax.tree_util.tree_map(np.asarray, init["params"])
    params = dict(_noisy({k: v for k, v in params.items()
                          if k != "img_backbone"}, np.random.RandomState(9)),
                  img_backbone=params["img_backbone"])
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "consts": init["consts"]}
    tmodel = TPVSegmentor(texp.get_config("tiny").model).eval()
    tmodel.load_state_dict(from_jax_variables({"params": params}),
                           strict=True)
    pth = _tiny_pth(params, tmp_path_factory.mktemp("w"), "port.pth")
    return dict(cfg=cfg, batch=batch, jmodel=jmodel, jvars=jvars,
                tmodel=tmodel, pth=pth)


@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0, 0.0), NOVEL,
                                    (-3.5, 2.25, -0.75, -47.0),
                                    (0.0, 0.0, 0.0, 180.0)])
def test_apply_novel_view_matches_jax(offset):
    m = np.random.RandomState(3).randn(1, 6, 4, 4).astype(np.float32)
    m0 = m.copy()
    got = apply_novel_view(T(m), offset)
    assert got.dtype == torch.float32 and got.shape == (1, 6, 4, 4)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(japply(jnp.asarray(m), offset)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m, m0)          # the input is kept


def test_magma_table_is_matplotlibs():
    import matplotlib
    cmap = matplotlib.colormaps["magma"]
    cmap(0.5)                                # builds its lookup table
    assert MAGMA.shape == (256, 3) and MAGMA.dtype == np.float64
    np.testing.assert_array_equal(MAGMA, cmap._lut[:256, :3])
    np.testing.assert_array_equal(MAGMA, np.asarray(cmap.colors))
    rng = np.random.RandomState(1)
    for dtype in (np.float32, np.float64):
        x = rng.rand(4096).astype(dtype)
        x[:8] = [0.0, 1.0, np.nan, 255 / 256, 1 / 256, -0.25, 1.5,
                 np.nextafter(dtype(1), dtype(0))]
        np.testing.assert_array_equal(magma(x), cmap(x)[..., :3])


@pytest.mark.parametrize("max_depth", [None, 80.0])
def test_save_depth_map_pngs_equal_jax(tmp_path, max_depth):
    rng = np.random.RandomState(2)
    for k, depth in enumerate((
            rng.uniform(0.5, 120.0, (45, 80)).astype(np.float32),
            np.full((8, 12), 7.25, np.float32),          # flat: disp 0
            rng.uniform(-1.0, 3.0, (16, 16)).astype(np.float32))):
        got, ref = str(tmp_path / f"t{k}.png"), str(tmp_path / f"j{k}.png")
        vis_pics.save_depth_map(depth, got, max_depth)
        jvis_pics.save_depth_map(depth, ref, max_depth)
        a, b = cv2.imread(got), cv2.imread(ref)
        assert a.shape == depth.shape + (3,)
        np.testing.assert_array_equal(a, b)


def test_write_ply_text_equals_jax(tmp_path):
    rng = np.random.RandomState(4)
    xyz = (rng.randn(500, 3) * 30).astype(np.float32)
    rgb = rng.randint(0, 256, (500, 3)).astype(np.uint8)
    for pts, cols in ((xyz, rgb), (xyz.astype(np.float64), rgb),
                      (xyz[:0], rgb[:0])):
        vis_3d.write_ply(str(tmp_path / "t.ply"), pts, cols)
        jvis3d.write_ply(str(tmp_path / "j.ply"), pts, cols)
        with open(tmp_path / "t.ply") as f, open(tmp_path / "j.ply") as g:
            assert f.read() == g.read()


def _kitti_voxels(root, seq, token):
    from selfocc_tpu_torch.data.semantic_kitti_io import pack
    rng = np.random.RandomState(6)
    d = os.path.join(root, "dataset/sequences", seq, "voxels")
    os.makedirs(d)
    label = np.zeros(256 * 256 * 32, np.uint16)
    hit = rng.rand(label.size) < 0.01
    label[hit] = rng.choice([10, 40, 50, 70, 71, 252], int(hit.sum()))
    label.tofile(os.path.join(d, f"{token}.label"))
    pack(rng.rand(label.size) < 0.05).tofile(
        os.path.join(d, f"{token}.invalid"))


@pytest.mark.parametrize("branch", ["occ3d_item", "occ3d_ds", "kitti",
                                    "gt_occupancy", "none"])
def test_export_gt_equals_jax(tmp_path, branch):
    # each branch of export_gt on the same inputs: the same label grid and
    # the same PLY text
    cfg = texp.get_config("tiny")
    aabb = list(cfg.model.head.roi_aabb)
    syn = SyntheticDataset(num_cams=2, input_size=(32, 48), img_size=(64, 96),
                           num_classes=5, length=2)
    xs = [np.linspace(lo, hi, n, dtype=np.float32) for lo, hi, n in
          ((-10, 10, 20), (-10, 10, 20), (-1, 3, 4))]
    out = {"xyz": np.stack(np.meshgrid(*xs, indexing="ij"), -1)}
    item, ds = {}, types.SimpleNamespace()
    if branch == "occ3d_item":
        path = str(tmp_path / "labels.npz")
        np.savez(path, semantics=syn.occ3d_labels(1)["semantics"])
        item = {"occ3d_label_path": path}
    elif branch == "occ3d_ds":
        ds = syn
    elif branch == "kitti":
        _kitti_voxels(str(tmp_path), "08", "000005")
        item = {"token": "000005", "sequence": "08"}
    elif branch == "gt_occupancy":
        ds = types.SimpleNamespace(gt_occupancy=syn.gt_occupancy)
    logger = logging.getLogger("vis-test")
    files = {}
    for tag, fn in (("t", vis_3d.export_gt), ("j", jvis3d.export_gt)):
        work = tmp_path / tag
        work.mkdir()
        args = types.SimpleNamespace(
            work_dir=str(work), resolution=1.0,
            kitti_root=str(tmp_path) if branch == "kitti" else "")
        fn(args, ds, 1, item, out, aabb, logger)
        files[tag] = sorted(os.listdir(work))
    assert files["t"] == files["j"] == ([] if branch == "none" else
                                        ["gt_001.npy", "gt_001.ply"])
    for name in files["t"]:
        a, b = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".npy"):
            ga, gb = np.load(a), np.load(b)
            assert ga.dtype == gb.dtype and np.array_equal(ga, gb)
        else:
            assert a.read_text() == b.read_text()
            assert int(a.read_text().split("\n")[2].split()[-1]) > 0


def test_tiny_novel_view_render_matches_jax(tiny):
    cfg, batch = tiny["cfg"], tiny["batch"]
    outputs = ("depth", "rgb")
    jr = jeval.ChunkedRenderer(tiny["jmodel"], tiny["jvars"], chunk=96,
                               shard=False, volume_dtype="float32",
                               outputs=outputs)
    jvol = jr.prepare(jnp.asarray(batch["imgs"]),
                      jnp.asarray(batch["lidar2img"]))
    jo, jd = jeval.rays_for_cams(
        japply(jnp.asarray(jeval.eval_trans_mats(batch, cfg)), NOVEL),
        jeval.eval_ray_grid(cfg))
    ref = jr.render(jvol, jo, jd)

    tr = teval.ChunkedRenderer(tiny["tmodel"], chunk=96, outputs=outputs)
    tvol = tr.prepare(T(batch["imgs"]), T(batch["lidar2img"]))
    to, td = teval.rays_for_cams(
        apply_novel_view(T(teval.eval_trans_mats(batch, cfg)), NOVEL),
        teval.eval_ray_grid(cfg))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    got = tr.render(tvol, to, td)
    rh, rw = cfg.eval_num_rays
    assert got["depth"].shape == (cfg.num_cams * rh * rw,)
    assert got["rgb"].shape == (cfg.num_cams * rh * rw, 3)
    # the volume's 1e-4 through the render (test_tiny_frame_matches_jax)
    np.testing.assert_allclose(got["depth"], ref["depth"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["rgb"], ref["rgb"], atol=1e-4)
    # the pose moved: the novel view renders other depths than the eval's
    base = tr.render(tvol, *teval.rays_for_cams(
        T(teval.eval_trans_mats(batch, cfg)), teval.eval_ray_grid(cfg)))
    assert np.abs(base["depth"] - got["depth"]).max() > 1e-2


def test_vis_pics_driver(tiny, tmp_path):
    # vis_pics on tiny with the JAX weights, from the novel pose: one PNG
    # of each kind a camera, the depth PNGs the JAX save_depth_map's of
    # the frame's depth, the RGB PNGs its RGB at JAX's 256 * 255 scale
    work = str(tmp_path / "vp")
    res = vis_pics.main(["--py-config", "tiny", "--synthetic",
                         "--num-samples", "1", "--batch", "64",
                         "--novel-view", *map(str, NOVEL), "--work-dir",
                         work, "--torch-ckpt", tiny["pth"], "--device",
                         "cpu"])
    cfg = tiny["cfg"]
    rh, rw = cfg.eval_num_rays
    assert res["rays"] == cfg.num_cams * rh * rw
    names = sorted(n for n in os.listdir(work) if n.endswith(".png"))
    assert names == [f"{k}_000_cam{c}.png" for k in ("depth", "rgb")
                     for c in range(cfg.num_cams)]
    depth, rgb = res["last_depth"], res["last_rgb"]
    assert depth.shape == (cfg.num_cams, rh, rw)
    assert rgb.shape == (cfg.num_cams, rh, rw, 3)
    for c in range(cfg.num_cams):
        jvis_pics.save_depth_map(depth[c], str(tmp_path / "j.png"), 80.0)
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(work, f"depth_000_cam{c}.png")),
            cv2.imread(str(tmp_path / "j.png")))
        img = cv2.imread(os.path.join(work, f"rgb_000_cam{c}.png"))
        want = np.clip(rgb[c] * 256 * 255, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(img[..., ::-1], want)
    # JAX's scale saturates a render in [0, 1]: every channel above
    # 1 / 65280 is 255 (ROADMAP section 3, JAX deviations)
    assert (want[rgb[-1] > 1 / 65280] == 255).all()


def test_vis_3d_occupancy_matches_jax_forward_occ(tiny, tmp_path):
    # the driver's grid at --resolution 1.0 against the JAX forward_occ on
    # the same frame and weights, at a --thresh that splits the JAX grid
    # (the noisy weights put every voxel below 0): occupancy equal but
    # where |sdf - thresh| < 1e-5 in either package, classes equal off
    # near-ties of the logits
    cfg, batch = tiny["cfg"], tiny["batch"]
    ref = jit_apply(tiny["jmodel"], tiny["jvars"],
                    jnp.asarray(batch["imgs"]),
                    jnp.asarray(batch["lidar2img"]),
                    aabb=tuple(cfg.model.head.roi_aabb), resolution=1.0,
                    method="forward_occ")
    sdf_j = np.asarray(ref["sdf"])
    thresh = float(np.float32(np.median(sdf_j)))
    work = str(tmp_path / "v3")
    res = vis_3d.main(["--py-config", "tiny", "--synthetic", "--num-samples",
                       "1", "--resolution", "1.0", "--sem", "--thresh",
                       repr(thresh), "--work-dir", work, "--torch-ckpt",
                       tiny["pth"], "--device", "cpu"])
    got = res["last"]
    np.testing.assert_allclose(got["xyz"], np.asarray(ref["xyz"]), rtol=0,
                               atol=1e-5)
    sdf_t = got["sdf"]
    occ = np.load(os.path.join(work, "occ_000.npy"))
    np.testing.assert_array_equal(occ, sdf_t <= thresh)
    differ = occ != (sdf_j <= thresh)
    assert not (differ & (np.abs(sdf_j - thresh) >= TIE)
                & (np.abs(sdf_t - thresh) >= TIE)).any(), int(differ.sum())
    assert res["voxels"] == [int(occ.sum())] and 0 < occ.sum() < occ.size
    top = np.sort(np.asarray(ref["logits"], np.float64), -1)
    near_tie = top[..., -1] - top[..., -2] < 1e-3
    assert not ((got["sem"] != np.asarray(ref["sem"])) & ~near_tie).any()
    np.testing.assert_array_equal(np.load(os.path.join(work, "sem_000.npy")),
                                  got["sem"])
    ply = open(os.path.join(work, "occ_000.ply")).read().split("\n")
    assert ply[2] == f"element vertex {int(occ.sum())}"


def test_vis_3d_driver_synthetic_gt_png(tmp_path, monkeypatch):
    # as tests/test_drivers.py::test_vis_3d_driver / _gt_export, with the
    # matplotlib projections; without matplotlib --png exits naming it
    work = str(tmp_path / "v3")
    flags = ["--py-config", "tiny", "--synthetic", "--num-samples", "1",
             "--resolution", "1.0", "--work-dir", work, "--device", "cpu"]
    vis_3d.main(flags + ["--gt", "--png"])
    assert {"occ_000.npy", "occ_000.ply", "occ_000.png", "gt_000.npy",
            "gt_000.ply"} <= set(os.listdir(work))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        vis_3d.main(flags + ["--png"])


def _port_real_cfg(monkeypatch, tmp_path, name, **fab_kw):
    """The port's counterpart of ``tests/test_drivers.py::_mini_real_cfg``:
    a fabricated nuScenes-format mini dataset and a 6-camera tiny config
    pointed at it, registered under ``name``."""
    data_path, pkl, label_roots = _make_mini_nuscenes(tmp_path, **fab_kw)
    base = texp.get_config("tiny")
    ds_args = dict(data_path=data_path, imageset=pkl, min_dist=0.4,
                   max_dist=5.0, strict=True, cur_prob=0.5,
                   composite_prev_next=True, sensor_mus=[0.5, 0.5],
                   sensor_sigma=0.5, ego_centric=True, **label_roots)
    cfg = dataclasses.replace(
        base, name=name, sem=False, num_cams=6,
        model=dataclasses.replace(
            base.model,
            encoder=dataclasses.replace(base.model.encoder, num_cams=6)),
        train_dataset_args=ds_args, val_dataset_args=dict(ds_args))
    monkeypatch.setitem(texp._CONFIGS, name, lambda: cfg)
    return data_path, pkl, label_roots


def test_vis_3d_gt_export_occ3d(tmp_path, monkeypatch):
    # as tests/test_drivers.py::test_vis_3d_gt_export_occ3d: the val item's
    # Occ3D labels.npz exported with the nuScenes palette
    _, _, roots = _port_real_cfg(monkeypatch, tmp_path, "tiny_real_v",
                                 with_lidar=True, with_occ3d=True)
    work = str(tmp_path / "v3")
    vis_3d.main(["--py-config", "tiny_real_v", "--num-samples", "1",
                 "--resolution", "1.0", "--gt", "--work-dir", work,
                 "--device", "cpu"])
    gt = np.load(os.path.join(work, "gt_000.npy"))
    assert gt.shape == (200, 200, 16)
    labels = np.load(os.path.join(roots["occ3d_root"], "scene0", "tok0",
                                  "labels.npz"))
    np.testing.assert_array_equal(gt, labels["semantics"])
    ply = open(os.path.join(work, "gt_000.ply")).read().split("\n")
    assert ply[2] == f"element vertex {int((gt != 17).sum())}"


def test_vis_3d_scene_scene_walk(tmp_path):
    # as tests/test_drivers.py::test_vis_3d_scene_scene_walk: two keyframes
    # of the mini tree through nuScenes_Scene_Vis + VisDatasetWrapper,
    # lifted by their lidar2global; the cloud holds every frame's voxels
    data_path, pkl, _ = _make_mini_nuscenes(tmp_path)
    work = str(tmp_path / "scene")
    res = vis_3d_scene.main(["--py-config", "tiny", "--imageset", pkl,
                             "--data-path", data_path, "--num-samples", "2",
                             "--resolution", "1.0", "--work-dir", work,
                             "--device", "cpu"])
    assert len(res["voxels"]) == 2 and res["points"] == sum(res["voxels"])
    pts = np.load(os.path.join(work, "scene_points.npy"))
    ply = open(os.path.join(work, "scene.ply")).read().split("\n")
    assert ply[2] == f"element vertex {len(pts)}" and len(pts) > 0
    # the mini tree's keyframes are 2 m apart along x, lidar at the ego's
    # (0.9, 0, 1.8): frame 1's cloud is frame 0's moved by 2 m
    n0 = res["voxels"][0]
    np.testing.assert_allclose(pts[n0:].mean(0) - pts[:n0].mean(0),
                               [2.0, 0.0, 0.0], atol=0.2)


def test_vis_3d_scene_synthetic(tmp_path):
    work = str(tmp_path / "scene")
    res = vis_3d_scene.main(["--py-config", "tiny", "--synthetic",
                             "--num-samples", "2", "--resolution", "1.0",
                             "--frame-spacing", "3.0", "--work-dir", work,
                             "--device", "cpu"])
    pts = np.load(os.path.join(work, "scene_points.npy"))
    assert res["points"] == len(pts) == sum(res["voxels"])
    n0 = res["voxels"][0]
    np.testing.assert_allclose(pts[n0:].min(0)[0] - pts[:n0].min(0)[0], 3.0,
                               atol=1e-5)


def test_generate_videos_driver(tmp_path, monkeypatch):
    # as tests/test_drivers.py::test_generate_videos_driver; no frames, or
    # a codec cv2 cannot open, exit non-zero naming it
    src = tmp_path / "pics"
    src.mkdir()
    rng = np.random.RandomState(5)
    for idx in range(2):
        for cam in range(2):
            cv2.imwrite(str(src / f"depth_{idx:03d}_cam{cam}.png"),
                        (rng.rand(32, 48, 3) * 255).astype(np.uint8))
    out = tmp_path / "demo.mp4"
    flags = ["--src-dir", str(src), "--num-cams", "2", "--fps", "2"]
    res = generate_videos.main(flags + ["--out", str(out)])
    assert res == {"frames": 2, "size": (32, 144)}
    assert out.exists() and out.stat().st_size > 0
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 2
    cap.release()
    with pytest.raises(SystemExit, match="no frames found"):
        generate_videos.main(["--src-dir", str(tmp_path), "--out",
                              str(tmp_path / "none.mp4")])

    class Closed:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return False
    monkeypatch.setattr(generate_videos.cv2, "VideoWriter", Closed)
    with pytest.raises(SystemExit, match="mp4v"):
        generate_videos.main(flags + ["--out", str(tmp_path / "x.mp4")])


def test_examine_sweeps_names_the_devkit(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    with pytest.raises(SystemExit, match="nuscenes-devkit"):
        examine_sweeps.main(["--base-pkl", str(tmp_path / "b.pkl"),
                             "--out", str(tmp_path / "o.pkl")])


class _FakeNusc:
    """A devkit stand-in: ``get(table, token)`` over two scenes of
    keyframes, each sensor with its own count of sweeps between
    keyframes (camera 12 Hz, lidar 20 Hz in the devkit; here 2-4)."""

    def __init__(self, rng):
        self.tables = {k: {} for k in ("sample", "scene", "sample_data",
                                       "ego_pose", "calibrated_sensor")}
        for s, n_key in (("sa", 3), ("sb", 2)):
            samples = [f"{s}_k{k}" for k in range(n_key)]
            self.tables["scene"][s] = {"name": f"scene-{s}",
                                       "first_sample_token": samples[0]}
            data = {k: {} for k in samples}
            for sensor in jsweeps.SENSOR_TYPES:
                chain = []
                for k in range(n_key):
                    data[samples[k]][sensor] = f"{s}_{sensor}_{k}"
                    chain.append((f"{s}_{sensor}_{k}", True, k * 500000))
                    if k < n_key - 1:
                        n = int(rng.randint(2, 5))
                        chain += [(f"{s}_{sensor}_{k}_{j}", False,
                                   k * 500000 + int(rng.randint(1, 500000)))
                                  for j in range(n)]
                for j, (tok, key, ts) in enumerate(chain):
                    nxt = chain[j + 1][0] if j + 1 < len(chain) else ""
                    self.tables["sample_data"][tok] = {
                        "token": tok, "is_key_frame": key, "timestamp": ts,
                        "next": nxt, "filename": f"{tok}.jpg",
                        "ego_pose_token": "p" + tok,
                        "calibrated_sensor_token": "c" + sensor}
                    self.tables["ego_pose"]["p" + tok] = {
                        "translation": rng.randn(3).tolist(),
                        "rotation": [1.0, 0.0, 0.0, 0.0]}
                    self.tables["calibrated_sensor"]["c" + sensor] = {
                        "translation": [0.5, 0.0, 1.6],
                        "rotation": [1.0, 0.0, 0.0, 0.0]}
            for k, tok in enumerate(samples):
                self.tables["sample"][tok] = {
                    "token": tok, "scene_token": s, "timestamp": k * 500000,
                    "data": data[tok],
                    "next": samples[k + 1] if k + 1 < n_key else ""}

    def get(self, table, token):
        return self.tables[table][token]


def test_build_sweep_infos_equals_jax(capsys):
    nusc = _FakeNusc(np.random.RandomState(8))
    base = [{"token": "sb_k1"}, {"token": "sa_k0"}, {"token": "sa_k2"}]
    got = examine_sweeps.build_sweep_infos(nusc, base)
    ref = jsweeps.build_sweep_infos(nusc, base)
    assert got == ref
    # every keyframe of both scenes, in scene order, and the sweeps
    # synchronised to the least frequent sensor between them
    assert list(got["infos"]) == ["sb", "sa"]
    assert [t for t, _ in got["metadata"]] == ["sb"] * 2 + ["sa"] * 3
    for tok, i in got["metadata"]:
        assert got["infos"][tok][i]["is_key_frame"]
    assert sum(not s["is_key_frame"] for s in got["infos"]["sa"]) >= 4
