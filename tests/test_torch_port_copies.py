"""The port's copies of jax-free modules of the JAX package, pinned to their
originals: the port imports nothing of ``selfocc_tpu``, so it keeps its own
``configs/{base,experiments}.py``, ``data/synthetic.py``,
``utils/metrics.py`` (``DepthMetric``, ``MeanIoU``, ``IoU``,
``openseed2nuscenes``, ``cityscapes2semantickitti``), the ``eval_iou``
driver's helpers, the data modules (``transforms``, ``wrapper``,
``nuscenes_dataset``, ``nuscenes_eval_dataset``, ``sampler``, ``prefetch``,
``semantic_kitti_io``, ``kitti_dataset``, ``kitti_eval_dataset``,
``kitti_raw_dataset``; their ``read_surround_imgs`` decode through the
port's native decoder, ``selfocc_tpu_torch/native``),
``build_dataset``'s path and override tables,
``utils/openseed_utils.SemTeacher``, ``utils/scenerf_metric.SSCMetrics``
and ``utils/logging_util`` (the KITTI configs with the config test, the
encoder's recipe-option configs and the BEV and density-head recipes,
which ``check_ported`` accepts while it still refuses the options that are
not ported), and these
tests fail as soon as a copy and its original drift apart. Extend them with
each module a later slice copies."""
import ast
import importlib
import dataclasses

import numpy as np
import pytest

from selfocc_tpu.configs import experiments as jexp
from selfocc_tpu.data.synthetic import SyntheticDataset as JSynthetic
from selfocc_tpu.utils.metrics import DepthMetric as JDepthMetric
from selfocc_tpu_torch.configs import experiments as texp
from selfocc_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic
from selfocc_tpu_torch.utils.metrics import DepthMetric as TDepthMetric
from test_torch_port_threads import share_cores_with_xdist_workers

share_cores_with_xdist_workers()


# the encoder's recipe options: visibility compaction, head-shared
# locations, bf16 values and compute, and the TPU gather layouts (bundles)
RECIPE_OPTION_CONFIGS = [
    "tiny_fast", "nuscenes_occ_fast", "nuscenes_occ_fast_bundle",
    "nuscenes_occ_compact", "nuscenes_occ_compact_train",
    "nuscenes_occ_compact_train_bundle", "nuscenes_occ_compact_bf16",
    "nuscenes_occ_compact_pairs", "nuscenes_occ_compact_bundle",
    "nuscenes_occ_compact_bf16_pairs", "nuscenes_novel_depth_bundle",
    "nuscenes_novel_depth_fast_bundle", "kitti_occ_bundle",
    "kitti_novel_depth_bundle", "kitti_novel_depth_fast_bundle"]
# the BEV path and the density head
BEV_DENSITY_CONFIGS = ["nuscenes_occ_bev", "tiny_bev", "nuscenes_occ_density",
                       "tiny_nerfacc"]


@pytest.mark.parametrize("name", ["nuscenes_occ", "tiny", "nuscenes_depth",
                                  "nuscenes_novel_depth", "kitti_occ",
                                  "kitti_novel_depth", "kitti_raw_depth"]
                         + RECIPE_OPTION_CONFIGS + BEV_DENSITY_CONFIGS)
def test_config_copies_equal_their_originals(name):
    ref = dataclasses.asdict(getattr(jexp, name)())
    got = dataclasses.asdict(getattr(texp, name)())
    assert got == ref
    assert dataclasses.asdict(texp.get_config(name)) == ref


@pytest.mark.parametrize("name", RECIPE_OPTION_CONFIGS
                         + BEV_DENSITY_CONFIGS)
def test_recipe_option_configs_are_ported(name):
    from selfocc_tpu_torch.models.segmentor import check_ported
    check_ported(texp.get_config(name).model)


@pytest.mark.parametrize("section,option,value", [
    ("model", "neck_type", "identity"),
    ("model", "backbone_type", "unet2d")])
def test_unported_recipes_are_refused(section, option, value):
    # options that are still not ported, on the JAX package's own configs
    from selfocc_tpu_torch.models.segmentor import check_ported
    cfg = jexp.get_config("tiny").model
    if section == "model":
        cfg = dataclasses.replace(cfg, **{option: value})
    else:
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **{option: value})})
    with pytest.raises(NotImplementedError,
                       match=value if option == "backbone_type" else option):
        check_ported(cfg)


@pytest.mark.parametrize("section,option,value", [
    ("encoder", "camera_aware", True),
    ("model", "lifter_type", "TPVPositionLifter"),
    ("encoder", "multi_plane_ffn_norm", True)])
def test_ported_recipe_options_are_accepted(section, option, value):
    # model options the port implements, set on the JAX package's own
    # configs: check_ported lets them through
    from selfocc_tpu_torch.models.segmentor import check_ported
    cfg = jexp.get_config("tiny").model
    if section == "model":
        cfg = dataclasses.replace(cfg, **{option: value})
    else:
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **{option: value})})
    check_ported(cfg)


def _assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_items_equal(got[k], v)
        elif isinstance(v, str):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(num_cams=2, input_size=(32, 48), img_size=(32, 48), num_classes=5,
         length=3),
    dict(num_cams=6, input_size=(48, 80), img_size=(64, 96), num_classes=17,
         length=4, seed=3)], ids=["tiny", "six-cams"])
def test_synthetic_dataset_copy_equals_its_original(kwargs):
    ref, got = JSynthetic(**kwargs), TSynthetic(**kwargs)
    assert len(got) == len(ref)
    for idx in range(len(ref)):
        _assert_items_equal(got[idx], ref[idx])
    _assert_items_equal(got.occ3d_labels(), ref.occ3d_labels())
    aabb = (-4.0, -4.0, -1.0, 4.0, 4.0, 3.0)
    np.testing.assert_array_equal(got.gt_occupancy(aabb, 0.5),
                                  ref.gt_occupancy(aabb, 0.5))


def test_depth_metric_copy_equals_its_original():
    rng = np.random.RandomState(7)
    names = ["cam0", "cam1", "cam2"]
    metrics = [cls(camera_names=names, eval_types=["raw", "median"])
               for cls in (JDepthMetric, TDepthMetric)]
    for _ in range(3):
        gt = rng.uniform(0.5, 60.0, (3, 200))
        pred = gt * rng.uniform(0.7, 1.4, (3, 200))
        mask = rng.uniform(size=(3, 200)) > 0.2
        mask[2] = False                              # a camera with no hits
        for m in metrics:
            m._after_step(pred, gt, mask)
    ref, got = (m._after_epoch() for m in metrics)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_occupancy_metric_copies_equal_their_originals():
    from selfocc_tpu.utils import metrics as jm
    from selfocc_tpu_torch.utils import metrics as tm
    rng = np.random.RandomState(11)
    np.testing.assert_array_equal(tm.OPENSEED2NUSCENES, jm.OPENSEED2NUSCENES)
    sem = rng.randint(0, 21, (7, 9, 4))
    np.testing.assert_array_equal(tm.openseed2nuscenes(sem),
                                  jm.openseed2nuscenes(sem))
    # MeanIoU on dense grids (with and without a mask) and on Occ3D dict
    # targets (camera mask, z-crop of empty slabs); IoU on voxel indices
    # and on Occ3D targets
    for use_mask in (False, True):
        pair = [cls(list(range(1, 17)), 0, [f"c{i}" for i in range(16)],
                    use_mask, 0, name="miou")
                for cls in (jm.MeanIoU, tm.MeanIoU)]
        occ3d = [cls(list(range(1, 17)), 0, [f"c{i}" for i in range(16)],
                     use_mask, 17) for cls in (jm.MeanIoU, tm.MeanIoU)]
        ious = [cls(use_mask=use_mask) for cls in (jm.IoU, tm.IoU)]
        for _ in range(3):
            pred = rng.randint(0, 17, (20, 20, 16))
            gt = rng.randint(0, 17, (20, 20, 16))
            mask = rng.rand(20, 20, 16) > 0.3
            labels = {"semantics": rng.randint(0, 18, (20, 20, 16)),
                      "mask_camera": mask}
            occ = (rng.rand(20, 20, 16) > 0.5).astype(np.float32)
            idx = np.stack(np.nonzero(gt > 8), -1)
            for m in pair:
                m._after_step(pred, gt, mask if use_mask else None)
            for m in occ3d:
                m._after_step(pred, labels)
            for m in ious:
                m._after_step(occ, idx)
                m._after_step(occ, labels, occ3d=True)
        for ref, got in (pair, occ3d):
            assert got._after_epoch() == ref._after_epoch()
            for k in ("total_seen", "total_correct", "total_positive"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(ref, k))
        assert ious[1]._after_epoch() == ious[0]._after_epoch()


def test_eval_iou_helper_copies_equal_their_originals(tmp_path):
    import eval_iou as jd
    from selfocc_tpu_torch import eval_iou as td
    assert td.OCC3D_SCENES == jd.OCC3D_SCENES
    assert td.OPENOCC_PCR == jd.OPENOCC_PCR
    assert td.NUSC_LABELS == jd.NUSC_LABELS
    rng = np.random.RandomState(12)
    theta = 0.3
    ego2lidar = np.eye(4)
    ego2lidar[:2, :2] = [[np.cos(theta), -np.sin(theta)],
                         [np.sin(theta), np.cos(theta)]]
    ego2lidar[:3, 3] = [0.7, -1.1, 0.4]
    for size in (0, 4):
        pcr, exp = jd.OCC3D_SCENES[size]
        pts = td.occ3d_ego_to_grid_coords(pcr, exp, ego2lidar)
        np.testing.assert_array_equal(
            pts, jd.occ3d_ego_to_grid_coords(pcr, exp, ego2lidar))
        # the port resamples through its own trilinear_sample: the same
        # fp32 interpolant, the same corner order
        for vol in (rng.randn(24, 20, 6).astype(np.float32),
                    rng.randn(24, 20, 6, 3).astype(np.float32)):
            np.testing.assert_allclose(
                td.resample_volume_at(vol, pts, pcr, exp),
                jd.resample_volume_at(vol, pts, pcr, exp), rtol=0, atol=1e-6)
    occ = (rng.rand(200, 200, 16) > 0.5).astype(np.int32)
    np.testing.assert_array_equal(td.apply_occ3d_crops(occ),
                                  jd.apply_occ3d_crops(occ))
    occ = (rng.rand(64, 64, 40) > 0.5).astype(np.int32)
    np.testing.assert_array_equal(td.apply_openocc_crops(occ),
                                  jd.apply_openocc_crops(occ))
    label = np.stack([rng.randint(0, 44, 300), rng.randint(-2, 66, 300),
                      rng.randint(0, 64, 300), rng.randint(1, 17, 300)], 1)
    for cls in (None, label[:, 3]):
        np.testing.assert_array_equal(
            td.openocc_gt_grid(label[:, :3], (64, 64, 40), cls),
            jd.openocc_gt_grid(label[:, :3], (64, 64, 40), cls))
    for cols in (3, 4):
        path = str(tmp_path / f"occupancy{cols}.npy")
        np.save(path, label[:, :cols])
        for got, ref in zip(td.read_openoccupancy_label(path),
                            jd.read_openoccupancy_label(path)):
            np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / "labels.npz")
    np.savez(path, semantics=rng.randint(0, 18, (200, 200, 16)),
             mask_camera=rng.rand(200, 200, 16) > 0.5,
             mask_lidar=rng.rand(200, 200, 16) > 0.5)
    got, ref = td.read_occ3d_label(path), jd.read_occ3d_label(path)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def _code(tree):
    """Top-level functions and classes of a module's AST by name (classes'
    methods by ``Class.method``), docstrings removed, as ``ast.dump``."""
    out = {}

    def strip(node):
        body = getattr(node, "body", None)
        if body and isinstance(body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out[f"{node.name}.{m.name}"] = ast.dump(strip(m))
            node.body = [m for m in node.body
                         if not isinstance(m, ast.FunctionDef)]
            out[node.name] = ast.dump(strip(node))
        elif isinstance(node, (ast.FunctionDef, ast.Assign)):
            key = node.name if isinstance(node, ast.FunctionDef) else \
                ast.dump(node.targets[0])
            out[key] = ast.dump(strip(node))
    return out


def _source_tree(modname):
    mod = importlib.import_module(modname)
    with open(mod.__file__) as f:
        return ast.parse(f.read())


# every function, method, class and module constant equal but these: the
# JAX module's online teacher (not ported), and the scalar writer's
# constructor, which leaves TensorBoard out where TensorFlow is installed
# (TensorFlow imports JAX)
_COPIES = {
    "data.transforms": (), "data.wrapper": (), "data.sampler": (),
    "data.prefetch": (), "data.nuscenes_eval_dataset": (),
    "data.nuscenes_dataset": (),
    "data.semantic_kitti_io": (), "data.kitti_eval_dataset": (),
    "data.kitti_dataset": (),
    "data.kitti_raw_dataset": (),
    "utils.openseed_utils": ("JaxSemTeacher",),
    "utils.scenerf_metric": (),
    "utils.logging_util": ("ScalarWriter.__init__",),
}


@pytest.mark.parametrize("name", sorted(_COPIES))
def test_data_module_copies_equal_their_originals(name):
    ref = _code(_source_tree(f"selfocc_tpu.{name}"))
    got = _code(_source_tree(f"selfocc_tpu_torch.{name}"))
    skip = {k for k in ref if k.split(".")[0] in _COPIES[name]
            or k in _COPIES[name]}
    assert set(got) - skip == set(ref) - skip
    for k in set(got) - skip:
        assert got[k] == ref[k], k


def test_kitti_metric_copies_equal_their_originals():
    from selfocc_tpu.utils import metrics as jm
    from selfocc_tpu.utils.scenerf_metric import SSCMetrics as JSSC
    from selfocc_tpu_torch.utils import metrics as tm
    from selfocc_tpu_torch.utils.scenerf_metric import SSCMetrics as TSSC
    rng = np.random.RandomState(13)
    np.testing.assert_array_equal(tm.CITYSCAPES2SEMANTICKITTI,
                                  jm.CITYSCAPES2SEMANTICKITTI)
    sem = rng.randint(0, 19, (9, 7, 5))
    np.testing.assert_array_equal(tm.cityscapes2semantickitti(sem),
                                  jm.cityscapes2semantickitti(sem))
    x = rng.rand(20)
    np.testing.assert_array_equal(tm._allreduce_sum(x), jm._allreduce_sum(x))
    metrics = [JSSC(n_classes=20), TSSC(n_classes=20)]
    for _ in range(3):
        pred = rng.randint(0, 20, (1, 16, 16, 4))
        gt = rng.randint(0, 20, (1, 16, 16, 4))
        gt[rng.rand(*gt.shape) < 0.1] = 255
        nonempty = rng.rand(*gt.shape) > 0.2
        for m in metrics:
            m.add_batch(pred, gt)
            m.add_batch(pred, gt, nonempty=nonempty)
    ref, got = (m.get_stats() for m in metrics)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _surround_cases():
    """The three training loaders' ``read_surround_imgs`` in both packages,
    each with a stand-in ``self`` and its crop arguments."""
    import types
    from selfocc_tpu.data import kitti_dataset as jk
    from selfocc_tpu.data import kitti_raw_dataset as jr
    from selfocc_tpu.data import nuscenes_dataset as jn
    from selfocc_tpu_torch.data import kitti_dataset as tk
    from selfocc_tpu_torch.data import kitti_raw_dataset as tr
    from selfocc_tpu_torch.data import nuscenes_dataset as tn
    hw = types.SimpleNamespace(img_H=32, img_W=48)
    return {"nuscenes": (jn.nuScenes_One_Frame_Sweeps_Dist,
                         tn.nuScenes_One_Frame_Sweeps_Dist, None, (32, 48)),
            "kitti": (jk.Kitti_One_Frame, tk.Kitti_One_Frame, hw),
            "kitti_raw": (jr.Kitti_Raw_Stereo, tr.Kitti_Raw_Stereo, hw)}


@pytest.mark.parametrize("loader", ["nuscenes", "kitti", "kitti_raw"])
def test_read_surround_imgs_native_as_jax_and_cv2_without_it(
        tmp_path, monkeypatch, loader):
    # the port's loaders decode through its own native decoder: bit for bit
    # the JAX loaders' (native on both sides, one source), JPEG and PNG;
    # with no native library, cv2's decode exactly
    import cv2
    from selfocc_tpu.native import native_available as jax_native
    from selfocc_tpu_torch import native
    J, T, this, *crop = _surround_cases()[loader]
    assert native.native_available() and jax_native(), \
        native.native_status()
    rng = np.random.RandomState(4)
    paths = []
    for i, ext in enumerate((".jpg", ".png", ".jpg")):
        paths.append(str(tmp_path / f"cam{i}{ext}"))
        cv2.imwrite(paths[-1], (rng.rand(40, 56, 3) * 255).astype(np.uint8))
    got = T.read_surround_imgs(this, paths, *crop)
    ref = J.read_surround_imgs(this, paths, *crop)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    monkeypatch.setattr(native, "get_shared_loader", lambda: None)
    got = T.read_surround_imgs(this, paths, *crop)
    for p, g in zip(paths, got):
        ref = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32)
        np.testing.assert_array_equal(g, ref[:32, :48])


def test_build_dataset_tables_equal_their_originals():
    import selfocc_tpu.data as jdata
    import selfocc_tpu_torch.data as tdata
    assert tdata.DEFAULT_PATHS == jdata.DEFAULT_PATHS
    assert tdata.EVAL_OVERRIDES == jdata.EVAL_OVERRIDES
