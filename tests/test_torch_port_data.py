"""The port's data path against the JAX package's on the CPU: both
packages' ``build_dataset`` items on fabricated nuScenes-format datasets
(the JAX tests' own fixtures: ``_make_mini_nuscenes`` for the train / val
sweeps split, ``make_nuscenes_eval_fixture`` for the novel-view split),
the ``DistributedSampler`` orders, ``BatchPrefetcher`` against a plain
loop, and the drivers' refusal to run without data.

Every comparison is exact (``np.array_equal``): the port's loaders are
copies, so the same files and the same seeds of Python's and numpy's
global generators before each item give the same bits."""
import dataclasses
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data import build_dataset as jbuild
from selfocc_tpu.data.prefetch import BatchPrefetcher as JPrefetcher
from selfocc_tpu.data.sampler import DistributedSampler as JSampler
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.data import build_dataset
from selfocc_tpu_torch.data.prefetch import BatchPrefetcher
from selfocc_tpu_torch.data.sampler import DistributedSampler
from selfocc_tpu_torch.utils.runtime import get_dataset

from test_novel_eval_datasets import make_nuscenes_eval_fixture
from test_nuscenes_dataset import _make_mini_nuscenes
from test_torch_port_threads import share_cores_with_xdist_workers

share_cores_with_xdist_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nusc_cfg(get, name, data_path, pkl, wrapper_args=None, **extra):
    """``name`` with the dataset args of a fabricated sweeps split (64 x 96
    images, a 5 m neighbour window over its 2 m steps)."""
    cfg = get(name)
    local = dict(data_path=data_path, imageset=pkl, crop_size=[64, 96],
                 min_dist=0.4, max_dist=5.0, **extra)
    return dataclasses.replace(
        cfg, train_dataset_args=dict(cfg.train_dataset_args, **local),
        val_dataset_args=dict(cfg.val_dataset_args, **local),
        wrapper_args=dict(cfg.wrapper_args, **(wrapper_args or {})))


def write_sem_maps(data_path, num_classes, shape=(64, 96), seed=0):
    """Offline teacher maps (``wrapper_args=dict(sem_from=DIR)``) for every
    image of a ``_make_mini_nuscenes`` split: ``<DIR>/<image name>.npy``."""
    sem_dir = os.path.join(data_path, "sem")
    os.makedirs(sem_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in sorted(os.listdir(os.path.join(data_path, "samples"))):
        if name.endswith(".jpg"):
            np.save(os.path.join(sem_dir, name + ".npy"),
                    rng.randint(0, num_classes, shape).astype(np.uint8))
    return sem_dir


def novel_cfg(get, name, root, pkl):
    cfg = get(name)
    return dataclasses.replace(cfg, val_dataset_args=dict(
        cfg.val_dataset_args, data_path=root, imageset=pkl,
        crop_size=[64, 96]))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweeps")
    data_path, pkl, roots = _make_mini_nuscenes(
        tmp, with_lidar=True, with_occ3d=True, with_openocc=True)
    roots["wrapper_args"] = dict(sem_from=write_sem_maps(data_path, 21),
                                 sem_apply_lut=True)
    return data_path, pkl, roots


@pytest.fixture(scope="module")
def temporal(tmp_path_factory):
    return make_nuscenes_eval_fixture(tmp_path_factory.mktemp("temporal"),
                                      n_frames=4, num_cams=2)


def seeded(ds, i, seed):
    random.seed(seed)
    np.random.seed(seed)
    return ds[i]


def assert_same(got, ref, where=""):
    """Nested items (dicts, lists, tuples of arrays and strings) equal."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), where
        for k in ref:
            assert_same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, str):
        assert got == ref, where
    else:
        g, r = np.asarray(got), np.asarray(ref)
        assert g.dtype == r.dtype and np.array_equal(g, r), where


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("name", ["nuscenes_occ", "nuscenes_novel_depth"])
def test_sweeps_items_equal_the_jax_items(sweeps, phase, name):
    # nuscenes_occ with the offline teacher maps (sem_gt, remapped to
    # nuScenes classes), nuscenes_novel_depth without
    data_path, pkl, roots = sweeps
    if name != "nuscenes_occ":
        roots = {k: v for k, v in roots.items() if k != "wrapper_args"}
    ref = jbuild(nusc_cfg(jget_config, name, data_path, pkl, **roots), phase)
    got = build_dataset(nusc_cfg(get_config, name, data_path, pkl, **roots),
                        phase)
    assert type(got).__name__ == type(ref).__name__ == \
        "TemporalDatasetWrapper"
    assert len(got) == len(ref) == 6
    for i in range(len(ref)):
        for seed in (i, 100 + i):
            item = seeded(got, i, seed)
            assert_same(item, seeded(ref, i, seed), f"{phase}[{i}]")
    # the val split carries the lidar depth GT and both label paths
    keys = {"occ3d_label_path", "openocc_label_path", "imgs", "temImg2lidar"}
    if name == "nuscenes_occ":
        keys.add("sem_gt")
        assert item["sem_gt"].shape == (1, 6, 64, 96)
        assert item["sem_gt"].max() <= 16
    if phase == "val":
        keys |= {"depth_loc", "depth_gt", "depth_mask"}
    assert keys <= set(item)


def test_novel_eval_items_equal_the_jax_items(temporal):
    root, pkl = temporal
    ref = jbuild(novel_cfg(jget_config, "nuscenes_novel_depth", root, pkl),
                 "novel_eval")
    got = build_dataset(novel_cfg(get_config, "nuscenes_novel_depth", root,
                                  pkl), "novel_eval")
    assert type(got).__name__ == "nuScenes_One_Frame_Eval"
    assert len(got) == len(ref) == 4
    for i in range(len(ref)):
        assert_same(seeded(got, i, i), seeded(ref, i, i), f"novel[{i}]")
    _, anchors, metas = got[1]
    assert len(anchors) == len(metas["temImg2lidars"]) == 2
    assert sum(int(np.asarray(m).sum()) for m in metas["depth_mask"][0]) > 0


@pytest.mark.parametrize("n,replicas", [(7, 1), (10, 1), (11, 3)])
@pytest.mark.parametrize("last_iter", [0, 3])
def test_sampler_orders_equal_the_jax_orders(n, replicas, last_iter):
    for rank in range(replicas):
        for shuffle in (True, False):
            ours = DistributedSampler(n, replicas, rank, shuffle=shuffle,
                                      seed=5)
            ref = JSampler(n, replicas, rank, shuffle=shuffle, seed=5)
            for epoch in range(3):
                for s in (ours, ref):
                    s.set_epoch(epoch)
                    s.set_last_iter(last_iter)
                assert len(ours) == len(ref)
                n_left = len(ref)
                order = list(iter(ours))
                assert order == list(iter(ref)) and len(order) == n_left
                # set_last_iter holds for one pass only
                assert list(iter(ours)) == list(iter(ref))
    # one replica, shuffled: the order train.py had before the sampler
    s = DistributedSampler(n, 1, 0, shuffle=True, seed=5)
    s.set_epoch(2)
    assert list(iter(s)) == np.random.RandomState(7).permutation(n).tolist()


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetcher_yields_the_plain_loop(depth):
    rng = np.random.RandomState(depth)
    delays = rng.uniform(0, 2e-3, 25)
    workers = set()

    def build(i):
        workers.add(threading.get_ident())
        time.sleep(delays[i])
        return {"i": i, "x": np.full((3, 4), i * 1.5)}

    items = list(rng.permutation(25))
    plain = [build(i) for i in items]
    for cls in (BatchPrefetcher, JPrefetcher):
        got = list(cls(build, items, depth=depth))
        assert len(got) == len(plain)
        for g, p in zip(got, plain):
            assert g["i"] == p["i"] and np.array_equal(g["x"], p["x"])
    assert len(workers) > 1            # built off the consuming thread


def test_prefetcher_raises_the_workers_error_and_stops_on_close():
    def build(i):
        if i == 3:
            raise ValueError("item 3")
        return i

    it = BatchPrefetcher(build, range(6), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="item 3"):
        next(it)
    it = BatchPrefetcher(lambda i: i, range(100), depth=2)
    assert next(it) == 0
    it.close()
    with pytest.raises(StopIteration):
        next(it)
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


def test_get_dataset_phases_read_the_loaders(sweeps, temporal):
    data_path, pkl, _ = sweeps
    cfg = nusc_cfg(get_config, "nuscenes_occ", data_path, pkl)
    assert get_dataset(cfg, False, "train").dataset.strict is True
    val = get_dataset(cfg, False, "val").dataset
    assert (val.strict, val.cur_prob, val.return_depth) == (False, 1.0, True)
    root, tpkl = temporal
    novel = get_dataset(novel_cfg(get_config, "nuscenes_novel_depth", root,
                                  tpkl), False, "novel_eval")
    assert len(novel) == 4


@pytest.mark.parametrize("phase,path", [
    ("train", "data/nuscenes_infos_train_sweeps.pkl"),
    ("val", "data/nuscenes_infos_val_sweeps.pkl"),
    ("novel_eval", "data/nuscenes_infos_val_temporal_v2.pkl")])
def test_missing_data_exits_naming_the_path(tmp_path, monkeypatch, phase,
                                            path):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        get_dataset(get_config("nuscenes_occ"), False, phase)
    assert path in str(e.value) and "--synthetic" in str(e.value)


@pytest.mark.parametrize("dtype", ["Kitti_One_Frame", "Kitti_Raw",
                                   "Kitti_Raw_Stereo"])
def test_kitti_is_not_ported(tmp_path, monkeypatch, dtype):
    # SemanticKITTI (Kitti_One_Frame) and KITTI-raw (Kitti_Raw and
    # Kitti_Raw_Stereo) are ported. Without SemanticKITTI's odometry tree
    # every phase raises FileNotFoundError naming <data_path>/dataset, and
    # the drivers exit naming it. Without a KITTI-raw split file train and
    # val raise FileNotFoundError naming the split file, as the JAX
    # factory does (tiny has no split_path: the probe gets ""), and
    # novel_eval raises FileNotFoundError (KITTI-raw has no novel-view
    # eval dataset); the drivers exit
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(get_config("tiny"), dataset_type=dtype)
    for phase in ("train", "val", "novel_eval"):
        if dtype == "Kitti_One_Frame":
            with pytest.raises(FileNotFoundError, match="data/kitti/dataset"):
                build_dataset(cfg, phase)
            with pytest.raises(SystemExit, match="data/kitti/dataset"):
                get_dataset(cfg, False, phase)
            continue
        what = "dataset index" if phase == "novel_eval" else \
            "KITTI-raw split file"
        for pkg in (jbuild, build_dataset):
            with pytest.raises(FileNotFoundError, match=what):
                pkg(cfg, phase)
        with pytest.raises(SystemExit, match=what):
            get_dataset(cfg, False, phase)
    if dtype == "Kitti_Raw_Stereo":
        # the recipe names its eigen split file
        want = "data/kitti_raw/splits/eigen_zhou/train_files.txt"
        with pytest.raises(FileNotFoundError, match=want):
            build_dataset(get_config("kitti_raw_depth"), "train")
        with pytest.raises(SystemExit, match=want):
            get_dataset(get_config("kitti_raw_depth"), False, "train")


@pytest.mark.parametrize("module", ["train", "eval_depth", "eval_iou",
                                    "eval_novel_depth", "eval_iou_kitti",
                                    "eval_novel_depth_kitti"])
def test_drivers_without_data_exit_naming_the_path(tmp_path, module):
    # no --synthetic and no files: a non-zero exit that names the index
    # (nuScenes) or the odometry tree (the KITTI drivers, on their default
    # configs) the loader looked for, and no synthetic run
    env = dict(os.environ, PYTHONPATH=REPO)
    flag = "--max-steps" if module == "train" else "--num-samples"
    kitti = module.endswith("_kitti")
    proc = subprocess.run(
        [sys.executable, "-m", f"selfocc_tpu_torch.{module}", flag, "1",
         "--device", "cpu"] + ([] if kitti else ["--py-config", "tiny"]),
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    want = {"train": "train_sweeps", "eval_novel_depth": "val_temporal_v2"}.get(
        module, "val_sweeps")
    want = "data/kitti/dataset" if kitti else f"data/nuscenes_infos_{want}.pkl"
    assert proc.returncode != 0
    assert want in proc.stderr, proc.stderr
    assert "rendered" not in proc.stdout and "[e0 i0]" not in proc.stdout
