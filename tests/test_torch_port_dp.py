"""The port's data-parallel training and sharded eval against the JAX
package on the CPU: two gloo ranks (``parallel.mesh.spawn``, a file store
in a temporary directory, no network) each take one of two ``tiny`` items
and are held to ``make_dp_train_step`` on a two-device mesh of the 8 CPU
devices ``tests/conftest.py`` forces (losses and ``total`` rtol 1e-5, the
averaged gradients 1e-4 of their max + 1e-7, ``grad_norm`` rtol 1e-4, as
``test_torch_port_train.py``); the ranks end bit-equal; a ResNet
bottleneck's BatchNorm statistics are averaged as flax's ``pmean(new_bs)``;
the driver's item groups are the JAX driver's; the eval's render,
occupancy query and camera-sharded prepare on two devices equal one
device's and agree with the JAX mesh's; ``train --dp`` runs two gloo
ranks and ``--mp`` with one rank the plain step.

The JAX step's optimizer is replaced by one that keeps the gradients it is
given as its state (``keep_grads``), so that the one DP compile returns
the averaged gradients as well as the metrics.
"""
import os
import subprocess
import sys
import types

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.sampler import DistributedSampler as JSampler
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.resnet import Bottleneck as JBottleneck
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.parallel.mesh import DATA_AXIS, make_mesh
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import train as tdriver
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.data.sampler import DistributedSampler
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.parallel import mesh
from selfocc_tpu_torch.utils import eval_lib as teval
from test_torch_port_threads import share_cores_with_xdist_workers
from test_torch_port_train import (assert_grad_close, jax_draws, no_dropout,
                                   perturb)
from torch_port_dp_ranks import dp_step
from torch_port_jax import QUICK_COMPILE, memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
OUTPUTS = ("depth", "rgb", "acc", "sem")


def keep_grads():
    """An optax transformation whose state is the last gradients it was
    given and whose updates are zero."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


def bottleneck_state(np_vars):
    """The port's ``Bottleneck`` state dict of flax bottleneck variables
    (as ``test_torch_port_train.py``'s BatchNorm test maps them)."""
    sd = {}
    for name in ("conv1", "conv2", "conv3", "ds_conv"):
        key = "downsample.0" if name == "ds_conv" else name
        sd[f"{key}.weight"] = T(np.ascontiguousarray(np.transpose(
            np_vars["params"][name]["kernel"], (3, 2, 0, 1))))
    for name in ("bn1", "bn2", "bn3", "ds_bn"):
        key = "downsample.1" if name == "ds_bn" else name
        p, s = np_vars["params"][name], np_vars["batch_stats"][name]
        sd[f"{key}.weight"] = T(np.array(p["scale"]))
        sd[f"{key}.bias"] = T(np.array(p["bias"]))
        sd[f"{key}.running_mean"] = T(np.array(s["mean"]))
        sd[f"{key}.running_var"] = T(np.array(s["var"]))
    return sd


@pytest.fixture(scope="module")
def dp_run():
    """One two-device JAX DP step of ``tiny`` (dropout 0) on two distinct
    items and the flax bottleneck's ``pmean(new_bs)``, and the same on two
    spawned gloo ranks of the port."""
    cfg = no_dropout(jget_config("tiny"))
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=2)
    items = [{k: np.asarray(v) for k, v in ds[i].items()
              if not isinstance(v, (str, dict))} for i in range(2)]
    assert not np.array_equal(items[0]["imgs"], items[1]["imgs"])
    jmodel = JSegmentor(cfg=cfg.model)
    variables = jeval.init_variables(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in items[0].items()})
    np_params = perturb(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]),
                        np.random.RandomState(0))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tx = keep_grads()
    # the step donates its state: a copy of the consts, which the memoised
    # init shares with the other modules of this process
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats={}, opt_state=tx.init(params),
                              tx=tx, consts=jax.tree_util.tree_map(
                                  jnp.copy, variables["consts"]))
    stacked = {k: np.stack([it[k] for it in items]) for k in items[0]}
    rngs = jax.random.split(jax.random.PRNGKey(3), 2)
    two = make_mesh(jax.devices()[:2])
    step = jtrain.make_dp_train_step(jmodel, cfg, two)
    new_state, metrics = step.lower(state, stacked, rngs).compile(
        QUICK_COMPILE)(state, stacked, rngs)
    jres = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": from_jax_variables({"params": jax.tree_util.tree_map(
                np.asarray, new_state.opt_state)})}

    rng = np.random.RandomState(6)
    jblk = JBottleneck(planes=8, stride=2, downsample=True)
    xs = [rng.randn(2, 9, 11, 16).astype(np.float32) for _ in range(2)]
    bvars = jblk.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), True)
    np_bvars = {"params": perturb(jax.tree_util.tree_map(
        np.asarray, bvars["params"]), rng)}
    np_bvars["batch_stats"] = jax.tree_util.tree_map(
        lambda s: np.asarray(s) + 0.1 * np.abs(rng.randn(*s.shape)).astype(
            np.float32), bvars["batch_stats"])

    def new_stats(x):
        _, mutated = jblk.apply(np_bvars, x[0], True, mutable=["batch_stats"])
        return jax.lax.pmean(mutated["batch_stats"], DATA_AXIS)
    jstats = jax.jit(jax.shard_map(new_stats, mesh=two, in_specs=P(DATA_AXIS),
                                   out_specs=P(), check_vma=False))(
        np.stack(xs))

    tcfg = no_dropout(get_config("tiny"))
    sd = from_jax_variables({"params": np_params})
    draws = [jax_draws(k, cfg) for k in rngs]
    blk_inputs = [(np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
                   rng.randn(2, 32, 5, 6).astype(np.float32)) for x in xs]
    threads = max(1, torch.get_num_threads() // 2)
    ranks = mesh.spawn(dp_step, 2, "gloo", ["cpu", "cpu"],
                       args=(tcfg, sd, items, draws,
                             bottleneck_state(np_bvars), blk_inputs,
                             threads))
    return {"jax": jres, "ranks": ranks, "jstats": jstats}


def test_dp_step_losses_match_jax(dp_run):
    ref = dp_run["jax"]["metrics"]
    for r in dp_run["ranks"]:
        got = r["metrics"]
        assert set(ref) <= set(got), (set(ref), set(got))
        for k in ref:
            if k == "grad_norm":
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4)
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           err_msg=k)


def test_dp_step_averaged_gradients_match_jax(dp_run):
    ref = dp_run["jax"]["grads"]
    for r in dp_run["ranks"]:
        assert set(r["grads"]) == set(ref)
        for name, g in ref.items():
            assert_grad_close(r["grads"][name].numpy(), g.numpy(), name)


def test_dp_ranks_end_bit_equal(dp_run):
    a, b = (r["params"] for r in dp_run["ranks"])
    assert a and set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    # both took the same averaged gradients
    g0, g1 = (r["grads"] for r in dp_run["ranks"])
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_dp_batchnorm_statistics_are_the_ranks_mean(dp_run):
    ranks = dp_run["ranks"]
    jstats = dp_run["jstats"]
    names = {"downsample.1": "ds_bn"}
    for key, avg in ranks[0]["bn_avg"].items():
        module, buf = key.rsplit(".", 1)
        mean = (ranks[0]["bn_own"][key] + ranks[1]["bn_own"][key]) / 2
        assert not torch.equal(ranks[0]["bn_own"][key],
                               ranks[1]["bn_own"][key]), key
        assert torch.equal(avg, mean), key
        assert torch.equal(ranks[1]["bn_avg"][key], avg), key
        ref = jstats[names.get(module, module)][
            "mean" if buf == "running_mean" else "var"]
        np.testing.assert_allclose(avg.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_dp_gradients_present_on_some_ranks_only(dp_run):
    # a parameter with a gradient on rank 0 only takes zeros on rank 1 (the
    # mean is half rank 0's), one with a gradient on no rank stays None
    x0, x1 = torch.arange(3.0), torch.arange(3.0) + 10
    for r in dp_run["ranks"]:
        g = r["toy_grads"]
        assert torch.equal(g["a"], x0 / 2)
        assert torch.equal(g["b"], (x0 + x1) / 2)
        assert g["c"] is None


def test_one_rank_group_is_the_plain_step():
    cfg = no_dropout(get_config("tiny"))
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    batch = {k: T(np.asarray(v)) for k, v in ds[0].items()
             if not isinstance(v, (str, dict))}
    one = mesh.Group(0, 1, torch.device("cpu"), "gloo", None)
    out = []
    for group in (None, one):
        trainer = tdriver.build_trainer(cfg, 7, "cpu", group=group)
        m = trainer.step(batch, torch.Generator().manual_seed(5))
        out.append((m, dict(trainer.model.named_parameters())))
    (m0, p0), (m1, p1) = out
    assert "all_reduce_s" not in m1["times"]
    for k in m0:
        if k != "times":
            assert float(m0[k]) == float(m1[k]), k
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def jax_item_groups(order, n_dev):
    """The JAX driver's step groups (``train.py:243-250``, ``use_dp``)."""
    groups, j = [], 0
    while j < len(order):
        groups.append([int(order[(j + k) % len(order)])
                       for k in range(n_dev)])
        j += n_dev
    return groups


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("world", [2, 3])
def test_item_groups_match_jax(offset, world):
    n, seed, epoch = 11, 5, 2
    orders = []
    for Sampler in (JSampler, DistributedSampler):
        s = Sampler(n, 1, 0, shuffle=True, seed=seed)
        s.set_epoch(epoch)
        s.set_last_iter(offset)
        orders.append(list(iter(s)))
    assert orders[0] == orders[1] and len(orders[0]) == n - offset
    assert tdriver.item_groups(orders[1], world) == \
        jax_item_groups(orders[0], world)
    assert tdriver.item_groups(orders[1], 1) == [[i] for i in orders[1]]


@pytest.mark.parametrize("start_pos", [0, 4])
def test_train_gives_each_rank_its_item(monkeypatch, start_pos):
    # rank r of 2 steps on the r-th item of each group of the shared
    # order; a step moves the epoch position on by 2, so the final
    # checkpoint records the items consumed
    class FakeTrainer:
        global_step = 0

        def step(self, batch, generator, *args, **kwargs):
            self.global_step += 1
            return {"total": torch.tensor(1.0), "times": {}}

    lines, saved, barriers = [], [], []
    logger = types.SimpleNamespace(info=lines.append)
    monkeypatch.setattr(tdriver, "to_device", lambda item, dev: item)
    cfg = get_config("tiny")
    ds = [{"x": i} for i in range(9)]
    s = DistributedSampler(9, 1, 0, shuffle=True, seed=3)
    s.set_last_iter(start_pos)
    groups = tdriver.item_groups(list(iter(s)), 2)
    for rank in (0, 1):
        group = types.SimpleNamespace(
            world=2, rank=rank, barrier=lambda: barriers.append(rank))
        res = tdriver.train(cfg, FakeTrainer(), ds, torch.device("cpu"), 2,
                            3, 1, logger, start_pos=start_pos,
                            checkpoint=lambda *a: saved.append(a),
                            group=group)
        assert res["items"] == [g[rank] for g in groups[:2]]
        assert saved[-1] == ("final", 0, start_pos + 4)
    assert barriers == [0, 1]
    assert len(lines) == 2              # rank 0's steps only


@pytest.fixture(scope="module")
def frame():
    cfg = jget_config("tiny")
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size,
                          num_classes=max(cfg.num_classes,
                                          cfg.model.head.sem_dims),
                          length=1)
    batch = {k: np.asarray(v) for k, v in ds[0].items()
             if not isinstance(v, (str, dict))}
    jmodel = JSegmentor(cfg=cfg.model)
    variables = jeval.init_variables(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = perturb(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]),
                        np.random.RandomState(0))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, np_params),
                 "consts": variables["consts"]}
    tmodel = TPVSegmentor(get_config("tiny").model).eval()
    tmodel.load_state_dict(from_jax_variables({"params": np_params}),
                           strict=True)
    origin, direction = teval.rays_for_cams(
        T(teval.eval_trans_mats(batch, cfg)), teval.eval_ray_grid(cfg))
    return cfg, batch, jmodel, variables, tmodel, origin, direction


AABB, RESOLUTION = [-10.0, -10.0, -1.0, 10.0, 10.0, 3.0], 1.0


def sharded_frame(tmodel, batch, origin, direction, devices):
    """prepare (camera-sharded where ``devices`` are several), render and
    the gather occupancy query on ``devices``."""
    tr = teval.ChunkedRenderer(tmodel, chunk=96, outputs=OUTPUTS,
                               devices=devices, prepare_shard=True)
    volume = tr.prepare(T(batch["imgs"]), T(batch["lidar2img"]))
    ev = teval.GridOccEvaluator(tmodel, devices=devices, prepare_shard=True)
    return (volume, tr.render(volume, origin, direction),
            ev.query_grid(volume, AABB, RESOLUTION))


def test_sharded_eval_equals_one_device(frame):
    cfg, batch, _, _, tmodel, origin, direction = frame
    v1, r1, g1 = sharded_frame(tmodel, batch, origin, direction, None)
    v2, r2, g2 = sharded_frame(tmodel, batch, origin, direction,
                               ["cpu", "cpu"])
    scale = float(v1.abs().max())
    assert float((v2 - v1).abs().max()) <= 1e-6 * scale
    # the render and the query against one volume: each ray's and each
    # point's arithmetic is the one-device path's, bit for bit
    r2b = teval.ChunkedRenderer(tmodel, chunk=96, outputs=OUTPUTS,
                                devices=["cpu", "cpu"]).render(
        v1, origin, direction)
    g2b = teval.GridOccEvaluator(tmodel, devices=["cpu", "cpu"]).query_grid(
        v1, AABB, RESOLUTION)
    assert set(r2b) == set(r1) == set(OUTPUTS)
    for k in r1:
        np.testing.assert_array_equal(r2b[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r2[k], r1[k], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r1[k]).max()))
    assert set(g2b) == set(g1) == {"sdf", "sem", "logits", "xyz"}
    for k in g1:
        np.testing.assert_array_equal(g2b[k], g1[k], err_msg=k)
    np.testing.assert_allclose(g2["sdf"], g1["sdf"], rtol=0,
                               atol=1e-6 * float(np.abs(g1["sdf"]).max()))


def test_sharded_eval_matches_jax_mesh(frame):
    cfg, batch, jmodel, variables, tmodel, origin, direction = frame
    assert len(jax.devices()) == 8
    jr = jeval.ChunkedRenderer(jmodel, variables, chunk=96, shard=True,
                               volume_dtype="float32", outputs=OUTPUTS,
                               prepare_shard=True)
    assert jr.prepare_shard
    jvol = jr.prepare(jnp.asarray(batch["imgs"]),
                      jnp.asarray(batch["lidar2img"]))
    ref = jr.render(jvol, jnp.asarray(origin.numpy()),
                    jnp.asarray(direction.numpy()))
    jev = jeval.GridOccEvaluator(jmodel, variables, shard=True)
    assert jev.n_shard == 8
    jgrid = jev.query_grid(jvol, AABB, RESOLUTION)
    volume, got, grid = sharded_frame(tmodel, batch, origin, direction,
                                      ["cpu", "cpu"])
    # the port's frame tolerances (test_torch_port_slice.py,
    # test_torch_port_occ.py): the volume atol 1e-4, depth rtol 1e-4,
    # composites and the grid's sdf and logits atol 1e-4
    np.testing.assert_allclose(volume.numpy(), np.asarray(jvol), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["depth"], ref["depth"], rtol=1e-4,
                               atol=1e-5)
    for k in ("rgb", "acc", "sem"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    for k in ("sdf", "logits"):
        np.testing.assert_allclose(grid[k], jgrid[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(grid["xyz"], jgrid["xyz"], rtol=0,
                               atol=1e-5 * float(np.abs(jgrid["xyz"]).max()))
    top = np.sort(jgrid["logits"], axis=-1)
    flips = grid["sem"] != jgrid["sem"]
    assert (top[..., -1] - top[..., -2])[flips].max(initial=0.0) < 1e-3


def test_split_rows_is_contiguous_and_even():
    for n, parts in ((10, 3), (2, 4), (96, 2), (0, 2)):
        rows = mesh.split_rows(n, parts)
        assert len(rows) == parts and rows[0][0] == 0 and rows[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        sizes = [b - a for a, b in rows]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_train_main_dp_runs_two_gloo_ranks(tmp_path, monkeypatch):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // 2)))
    base = [sys.executable, "-m", "selfocc_tpu_torch.train", "--py-config",
            "tiny", "--synthetic", "--device", "cpu", "--print-freq", "1",
            "--max-steps", "2", "--work-dir", str(tmp_path)]
    proc = subprocess.run(base + ["--dp", "--dp-ranks", "2"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "data-parallel: 2 ranks over gloo" in proc.stdout
    assert "all 2 ranks hold rank 0's parameters" in proc.stdout
    assert proc.stdout.count("[e0 i") == 2        # rank 0 logs, alone
    state = torch.load(tmp_path / "ckpts" / "latest.pt", map_location="cpu")
    assert state["step"] == 2 and state["last_iter"] == 4
    # --mp with one rank (no --dp-ranks on the CPU) is the plain step, as
    # the JAX driver's with one device (test_torch_port_mp.py: two ranks)
    proc = subprocess.run(base + ["--mp", "--work-dir", str(tmp_path / "mp")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--mp with one device: the plain step" in proc.stdout
    assert "model-parallel" not in proc.stdout
    state = torch.load(tmp_path / "mp" / "ckpts" / "latest.pt",
                       map_location="cpu")
    assert state["step"] == 2 and state["last_iter"] == 2
    # on cards --dp takes one card a rank: more ranks than cards exit
    monkeypatch.setattr(tdriver, "resolve_device", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exit_:
        tdriver.dp_plan(tdriver.parse_args(["--py-config", "tiny", "--dp",
                                            "--dp-ranks", "2"]))
    assert "one rank per card" in str(exit_.value)
    assert tdriver.dp_plan(tdriver.parse_args(
        ["--py-config", "tiny", "--dp"])) == (1, "nccl", ["cuda:0"])
