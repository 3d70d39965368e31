"""The port's model-parallel step (``train --mp``) against the JAX package
on the CPU. Two gloo ranks (``parallel.mesh.spawn``, a file store in a
temporary directory, no network) take one ``tiny`` item together, the TPV
encoder's query rows sharded over them, and are held to
``make_mp_train_step`` on a two-device ``make_model_mesh`` of the 8 CPU
devices ``tests/conftest.py`` forces: losses and ``total`` rtol 1e-5, the
summed gradients 1e-4 of their max + 1e-7, ``grad_norm`` rtol 1e-4, the
updated parameters atol 2e-5, rtol 1e-4 (``tests/test_train_lib.py``'s
model-parallel check). Against the port's one-process step, at the same
tolerances: three ranks, the compacted cross-attention, dropout at p =
0.1 and the BEV encoder (which runs whole on every rank). In every case
the ranks end bit-equal. ``gather_rows`` forward and backward on both
routes over uneven shards; a one-rank group's step is the plain step bit
for bit; ``train --mp`` over two gloo ranks.

The JAX step's optimizer is wrapped in one that also keeps the gradients
it is given in its state (``keeping_grads``), so that one compile of the
JAX step (``jstep`` of ``make_mp_train_step``, compiled with
``QUICK_COMPILE`` under the model mesh) returns the gradients as well as
the updated parameters and the metrics.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.parallel.mesh import make_model_mesh
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.initializers import init_weights
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.parallel import mesh
from test_torch_port_threads import share_cores_with_xdist_workers
from test_torch_port_train import (assert_grad_close, jax_draws, no_dropout,
                                   perturb)
from torch_port_jax import QUICK_COMPILE, memoised_jax_init  # noqa: F401
from torch_port_mp_ranks import (GATHER_SIZES, GATHER_WIDTH, mp_ranks,
                                 one_step)

share_cores_with_xdist_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11                     # the port cases' generator
COMPACT = (0.3, 0.75, 0.7)    # nuscenes_occ_compact_train's capacities
ROUTES = mesh.ROUTES


def keeping_grads(tx):
    """``tx`` whose state also keeps the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


def closure_cell(fn, name):
    """The value of ``fn``'s closure variable ``name``."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def item_of(cfg):
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    return {k: np.asarray(v) for k, v in ds[0].items()
            if not isinstance(v, (str, dict))}


def compact(cfg):
    enc = dataclasses.replace(cfg.model.encoder,
                              cross_visible_capacity=COMPACT)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              encoder=enc))


def port_weights(cfg, seed=7):
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


@pytest.fixture(scope="module")
def tiny_case():
    """The ``tiny`` item and perturbed JAX weights (dropout 0), the JAX
    model-parallel step on a two-device model mesh and its head draws."""
    cfg = no_dropout(jget_config("tiny"))
    item = item_of(cfg)
    jmodel = JSegmentor(cfg=cfg.model)
    batch = {k: jnp.asarray(v) for k, v in item.items()}
    variables = jeval.init_variables(jmodel, cfg, batch)
    np_params = perturb(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]),
                        np.random.RandomState(0))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tx = keeping_grads(jtrain.make_optimizer(cfg)[0])
    # the step donates its state: a copy of the consts, which the memoised
    # init shares with the other modules of this process
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats={}, opt_state=tx.init(params),
                              tx=tx, consts=jax.tree_util.tree_map(
                                  jnp.copy, variables["consts"]))
    model_mesh = make_model_mesh(jax.devices()[:2])
    jstep = closure_cell(jtrain.make_mp_train_step(jmodel, cfg, model_mesh),
                         "jstep")
    rng = jax.random.PRNGKey(3)
    with jax.sharding.set_mesh(model_mesh):
        new_state, metrics = jstep.lower(state, batch, rng).compile(
            QUICK_COMPILE)(state, batch, rng)
    tree = jax.tree_util.tree_map(np.asarray, new_state)
    return {"item": item, "draws": jax_draws(rng, cfg),
            "sd": from_jax_variables({"params": np_params}),
            "jax": {"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": from_jax_variables({"params":
                                                 tree.opt_state[1]}),
                    "params": from_jax_variables({"params": tree.params})}}


@pytest.fixture(scope="module")
def port_cases(tiny_case):
    """name -> (``one_step``'s arguments, keywords) of each case the ranks
    take: the JAX case, dropout, compaction (both with the generator
    ``SEED``) and the BEV encoder."""
    tiny = get_config("tiny")
    bev = get_config("tiny_bev")
    item, sd = tiny_case["item"], tiny_case["sd"]
    return {
        "jax": ((no_dropout(tiny), sd, item),
                {"draws": tiny_case["draws"]}),
        "dropout": ((tiny, sd, item), {"seed": SEED}),
        "compact": ((compact(tiny), sd, item), {"seed": SEED}),
        "bev": ((bev, port_weights(bev), item_of(bev)), {"seed": SEED})}


def spawn_ranks(world, cases):
    threads = max(1, torch.get_num_threads() // world)
    return mesh.spawn(mp_ranks, world, "gloo", ["cpu"] * world,
                      args=(cases, threads, ROUTES))


@pytest.fixture(scope="module")
def two_ranks(port_cases):
    return spawn_ranks(2, port_cases)


@pytest.fixture(scope="module")
def three_ranks(port_cases):
    return spawn_ranks(3, {"dropout": port_cases["dropout"]})


@pytest.fixture(scope="module")
def one_process(port_cases):
    """The port's one-process step of each case but the JAX one."""
    return {name: one_step(*args, **kw)
            for name, (args, kw) in port_cases.items() if name != "jax"}


def assert_step_close(got, ref):
    """Losses, ``total``, ``grad_norm``, gradients and updated parameters
    of a model-parallel rank against a reference step."""
    for k, v in ref["metrics"].items():
        if k == "lr":
            continue
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol,
                                   err_msg=k)
    assert set(got["grads"]) == set(ref["grads"])
    for name, g in ref["grads"].items():
        assert_grad_close(got["grads"][name].numpy(), g.numpy(), name)
    for name, p in ref["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=name)


def assert_ranks_bit_equal(ranks, case):
    first = ranks[0]["steps"][case]
    for r in ranks[1:]:
        step = r["steps"][case]
        for key in ("params", "grads", "stats"):
            assert set(step[key]) == set(first[key])
            for name, t in first[key].items():
                assert torch.equal(step[key][name], t), (case, key, name)
        assert step["metrics"] == first["metrics"], case


def test_mp_step_matches_jax_mp_step(tiny_case, two_ranks):
    for r in two_ranks:
        assert_step_close(r["steps"]["jax"], tiny_case["jax"])
    assert_ranks_bit_equal(two_ranks, "jax")


@pytest.mark.parametrize("case", ["dropout", "compact", "bev"])
def test_mp_step_matches_one_process(two_ranks, one_process, case):
    for r in two_ranks:
        assert_step_close(r["steps"][case], one_process[case])
    assert_ranks_bit_equal(two_ranks, case)


def test_three_ranks_uneven_shards_match_one_process(three_ranks,
                                                     one_process):
    sizes = TPVSegmentor(get_config("tiny").model).encoder.plane_sizes
    assert any(n % 3 for n in sizes)
    for r in three_ranks:
        assert_step_close(r["steps"]["dropout"], one_process["dropout"])
    assert_ranks_bit_equal(three_ranks, "dropout")


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("route", ROUTES)
def test_gather_rows_forward_and_backward(two_ranks, three_ranks, world,
                                          route):
    ranks = two_ranks if world == 2 else three_ranks
    keys = [f"plane{i}" for i in range(len(GATHER_SIZES))] + ["seq"]
    for key in keys:
        owned = []
        for rank, r in enumerate(ranks):
            got = r["gather"][route]
            assert got["route"] == route
            rec = got[key]
            n = rec["table"].shape[1]
            assert torch.equal(rec["full"], rec["table"]), (route, key)
            cot = sum(np.random.RandomState(100 + s).randint(
                -50, 50, (1, n, GATHER_WIDTH)).astype(np.float32)
                for s in range(world))
            want = torch.from_numpy(cot)[:, rec["index"]]
            assert torch.equal(rec["grad"], want), (route, key, rank)
            owned.append(rec["index"].numpy())
        # each rank a share of the rows, the largest first, covering them
        counts = [len(o) for o in owned]
        assert max(counts) - min(counts) <= (1 if key != "seq" else 3)
        assert sorted(np.concatenate(owned).tolist()) == list(range(n))
        if key != "seq":
            assert [(o[0], o[-1] + 1) for o in owned] == \
                mesh.split_rows(n, world)


def test_collective_route_by_backend_and_device():
    assert mesh.collective_route("nccl", "cuda") == "gather"
    assert mesh.collective_route("gloo", "cpu") == "gather"
    assert mesh.collective_route("gloo", "cuda") == "all_reduce"
    with pytest.raises(ValueError):
        mesh.collective_route("mpi", "cpu")


def test_one_rank_group_is_the_plain_step(port_cases):
    (cfg, sd, item), kw = port_cases["dropout"]
    plain = one_step(cfg, sd, item, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        group = mesh.init_group("gloo", 0, 1, "cpu",
                                f"file://{os.path.join(tmp, 'store')}")
        try:
            sharded = one_step(cfg, sd, item, group=group, **kw)
        finally:
            mesh.close(group)
    assert sharded["metrics"] == plain["metrics"]
    for key in ("grads", "params"):
        for name, t in plain[key].items():
            assert torch.equal(sharded[key][name], t), (key, name)


def test_train_main_mp_runs_two_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // 2)))
    proc = subprocess.run(
        [sys.executable, "-m", "selfocc_tpu_torch.train", "--py-config",
         "tiny", "--synthetic", "--device", "cpu", "--print-freq", "1",
         "--max-steps", "2", "--work-dir", str(tmp_path), "--mp",
         "--dp-ranks", "2"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("model-parallel (the TPV encoder's query rows): 2 ranks over "
            "gloo") in proc.stdout
    assert "all 2 ranks hold rank 0's parameters" in proc.stdout
    assert proc.stdout.count("[e0 i") == 2        # rank 0 logs, alone
    state = torch.load(tmp_path / "ckpts" / "latest.pt", map_location="cpu")
    # one item a step, the same on both ranks
    assert state["step"] == 2 and state["last_iter"] == 2
