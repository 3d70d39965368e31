"""The training and eval drivers' options on the CPU: gradient accumulation
against JAX's ``optax.MultiSteps`` chain (no model: the same gradients
into both optimizers over 4 micro-steps), a ``tiny`` ``Trainer`` with
K = 2 (the schedule counts updates, ``global_iter`` micro-steps, and a
resume mid-window trains to the unbroken run's weights), the ``train``
driver's run log, ``scalars.jsonl``, ``--profile`` trace and per-epoch
eval, the eval drivers' ``--work-dir`` run logs, and ``camera_kwargs``
against the JAX helper.

Tolerances: parameters after each micro-step within 1e-6 relative of
optax's (1e-7 absolute for entries near 0), and bitwise unchanged where no
update is due; the resumed run within rtol 1e-5 of the unbroken one.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu_torch import (eval_depth, eval_iou, eval_iou_kitti,
                               eval_novel_depth, train)
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.utils import eval_lib as teval
from selfocc_tpu_torch.utils import train_lib as ttrain
from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy


class _Tree(torch.nn.Module):
    """A module whose parameters are a two-level dict of arrays, named
    ``group.leaf`` as the flax tree's paths."""

    def __init__(self, params):
        super().__init__()
        for group, leaves in params.items():
            m = torch.nn.Module()
            for k, v in leaves.items():
                m.register_parameter(k, torch.nn.Parameter(T(v.copy())))
            self.add_module(group, m)


def _schedule_cfg(pkg_get_config):
    return dataclasses.replace(
        pkg_get_config("tiny"), warmup_iters=2, grad_max_norm=1.0,
        multisteplr=True, multistep_decay_t=(3,), max_epochs=1,
        weight_decay=0.05)


def test_accumulation_matches_optax_multisteps():
    K = 2
    rng = np.random.RandomState(11)
    params = {"img_backbone": {"w": rng.randn(4, 3).astype(np.float32)},
              "encoder": {"w": rng.randn(5).astype(np.float32),
                          "b": rng.randn(2, 2).astype(np.float32)}}
    tx, jsched = jtrain.make_optimizer(_schedule_cfg(jget_config), K)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    cfg = _schedule_cfg(get_config)
    model = _Tree(params)
    trainer = ttrain.Trainer(cfg, model, grad_accumulation=K)
    named = dict(model.named_parameters())
    lrs = []
    for micro in range(4):
        # micro-step 2's gradients are clipped in the mean of window 2
        scale = 10.0 if micro == 2 else 0.01
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * scale).astype(np.float32),
            params)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {n: p.detach().clone() for n, p in named.items()}
        for group, leaves in grads.items():
            for k, g in leaves.items():
                named[f"{group}.{k}"].grad = T(g.copy())
        norm, lr = trainer.apply_gradients()
        lrs.append(lr)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads))), rtol=1e-5)
        for group, leaves in jparams.items():
            for k, v in leaves.items():
                got = named[f"{group}.{k}"].detach()
                if micro % K == 0:          # no update due: bit for bit
                    assert torch.equal(got, before[f"{group}.{k}"])
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(v), rtol=1e-6, atol=1e-7,
                    err_msg=f"micro-step {micro} {group}.{k}")
    # the schedule counts optimizer updates: two per four micro-steps
    assert trainer.updates == 2 and trainer.mini_step == 0
    np.testing.assert_allclose(lrs, [float(jsched(u)) for u in
                                     (0, 0, 1, 1)], rtol=1e-6)
    assert all(s["step"] == 2 for s in trainer.optimizer.state.values())


def _tiny_trainer(K):
    cfg = get_config("tiny")
    return train.build_trainer(cfg, 0, torch.device("cpu"), K), cfg


def _micro_steps(trainer, cfg, batches, first=0):
    seen = []
    for i, batch in enumerate(batches):
        gen = torch.Generator().manual_seed(first + i)
        seen.append(trainer.global_step)
        trainer.step(batch, gen)
    return seen


def test_trainer_accumulates_and_resumes_mid_window(tmp_path, monkeypatch):
    K = 2
    ds = get_dataset(get_config("tiny"), synthetic=True, length=4)
    batches = [to_device(ds[i], torch.device("cpu")) for i in range(4)]
    full, cfg = _tiny_trainer(K)
    # the model's global_iter is the micro-step count
    seen_iters = []
    forward = full.model.forward

    def spy(*args, **kwargs):
        seen_iters.append(kwargs["global_iter"])
        return forward(*args, **kwargs)

    monkeypatch.setattr(full.model, "forward", spy)
    _micro_steps(full, cfg, batches)
    assert seen_iters == [0, 1, 2, 3]
    assert (full.global_step, full.updates) == (4, 2)
    # three micro-steps, a checkpoint mid-window, a new run resumed from it
    part, _ = _tiny_trainer(K)
    _micro_steps(part, cfg, batches[:3])
    assert part.mini_step == 1
    path = tmp_path / "mid.pt"
    torch.save(part.state_dict(), path)
    resumed, _ = _tiny_trainer(K)
    resumed.load_state_dict(torch.load(path, map_location="cpu"))
    assert (resumed.global_step, resumed.updates, resumed.mini_step) == \
        (3, 1, 1)
    _micro_steps(resumed, cfg, batches[3:], first=3)
    ref = dict(full.model.named_parameters())
    for n, p in resumed.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[n].detach().numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_train_driver_logs_profile_and_epoch_eval(tmp_path):
    work = str(tmp_path / "run")
    res = train.main(["--py-config", "tiny", "--synthetic", "--device",
                      "cpu", "--max-steps", "7", "--print-freq", "2",
                      "--gradient-accumulation", "2", "--profile",
                      "--eval-every-epoch", "--eval-samples", "2",
                      "--prefetch", "0", "--work-dir", work])
    logs = glob.glob(os.path.join(work, "*.log"))
    assert len(logs) == 1
    text = open(logs[0]).read()
    assert "[e0 i6]" in text and "=== epoch 0 depth eval ===" in text
    assert "profiler trace written to" in text and "training complete" in text
    with open(os.path.join(work, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert {r["step"] for r in rows} == {0, 2, 4, 6}
    assert {"loss/total", "loss/grad_norm", "loss/lr"} <= \
        {r["tag"] for r in rows}
    with open(os.path.join(work, "profile", "trace.json")) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])
    # the eval ran once, where --max-steps ended the run, on 2 items
    assert list(res["epoch_evals"]) == [0]
    table = res["epoch_evals"][0]
    assert table["abs_rel"].shape == (1, 2)       # raw only, 2 cameras
    assert all(np.isfinite(v).all() for v in table.values())
    state = torch.load(os.path.join(work, "ckpts", "latest.pt"),
                       map_location="cpu")
    assert (state["step"], state["updates"], state["mini_step"]) == (7, 3, 1)


@pytest.mark.parametrize("driver,args", [
    (eval_iou, ["--resolution", "1.0", "--occ3d", "--sem"]),
    (eval_iou_kitti, ["--resolution", "1.0"]),
    (eval_novel_depth, ["--batch", "256", "--offsets", "1.1"]),
    (eval_depth, ["--batch", "256"])],
    ids=["eval_iou", "eval_iou_kitti", "eval_novel_depth", "eval_depth"])
def test_eval_drivers_write_their_run_log(tmp_path, driver, args):
    work = tmp_path / "eval"
    driver.main(["--py-config", "tiny", "--synthetic", "--num-samples", "1",
                 "--device", "cpu", "--work-dir", str(work)] + args)
    logs = glob.glob(str(work / "*.log"))
    assert len(logs) == 1 and os.path.getsize(logs[0]) > 0


@pytest.mark.parametrize("layout", ["batched", "per_frame"])
def test_camera_kwargs_match_jax(layout):
    cfg = get_config("tiny")
    jcfg = jget_config("tiny")
    item = get_dataset(cfg, synthetic=True, length=1)[0]
    batch = {k: np.asarray(item[k], np.float32)
             for k in ("intrinsic", "cam2ego")}
    if layout == "per_frame":
        batch = {k: v[0] for k, v in batch.items()}
    assert teval.camera_kwargs(cfg, batch) == {} == \
        jeval.camera_kwargs(jcfg, batch)

    def aware(c):
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, encoder=dataclasses.replace(c.model.encoder,
                                                 camera_aware=True)))

    got = teval.camera_kwargs(aware(cfg), batch)
    ref = jeval.camera_kwargs(aware(jcfg), batch)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    with pytest.raises(KeyError, match="intrinsic"):
        teval.camera_kwargs(aware(cfg), {"cam2ego": batch["cam2ego"]})
