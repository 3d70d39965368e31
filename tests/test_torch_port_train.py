"""The port's training step against the JAX package's on the CPU: one
``tiny`` step (losses, every parameter gradient), the non-compact and compact
second derivatives, a train-mode ResNet bottleneck (output, gradients,
updated BatchNorm running statistics), the optimizer and LR schedule, and the
``train`` driver's run and resume.

Both models run with ``dropout = 0``; the head's random draws (cellular ray
grid, stratified jitter, random background) are made in JAX by replaying the
key splits of ``train_lib.py:128`` and ``heads.py:242,349,434`` and handed to
the port as ``draws``. Tolerances: loss values rtol 1e-5; gradients
``max|d| <= 1e-4 * max|g_ref| + 1e-7`` per tensor (fp32, sums over the
rays and samples in another order).
"""
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.resnet import Bottleneck as JBottleneck
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu.utils.eval_lib import init_variables
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models import resnet as tresnet
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import train_lib as ttrain
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


def assert_grad_close(got, ref, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    tol = 1e-4 * float(np.abs(ref).max()) + 1e-7
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{name}: max|d| {err:.3e} > {tol:.3e}"


def perturb(tree, rng, scale=0.1):
    """numpy copy of a flax param tree with noise on every leaf (kernels
    scaled by 1/sqrt(fan_in)), inv_s left at its init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng, scale)
            continue
        v = np.asarray(v, np.float32)
        noise = np.asarray(rng.randn(*v.shape), np.float32)
        if k == "kernel":
            noise = noise / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = v if k == "variance" else v + scale * noise
    return out


def no_dropout(cfg):
    enc = dataclasses.replace(cfg.model.encoder, dropout=0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              encoder=enc))


def jax_draws(rng, cfg):
    """The head's uniforms of one JAX train step, replaying its key splits:
    ``make_loss_fn`` (dropout, forward), the head (rays), ``render_rays``
    (jitter, then background)."""
    h = cfg.model.head
    _, fwd_rng = jax.random.split(rng)
    rng_h, ray_rng = jax.random.split(fwd_rng)
    cellular = [float(jax.random.uniform(k))
                for k in jax.random.split(ray_rng, 4)]
    R = cfg.num_cams * h.ray_number[0] * h.ray_number[1]
    rng_r, sample_rng = jax.random.split(rng_h)
    t_rand = jax.random.uniform(sample_rng, (R, h.num_samples + 1),
                                jnp.float32)
    _, bkgd_rng = jax.random.split(rng_r)
    bkgd = jax.random.uniform(bkgd_rng, (R, 3), jnp.float32)
    return {"cellular": np.asarray(cellular, np.float32),
            "t_rand": np.array(t_rand), "bkgd": np.array(bkgd)}


@pytest.fixture(scope="module")
def tiny_step():
    """One JAX ``tiny`` loss-and-grad (dropout 0) and the matching port
    model, batch and draws."""
    cfg = no_dropout(jget_config("tiny"))
    tcfg = no_dropout(get_config("tiny"))
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    batch = {k: np.asarray(v) for k, v in ds[0].items()
             if not isinstance(v, (str, dict))}
    jmodel = JSegmentor(cfg=cfg.model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = init_variables(jmodel, cfg, jbatch)
    np_params = perturb(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]),
                        np.random.RandomState(0))
    rng = jax.random.PRNGKey(3)
    compute = jtrain.make_loss_fn(jmodel, cfg)
    (tot, (ldict, _)), grads = jax.jit(jax.value_and_grad(
        compute, has_aux=True), static_argnums=5)(
        jax.tree_util.tree_map(jnp.asarray, np_params), {},
        variables["consts"], jbatch, rng, 0)
    jres = {"total": float(tot),
            "losses": {k: float(v) for k, v in ldict.items()},
            "grads": from_jax_variables(
                {"params": jax.tree_util.tree_map(np.asarray, grads)})}
    tmodel = TPVSegmentor(tcfg.model)
    tmodel.load_state_dict(from_jax_variables({"params": np_params}),
                           strict=True)
    return tcfg, tmodel, batch, jax_draws(rng, cfg), jres, variables, jmodel


def test_tiny_train_step_matches_jax(tiny_step):
    cfg, tmodel, batch, draws, jres, _, _ = tiny_step
    tbatch = {k: T(v.copy()) for k, v in batch.items()}
    tmodel.train()
    out = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                 tbatch[cfg.model.head.trans_kw], train=True, draws=draws)
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
        g = params[name].grad
        assert g is not None, name
        assert_grad_close(g.numpy(), ref.numpy(), name)


def _smooth_volume(rng, C=1, H=9, W=9, D=9):
    vol = rng.randn(C, H, W, D).astype(np.float32)
    d = np.arange(D, dtype=np.float32)[None, None, :]
    h = np.arange(H, dtype=np.float32)[:, None, None]
    vol[0] = 0.3 * (d - 2.5) ** 2 / D + 0.05 * (h - 4) + 0.1 * vol[0]
    return vol


@pytest.mark.parametrize("compact", [False, True])
def test_second_grad_matches_jax(tiny_step, compact):
    cfg, tmodel, _, _, _, variables, jmodel = tiny_step
    rng = np.random.RandomState(5)
    vol = _smooth_volume(rng, C=3)
    xyz = rng.uniform(-11.0, 11.0, (200, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-1.5, 3.5, 200)
    cot = rng.randn(200, 3).astype(np.float32)
    delta = cfg.model.head.numerical_gradients_delta
    name = "second_grad" if compact else "second_grad_noncompact"
    ref, vjp = jax.vjp(lambda v: jmodel.apply(
        variables, v, jnp.asarray(xyz),
        method=lambda m, v, x: getattr(m.head.field, name)(v, x, delta)),
        jnp.asarray(vol))
    (g_ref,) = vjp(jnp.asarray(cot))
    tv = T(vol.copy()).requires_grad_(True)
    got = getattr(tmodel.head.field, name)(tv, T(xyz), delta)
    # d^2 sdf / dx^2 by central differences over delta = 0.01: fp32 values
    # differing by ~1e-7 in the gradient taps differ by ~1e-7 / 0.02 here
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4 * scale + 1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(tv.grad.numpy(), g_ref, name)


def test_bottleneck_batchnorm_train_mode_matches_flax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)            # NHWC
    jblk = JBottleneck(planes=8, stride=2, downsample=True)
    variables = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    np_vars = {"params": perturb(jax.tree_util.tree_map(
        np.asarray, variables["params"]), rng)}
    np_vars["batch_stats"] = jax.tree_util.tree_map(
        lambda s: np.asarray(s) + 0.1 * np.abs(rng.randn(*s.shape)).astype(
            np.float32), variables["batch_stats"])
    cot = rng.randn(2, 5, 6, 32).astype(np.float32)

    def f(params, xx):
        return jblk.apply({"params": params,
                           "batch_stats": np_vars["batch_stats"]}, xx, True,
                          mutable=["batch_stats"])

    ref, vjp, new_stats = jax.vjp(
        f, jax.tree_util.tree_map(jnp.asarray, np_vars["params"]),
        jnp.asarray(x), has_aux=True)
    g_params, g_x = vjp(jnp.asarray(cot))

    blk = tresnet.Bottleneck(16, 8, stride=2, downsample=True)
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
    blk.load_state_dict(sd, strict=True)
    blk.train()
    tx = T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    got = blk(tx)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-5)
    (got * T(np.ascontiguousarray(cot.transpose(0, 3, 1, 2)))).sum().backward()
    assert_grad_close(tx.grad.numpy().transpose(0, 2, 3, 1), g_x, "x")
    for name in ("bn1", "bn2", "bn3", "ds_bn"):
        key = "downsample.1" if name == "ds_bn" else name
        bn = blk.get_submodule(key)
        s = new_stats["batch_stats"][name]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(s["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(s["var"]), rtol=1e-5,
                                   atol=1e-6)
        assert_grad_close(bn.weight.grad.numpy(), g_params[name]["scale"],
                          f"{name}.scale")
    assert_grad_close(blk.conv2.weight.grad.numpy(), np.transpose(
        np.asarray(g_params["conv2"]["kernel"]), (3, 2, 0, 1)), "conv2")
    # eval mode keeps the running statistics
    blk.eval()
    before = blk.bn1.running_mean.clone()
    blk(tx)
    assert torch.equal(before, blk.bn1.running_mean)


def test_dropout_active_in_train_mode_only():
    cfg = get_config("tiny")
    model = TPVSegmentor(cfg.model)
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    b = {k: T(np.asarray(v)) for k, v in ds[0].items()
         if k in ("imgs", "lidar2img")}

    def rep(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return torch.cat([p.flatten() for p in model.get_representation(
                b["imgs"], b["lidar2img"], g)])

    model.train()
    a, a2, c = rep(0), rep(0), rep(1)
    assert torch.equal(a, a2) and not torch.allclose(a, c)
    with pytest.raises(ValueError):
        model.get_representation(b["imgs"], b["lidar2img"])
    model.eval()
    assert torch.equal(rep(0), rep(1))


class _Tree(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for group, leaves in params.items():
            m = torch.nn.Module()
            for k, v in leaves.items():
                m.register_parameter(k, torch.nn.Parameter(T(v.copy())))
            self.add_module(group, m)


@pytest.mark.parametrize("multistep", [True, False])
def test_optimizer_and_schedule_match_optax(multistep):
    cfg = dataclasses.replace(
        get_config("tiny"), warmup_iters=2, grad_max_norm=1.0,
        multisteplr=multistep, multistep_decay_t=(4,), max_epochs=1)
    jcfg = dataclasses.replace(
        jget_config("tiny"), warmup_iters=2, grad_max_norm=1.0,
        multisteplr=multistep, multistep_decay_t=(4,), max_epochs=1)
    rng = np.random.RandomState(7)
    params = {"img_backbone": {"w": rng.randn(4, 3).astype(np.float32)},
              "encoder": {"w": rng.randn(5).astype(np.float32),
                          "b": rng.randn(2, 2).astype(np.float32)}}
    tx, jsched = jtrain.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    model = _Tree(params)
    opt, sched = ttrain.make_optimizer(cfg, model)
    named = dict(model.named_parameters())
    for step in range(6):
        scale = 10.0 if step == 3 else 0.01           # step 3 is clipped
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * scale).astype(np.float32),
            params)
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for group, leaves in grads.items():
            for k, g in leaves.items():
                named[f"{group}.{k}"].grad = T(g.copy())
        norm = ttrain.optimizer_step(opt, sched, step, cfg.grad_max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads))), rtol=1e-5)
        for group, leaves in jparams.items():
            for k, v in leaves.items():
                np.testing.assert_allclose(
                    named[f"{group}.{k}"].detach().numpy(), np.asarray(v),
                    rtol=1e-5, atol=1e-7, err_msg=f"step {step} {group}.{k}")


def test_clip_by_global_norm_has_no_epsilon():
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([3.0, 4.0])
    norm = ttrain.clip_by_global_norm([p], 5.0)        # norm == max: kept
    assert float(norm) == 5.0 and torch.equal(p.grad, torch.tensor([3., 4.]))
    norm = ttrain.clip_by_global_norm([p], 2.5)        # exactly halved
    assert torch.equal(p.grad, torch.tensor([1.5, 2.0]))


def test_train_driver_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "selfocc_tpu_torch.train", "--py-config",
            "tiny", "--synthetic", "--device", "cpu", "--print-freq", "1"]
    first = subprocess.run(base + ["--max-steps", "2", "--work-dir",
                                   str(tmp_path / "a")],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stdout + first.stderr
    ckpt = tmp_path / "a" / "ckpts" / "latest.pt"
    state = torch.load(ckpt, map_location="cpu")
    assert state["step"] == 2 and {"model", "optimizer"} <= set(state)
    assert "grad_norm=" in first.stdout and "lr=" in first.stdout
    second = subprocess.run(base + ["--max-steps", "3", "--work-dir",
                                    str(tmp_path / "b"), "--resume-from",
                                    str(tmp_path / "a")],
                            cwd=REPO, env=env, capture_output=True,
                            text=True, timeout=300)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "at step 2" in second.stdout and "[e0 i2]" in second.stdout
    assert "[e0 i0]" not in second.stdout
    state = torch.load(tmp_path / "b" / "ckpts" / "latest.pt",
                       map_location="cpu")
    assert state["step"] == 3


def test_train_driver_does_not_synchronise(monkeypatch):
    # train() leaves the card to run ahead: Trainer.step gets no ``sync``
    # (chip_smoke.py passes one to split the step's host times), and the
    # logged seconds are labelled host dispatch
    from selfocc_tpu_torch import train as tdriver
    calls = []

    class FakeTrainer:
        global_step = 0

        def step(self, batch, generator, *args, **kwargs):
            calls.append((args, kwargs))
            self.global_step += 1
            return {"total": torch.tensor(1.0), "times": {}}

    class FakeGenerator:
        def __init__(self, device=None):
            pass

        def manual_seed(self, seed):
            return self

    lines = []
    logger = type("Log", (), {"info": lambda self, m: lines.append(m)})()
    monkeypatch.setattr(tdriver, "to_device", lambda item, dev: item)
    monkeypatch.setattr(torch, "Generator", FakeGenerator)
    cfg = get_config("tiny")
    tdriver.train(cfg, FakeTrainer(), [{"x": 0}] * 3,
                        torch.device("cuda"), 3, 0, 1, logger)
    assert len(calls) == 3
    assert all(not args and "sync" not in kwargs for args, kwargs in calls)
    assert len(lines) == 3 and all("host dispatch" in m for m in lines)


def test_chunked_render_equals_dense(tiny_step):
    # train_ray_chunk splits the 48 rays into checkpointed chunks of 20, the
    # last one padded by 12 rays that are sliced off: same losses and
    # gradients as one dense render with the same draws
    cfg, tmodel, batch, draws, _, _, _ = tiny_step
    tbatch = {k: T(v.copy()) for k, v in batch.items()}
    results = []
    for chunk in (0, 20):
        model = copy.deepcopy(tmodel).train()
        model.head.train_ray_chunk = chunk
        out = model(tbatch["imgs"], tbatch["lidar2img"],
                    tbatch[cfg.model.head.trans_kw], train=True, draws=draws)
        tot, _ = tlosses.MultiLoss(cfg.loss_cfgs)(
            ttrain.build_loss_inputs(cfg, out, tbatch))
        tot.backward()
        results.append((float(tot.detach()),
                        {n: p.grad.clone() for n, p in
                         model.named_parameters()}))
    (dense, g_dense), (chunked, g_chunked) = results
    np.testing.assert_allclose(chunked, dense, rtol=1e-6)
    for n, g in g_dense.items():
        assert_grad_close(g_chunked[n].numpy(), g.numpy(), n)


@pytest.mark.parametrize("option,value", [
    ("backbone_type", "unet2d"), ("neck_type", "identity")])
def test_unported_head_options_are_refused(option, value):
    # the options a custom config can still set that the port lacks: the
    # EfficientNet UNet2D backbone and the identity neck that goes with it
    model = dataclasses.replace(get_config("tiny").model, **{option: value})
    with pytest.raises(NotImplementedError):
        TPVSegmentor(model)
