"""The port's losses against the JAX package's on the CPU: each loss class
on the same random inputs (a ``tiny`` synthetic frame's images and camera
matrices, random render outputs), its value and its gradient with respect
to the predicted inputs, then ``MultiLoss`` on the ``tiny`` recipe.

Tolerances: loss values rtol 1e-5 (fp32 means in another order); gradients
``max|d| <= 1e-4 * max|g_ref| + 1e-7`` per tensor.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu import losses as jlosses
from selfocc_tpu.configs.experiments import get_config
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.data.synthetic import SyntheticDataset
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy


def assert_grad_close(got, ref, name=""):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    tol = 1e-4 * float(np.abs(ref).max()) + 1e-7
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{name}: max|d| {err:.3e} > {tol:.3e}"


@pytest.fixture(scope="module")
def loss_inputs():
    """Fixed batch tensors and random predictions of the ``tiny`` recipe
    (2 cameras, a 4 x 6 cellular ray grid, 16 samples per ray)."""
    cfg = get_config("tiny")
    item = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                            img_size=cfg.img_size, num_classes=5, length=1)[0]
    fixed = {k: np.asarray(item[k]) for k in (
        "curr_imgs", "prev_imgs", "next_imgs", "color_imgs", "sem_gt",
        "img2prevImg", "img2nextImg")}
    rng = np.random.RandomState(0)
    N, (h, w), S = cfg.num_cams, cfg.num_rays, cfg.model.head.num_samples
    R = h * w
    H, W = cfg.img_size
    x_dsr, y_dsr = 1.0 + rng.rand() * 2.0, 1.0 + rng.rand() * 2.0
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    fixed["ms_rays"] = np.stack(
        [gx * x_dsr + rng.rand() * (W - w * x_dsr),
         gy * y_dsr + rng.rand() * (H - h * y_dsr)], -1
    ).reshape(-1, 2).astype(np.float32)
    weights = rng.rand(1, N, R, S).astype(np.float32) / S
    weights[0, 0, :3] = 0.0                   # rays with no weight at all
    ts = np.sort(rng.uniform(0.3, 14.0, (1, N, R, S)), -1).astype(np.float32)
    sem = rng.rand(1, N, R, 5).astype(np.float32)
    pred = {
        "weights": weights, "ts": ts,
        "ms_colors": [rng.rand(1, N, R, 3).astype(np.float32)],
        "eik_grad": rng.randn(N * R * S, 3).astype(np.float32),
        "second_grad": rng.randn(N * R * S, 3).astype(np.float32),
        "sem": [sem / sem.sum(-1, keepdims=True)],
    }
    return cfg, fixed, pred


def _torch_pred(pred):
    return {k: [T(x.copy()).requires_grad_(True) for x in v]
            if isinstance(v, list) else T(v.copy()).requires_grad_(True)
            for k, v in pred.items()}


def _check(jloss, tloss, fixed, pred, expect_grad=True):
    jfixed = {k: jnp.asarray(v) for k, v in fixed.items()}

    def f(p):
        return jloss({**jfixed, **p})

    jpred = jax.tree_util.tree_map(jnp.asarray, pred)
    ref, gref = jax.value_and_grad(f)(jpred)
    tpred = _torch_pred(pred)
    got = tloss({**{k: T(v.copy()) for k, v in fixed.items()}, **tpred})
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5,
                               atol=1e-7)
    got.backward()
    n = 0
    for k, v in tpred.items():
        for tv, jv in zip(v if isinstance(v, list) else [v],
                          gref[k] if isinstance(v, list) else [gref[k]]):
            if float(np.abs(np.asarray(jv)).max()) > 0:
                n += 1
                assert tv.grad is not None, k
                assert_grad_close(tv.grad, jv, k)
            elif tv.grad is not None:
                assert float(tv.grad.abs().max()) == 0.0, k
    assert n > 0 or not expect_grad


# with the automask on, the identity reprojection of the smooth synthetic
# frames beats random depths on every ray, so those cases carry no gradient;
# the no_automask cases hold the gradients through the warp
LOSS_CFGS = [
    dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=False),
    dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=False,
         no_automask=True),
    dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=True,
         no_automask=True),
    dict(type="ReprojLossMonoMultiNew", weight=1.0, no_ssim=False),
    dict(type="ReprojLossMonoMultiNew", weight=1.0, no_ssim=False,
         no_automask=True),
    dict(type="RGBLossMS", weight=0.1, no_ssim=False),
    dict(type="EikonalLoss", weight=0.1),
    dict(type="SecondGradLoss", weight=0.01),
    dict(type="SemCELossMS", weight=0.1),
    dict(type="SemLossMS", weight=0.1),
]


@pytest.mark.parametrize("lcfg", LOSS_CFGS,
                         ids=[f"{c['type']}-{i}" for i, c in
                              enumerate(LOSS_CFGS)])
def test_loss_matches_jax(loss_inputs, lcfg):
    cfg, fixed, pred = loss_inputs
    lcfg = dict(lcfg)
    if lcfg["type"] not in ("EikonalLoss", "SecondGradLoss"):
        lcfg.update(img_size=list(cfg.img_size),
                    ray_resize=list(cfg.num_rays))
    inputs = {"RGBLossMS": {"ms_colors": "ms_colors", "ms_rays": "ms_rays",
                            "gt_imgs": "color_imgs"}}
    if lcfg["type"] in inputs:
        lcfg["input_dict"] = inputs[lcfg["type"]]
    _check(jlosses.build_loss(dict(lcfg)), tlosses.build_loss(dict(lcfg)),
           fixed, pred, expect_grad=not (lcfg["type"].startswith("Reproj")
                                         and not lcfg.get("no_automask")))


def test_multi_loss_on_tiny_recipe(loss_inputs):
    cfg, fixed, pred = loss_inputs
    jm, tm = jlosses.MultiLoss(cfg.loss_cfgs), tlosses.MultiLoss(cfg.loss_cfgs)
    assert [type(x).__name__ for x in tm.losses] == \
        [type(x).__name__ for x in jm.losses]
    jtot, jd = jm({**{k: jnp.asarray(v) for k, v in fixed.items()},
                   **jax.tree_util.tree_map(jnp.asarray, pred)})
    ttot, td = tm({**{k: T(v.copy()) for k, v in fixed.items()},
                   **_torch_pred(pred)})
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k].detach()), float(jd[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(ttot.detach()), float(jtot), rtol=1e-5)
    _check(lambda x: jm(x)[0], lambda x: tm(x)[0], fixed, pred)


def test_unported_loss_is_refused():
    # every loss of the JAX registry is ported; a name outside it is refused
    assert set(tlosses.OPENOCC_LOSS) == set(jlosses.OPENOCC_LOSS)
    with pytest.raises(NotImplementedError):
        tlosses.build_loss(dict(type="FlowLoss"))
