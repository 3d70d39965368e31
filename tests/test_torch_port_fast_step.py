"""``tiny_fast``'s loss-and-grad in the port against the JAX package's on
the CPU: the fast-tier model (head-shared MSDA locations; corner bundling,
which the port's kernels stand in for; visibility compaction, which at
tiny widths leaves every query in) from the images to the TPV planes, with
bridged weights, a loss of the planes (their dot with a seeded cotangent)
and every parameter gradient. The head, the render and the losses after
the planes are ``tiny``'s, held against JAX in
``test_torch_port_train.py::test_tiny_train_step_matches_jax``; the
encoder is what ``tiny_fast`` changes, and its loss compiles in a fraction
of the whole step's time.

Tolerances as ``test_torch_port_train.py``: planes and loss rtol 1e-5;
gradients ``max|d| <= 1e-4 * max|g_ref| + 1e-7`` per tensor (fp32, sums in
another order). JAX keeps the bundled shared payloads fp32, so fp32
tolerances hold.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from test_torch_port_models import jax_variable_shapes, random_variables
from test_torch_port_train import assert_grad_close
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy


@pytest.fixture(scope="module")
def tiny_fast_grads():
    """JAX ``tiny_fast``: random weights, a synthetic item's images and
    cameras, seeded cotangents of the planes, and the planes, loss and
    parameter gradients."""
    cfg = jget_config("tiny_fast")
    jmodel = JSegmentor(cfg=cfg.model)
    np_vars = random_variables(jax_variable_shapes(jmodel, cfg),
                               np.random.RandomState(5))
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    item = ds[0]
    imgs, lidar2img = (np.asarray(item[k], np.float32)
                       for k in ("imgs", "lidar2img"))

    def planes_of(params):
        planes, _ = jmodel.apply(
            dict(np_vars, params=params), imgs, lidar2img, train=False,
            method="get_representation", mutable=["consts"])
        return planes

    shapes = jax.eval_shape(planes_of, np_vars["params"])
    rng = np.random.RandomState(6)
    cots = [rng.randn(*p.shape).astype(np.float32) for p in shapes]

    def loss(params):
        planes = planes_of(params)
        return sum((p * c).sum() for p, c in zip(planes, cots)), planes

    (tot, planes), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_vars["params"]))
    jres = {"total": float(tot), "planes": [np.asarray(p) for p in planes],
            "grads": from_jax_variables(
                {"params": jax.tree_util.tree_map(np.asarray, grads)})}
    return np_vars, (imgs, lidar2img), cots, jres


def test_tiny_fast_step_matches_jax(tiny_fast_grads):
    np_vars, (imgs, lidar2img), cots, jres = tiny_fast_grads
    cfg = get_config("tiny_fast")
    assert cfg.model.encoder.shared_locations
    tmodel = TPVSegmentor(cfg.model).eval()
    # the shared locations reuse the per-head Linears: the bridge maps
    # tiny_fast's variables with strict=True
    tmodel.load_state_dict(from_jax_variables(np_vars), strict=True)
    planes = tmodel.get_representation(T(imgs), T(lidar2img))
    for p, r in zip(planes, jres["planes"]):
        np.testing.assert_allclose(
            p.detach().numpy(), r, rtol=1e-5,
            atol=1e-5 * float(np.abs(r).max()))
    tot = sum((p * T(c)).sum() for p, c in zip(planes, cots))
    np.testing.assert_allclose(float(tot.detach()), jres["total"], rtol=1e-5)
    tmodel.zero_grad()
    tot.backward()
    params = dict(tmodel.named_parameters())
    assert set(params) == set(jres["grads"])
    reached = 0
    for name, ref in jres["grads"].items():
        got = params[name].grad
        if got is None:
            # a parameter after the planes (the head): no gradient in
            # either package
            assert not ref.abs().max() > 0, name
            continue
        reached += 1
        assert_grad_close(got.numpy(), ref.numpy(), name)
    assert reached > 0 and params["encoder.layers.0.attentions.0"
                                   ".sampling_offsets.weight"].grad is not None
