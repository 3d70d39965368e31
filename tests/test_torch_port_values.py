"""The compact second derivative's one query for its six taps, on the CPU.

``TPVSDFField.second_grad`` queries the sdf plane once, at the six taps of
every point laid out point-major (x+d, x-d along x, then y, then z). The
tests hold it against the composition of one query per tap that it
replaces, rebuilt here from ``trilinear_sample_cf_plain`` (values and
the volume's cotangent bit for bit: on the CPU the query's backward sums
the taps in the order autograd summed six queries), against the JAX field
(the tolerances of
``test_torch_port_train.py::test_second_grad_matches_jax``: values 1e-4 of
their largest + 1e-5, the volume's cotangent 1e-4 of its largest value +
1e-7), and count its values-only queries. The
mappings are ``tiny``'s and ``tiny``'s with ``kitti_occ``'s ``h_half``; the
JAX field runs eagerly, with no jit.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.models.field import TPVSDFField as JField
from selfocc_tpu_torch.models import field as field_mod
from selfocc_tpu_torch.ops import interp as interp_mod
from selfocc_tpu_torch.models.field import TPVSDFField
from selfocc_tpu_torch.ops.interp import (channel0_view, first_channel,
                                          trilinear_sample_cf_plain)

from test_torch_port_train import assert_grad_close
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy
DELTA = 0.01


def mapping_args(h_half):
    return dict(jget_config("tiny").model.head.mapping_args, h_half=h_half)


def per_tap_second_grad(field, volume, xyz, delta, center=None):
    """The compact second derivative as one query per tap (``field.py``
    before its taps were merged): each tap's sdf alone, then
    ``(sdf(x+d) + sdf(x-d) - 2 center) / d^2`` per axis."""
    sdf_vol = first_channel(volume)

    def sdf(p):
        grid = field.mapping.meter2grid(p.float())
        return trilinear_sample_cf_plain(channel0_view(sdf_vol), grid,
                                         "zeros")[..., 0]

    if center is None:
        center = sdf(xyz)
    comps = []
    for axis in range(3):
        e = torch.eye(3, dtype=torch.float32)[axis] * delta
        comps.append((sdf(xyz + e) + sdf(xyz - e) - 2 * center)
                     / (delta * delta))
    return torch.stack(comps, dim=-1)


def case(seed, h_half, shape=(23, 29)):
    """A field on the mapping, a channel-last (3, 9, 9, 9) volume whose sdf
    is smooth plus noise, and points over the box (some outside; a fifth
    of them on the metric x of a voxel knot) of shape ``shape`` + (3,)."""
    rng = np.random.RandomState(seed)
    field = TPVSDFField(mapping_args(h_half), embed_dims=8)
    vol = rng.randn(3, 9, 9, 9).astype(np.float32)
    d = np.arange(9, dtype=np.float32)
    vol[0] = 0.3 * (d - 2.5) ** 2 / 9 + 0.05 * (d[:, None, None] - 4) \
        + 0.1 * vol[0]
    n = int(np.prod(shape))
    xyz = np.stack([rng.uniform(-11.0, 11.0, n), rng.uniform(-11.0, 11.0, n),
                    rng.uniform(-1.5, 3.5, n)], -1).astype(np.float32)
    knots = np.round(field.mapping.meter2grid(T(xyz[::5])).numpy())
    xyz[::5, 0] = field.mapping.grid2meter(T(knots)).numpy()[:, 0]
    return field, vol, xyz.reshape(*shape, 3)


@pytest.mark.parametrize("h_half", [False, True], ids=["tiny", "h_half"])
@pytest.mark.parametrize("with_center", [False, True],
                         ids=["center_queried", "center_given"])
def test_second_grad_equals_the_per_tap_queries(h_half, with_center):
    field, vol, xyz = case(1, h_half)
    volume = T(np.ascontiguousarray(np.moveaxis(vol, 0, -1))).permute(
        3, 0, 1, 2)
    pts = T(xyz)
    center = field.sdf(first_channel(volume), pts) if with_center else None
    got = field.second_grad(volume, pts, DELTA, center=center)
    ref = per_tap_second_grad(field, volume, pts, DELTA, center=center)
    assert got.shape == xyz.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("h_half", [False, True], ids=["tiny", "h_half"])
def test_second_grad_cotangent_matches_jax(h_half):
    field, vol, xyz = case(2, h_half, shape=(300,))
    cot = np.random.RandomState(3).randn(*xyz.shape).astype(np.float32)
    jfield = JField(mapping_args=mapping_args(h_half))
    ref, vjp = jax.vjp(lambda v: jfield.apply(
        {}, v, jnp.asarray(xyz), DELTA, method=JField.second_grad),
        jnp.asarray(vol))
    (g_ref,) = vjp(jnp.asarray(cot))
    leaf = T(np.ascontiguousarray(np.moveaxis(vol, 0, -1))).requires_grad_()
    got = field.second_grad(leaf.permute(3, 0, 1, 2), T(xyz), DELTA)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4 * scale + 1e-5)
    (got * T(cot)).sum().backward()
    assert_grad_close(leaf.grad.permute(3, 0, 1, 2).numpy(), g_ref,
                      "second_grad")
    # on the CPU the one query's backward sums the taps as the per-tap
    # composition did: the same cotangent, bit for bit
    tap_leaf = leaf.detach().clone().requires_grad_()
    (per_tap_second_grad(field, tap_leaf.permute(3, 0, 1, 2), T(xyz), DELTA)
     * T(cot)).sum().backward()
    assert torch.equal(leaf.grad, tap_leaf.grad)


@pytest.mark.parametrize("with_center", [False, True],
                         ids=["center_queried", "center_given"])
def test_second_grad_makes_one_values_query(monkeypatch, with_center):
    field, vol, xyz = case(4, False)
    volume = T(np.ascontiguousarray(np.moveaxis(vol, 0, -1))).permute(
        3, 0, 1, 2)
    pts = T(xyz)
    center = field.sdf(first_channel(volume), pts) if with_center else None
    calls = []

    def counted(vol_cf, hwd, padding="zeros"):
        calls.append(tuple(hwd.shape))
        return trilinear_sample_cf_plain(vol_cf, hwd, padding)

    # the centre's query through the field's name, the taps' through the
    # op module's
    monkeypatch.setattr(field_mod, "trilinear_sample_cf", counted)
    monkeypatch.setattr(interp_mod, "trilinear_sample_cf", counted)
    field.second_grad(volume, pts, DELTA, center=center)
    taps = [s for s in calls if s[-2:] == (6, 3)]
    assert taps == [xyz.shape[:-1] + (6, 3)]
    assert len(calls) == (1 if with_center else 2)
