"""PyTorch port vs the JAX package, module by module, on the CPU.

The JAX model is initialised, its parameters are perturbed with numpy noise
(so zero-initialised sampling offsets and unit BatchNorm statistics do not
hide a wrong mapping), and ``selfocc_tpu_torch.bridge.from_jax_variables``
carries them into the port. Each module's output is compared with
``model.apply(..., method=...)`` on the same numpy inputs.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.encoder import (get_cross_view_ref_points as
                                        j_cross_view_ref)
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils.eval_lib import init_variables
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.models import encoder as tenc
from selfocc_tpu_torch.models.segmentor import TPVSegmentor

T = torch.from_numpy


def perturb(tree, rng, scale=0.1):
    """numpy copy of a flax param/stat tree with noise on every leaf;
    kernels get noise scaled by 1/sqrt(fan_in), variances stay positive."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng, scale)
            continue
        v = np.asarray(v, np.float32)
        noise = np.asarray(rng.randn(*v.shape), np.float32)
        if k == "kernel":
            noise = noise / np.sqrt(np.prod(v.shape[:-1]))
        if k != "variance":                 # keep inv_s at its init
            v = v + scale * noise
        out[k] = np.abs(v) + 0.5 if k == "var" else v
    return out


def random_variables(shape_tree, rng):
    """Random numpy values for a ``jax.eval_shape`` variables tree."""
    def fill(tree, key=""):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        shape = tree.shape
        noise = np.asarray(rng.randn(*shape), np.float32)
        if key == "kernel":
            return noise / np.float32(np.sqrt(np.prod(shape[:-1])))
        if key == "var":
            return np.abs(noise) * 0.5 + 0.5
        if key == "scale":
            return 1.0 + 0.1 * noise
        return 0.1 * noise
    return {k: fill(v) for k, v in shape_tree.items() if k != "consts"}


def two_layer_tiny():
    cfg = get_config("tiny")
    enc = dataclasses.replace(cfg.model.encoder, num_layers=2)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              encoder=enc))


def sample_batch(cfg):
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    return {k: np.asarray(v) for k, v in ds[0].items()
            if not isinstance(v, (str, dict))}


@pytest.fixture(scope="module")
def tiny2():
    """(cfg, jax model, variables, port model, batch) for a 2-layer tiny."""
    cfg = two_layer_tiny()
    batch = sample_batch(cfg)
    jmodel = JSegmentor(cfg=cfg.model)
    variables = init_variables(jmodel, cfg,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(0)
    np_vars = {"params": perturb(jax.tree_util.tree_map(
        np.asarray, variables["params"]), rng)}
    variables = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                  np_vars["params"]),
                 "consts": variables["consts"]}
    tmodel = TPVSegmentor(cfg.model).eval()
    tmodel.load_state_dict(from_jax_variables(np_vars), strict=True)
    return cfg, jmodel, variables, tmodel, batch


def test_tiny_backbone_fpn_matches_jax(tiny2):
    cfg, jmodel, variables, tmodel, batch = tiny2
    ref = jmodel.apply(variables, jnp.asarray(batch["imgs"]),
                       method="extract_img_feat")
    with torch.no_grad():
        got = tmodel.extract_img_feat(T(batch["imgs"]))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        # fp32 convolutions, different summation order: atol 1e-4
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


def resnet50_tiny():
    cfg = get_config("tiny")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_type="resnet50",
        fpn_in_channels=(256, 512, 1024, 2048)))


def jax_variable_shapes(jmodel, cfg):
    """``jax.eval_shape`` of the JAX model's init: the variables' tree and
    shapes without compiling or running anything."""
    b = {k: jnp.asarray(v) for k, v in sample_batch(cfg).items()}
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, b["imgs"], b["lidar2img"],
        b[cfg.model.head.trans_kw], key, 0, True))


def test_resnet50_fpn_matches_jax():
    cfg = resnet50_tiny()
    jmodel = JSegmentor(cfg=cfg.model)
    rng = np.random.RandomState(1)
    np_vars = random_variables(jax_variable_shapes(jmodel, cfg), rng)
    imgs = rng.randn(1, 1, 64, 96, 3).astype(np.float32)
    ref = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, np_vars),
                       jnp.asarray(imgs), method="extract_img_feat")
    tmodel = TPVSegmentor(cfg.model).eval()
    tmodel.load_state_dict(from_jax_variables(np_vars), strict=True)
    with torch.no_grad():
        got = tmodel.extract_img_feat(T(imgs))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        scale = float(np.abs(np.asarray(r)).max())
        # 53 fp32 convolutions deep: atol 1e-4 of the feature scale
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=1e-4 * max(scale, 1.0), rtol=1e-4)


def test_encoder_two_layers_matches_jax(tiny2):
    # exercises the scan-axis unstacking of the bridge (2 stacked layers)
    cfg, jmodel, variables, tmodel, batch = tiny2
    ref = jmodel.apply(variables, jnp.asarray(batch["imgs"]),
                       jnp.asarray(batch["lidar2img"]),
                       method="get_representation")
    with torch.no_grad():
        got = tmodel.get_representation(T(batch["imgs"]),
                                        T(batch["lidar2img"]))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        # post-LayerNorm features after 2 layers of fp32 deformable
        # attention (bilinear weights amplify location rounding): atol 1e-4
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


def test_field_decode_matches_jax(tiny2):
    cfg, jmodel, variables, tmodel, _ = tiny2
    rng = np.random.RandomState(2)
    H, W, D = 17, 17, 9
    C = cfg.model.embed_dims
    rep = [rng.randn(1, n, C).astype(np.float32)
           for n in (H * W, D * H, W * D)]
    ref = jmodel.apply(variables, [jnp.asarray(r) for r in rep],
                       method=lambda m, r: m.head.field.decode(r))
    with torch.no_grad():
        got = tmodel.head.field.decode([T(r) for r in rep])
    assert got.shape == ref.shape == (1, 1 + 3 + 5, H, W, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    inv_s = jmodel.apply(variables, method=lambda m: m.head.field.inv_s())
    np.testing.assert_allclose(tmodel.head.field.inv_s().item(),
                               float(inv_s), rtol=1e-6)


def _smooth_volume(rng, C=9, H=17, W=17, D=9):
    """sdf channel = a tilted ground plane plus noise; other channels
    random — a volume whose rays actually hit a surface."""
    vol = rng.randn(C, H, W, D).astype(np.float32)
    d = np.arange(D, dtype=np.float32)[None, None, :]
    h = np.arange(H, dtype=np.float32)[:, None, None]
    vol[0] = 0.6 * (d - 2.5) + 0.05 * (h - 8) + 0.1 * vol[0]
    return vol


@pytest.mark.parametrize("geo_only", [False, True])
def test_neus_head_render_rays_matches_jax(tiny2, geo_only):
    cfg, jmodel, variables, tmodel, _ = tiny2
    rng = np.random.RandomState(3)
    vol = _smooth_volume(rng)
    R = 48
    origin = (rng.randn(R, 3) * [2.0, 2.0, 0.3] + [0, 0, 1.5]).astype(
        np.float32)
    direction = rng.randn(R, 3).astype(np.float32)
    direction[:, 2] = -np.abs(direction[:, 2]) - 0.2      # looking down
    direction[0] = [1.0, 0.0, 0.0]                         # axis-parallel
    ref = jmodel.apply(variables, jnp.asarray(vol), jnp.asarray(origin),
                       jnp.asarray(direction), geo_only=geo_only,
                       method="render_rays")
    with torch.no_grad():
        got = tmodel.render_rays(T(vol), T(origin), T(direction),
                                 geo_only=geo_only)
    keys = ["depth", "weights", "acc", "sdf", "eik_grad", "ts", "deltas",
            "fars", "rgb"] + ([] if geo_only else ["sem"])
    for k in keys:
        assert got[k].shape == ref[k].shape, k
        # fp32 through the same formulas; the JAX head takes the bundled
        # corner path (an fp reassociation): atol 1e-4 / rtol 1e-4
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    assert "sem" not in got if geo_only else "sem" in got


def test_ref_tables_equal_jax_consts(tiny2):
    cfg, jmodel, variables, tmodel, _ = tiny2
    consts = variables["consts"]["encoder"]
    enc = tmodel.encoder
    for ref, got in zip(consts["ref_3d"],
                        (enc.ref_3d_hw, enc.ref_3d_zh, enc.ref_3d_wz)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(enc.cross_view_ref.numpy(),
                                  np.asarray(consts["cross_view_ref"]))
    for ref, name in zip(consts["positional_encoding"]["fourier_feats"],
                         ("hw", "zh", "wz")):
        np.testing.assert_allclose(
            getattr(enc.positional_encoding, f"fourier_{name}").numpy(),
            np.asarray(ref), atol=1e-6)
    # the numpy generator itself, at flagship sizes and point counts
    np.testing.assert_array_equal(
        tenc.get_cross_view_ref_points(257, 257, 25, (12, 12, 12)),
        np.asarray(j_cross_view_ref(257, 257, 25, (12, 12, 12))))
