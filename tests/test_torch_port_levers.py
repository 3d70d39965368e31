"""The encoder's recipe options in the port against the JAX package on the
CPU: head-shared MSDA locations (the op and its gradient; ``tiny_fast``'s
loss-and-grad is in ``test_torch_port_fast_step.py``), visibility
compaction of the image cross-attention, bf16 attention values and bf16
backbone / neck compute, and ``train --amp``.

Tolerances, with their reasons:

- the shared op against JAX ``_msda_dense_shared(bundle_corners="full")``,
  whose payloads stay fp32: forward and vjp within 1e-5 of each output's
  largest magnitude (fp32, sums in another order); against the unbundled
  JAX path, whose payloads, corner weights and per-point products are bf16:
  within 2e-2 of the largest magnitude (bf16 keeps 8 bits), the value's
  cotangent within 4e-2 (JAX scatters it in bf16);
- compaction without overflow against the port's dense branch: bit for
  bit (the same per-(camera, query) MSDA, the same sum over cameras); both
  against JAX within 1e-5 of the planes' scale (fp32, one layer); the
  gradients of a loss of the planes within 1e-5 of each tensor's largest
  magnitude of the dense branch's (the offsets' and weights' gradients sum
  the cameras' cotangents in another order);
- compaction with overflow: the port's ``visible_overflow`` equals JAX's
  sown ``visible_overflow_i`` and the planes match JAX at 1e-5, since both
  drop the same queries by the same stable order;
- ``attn_value_bf16`` and ``compute_dtype="bfloat16"``: JAX and the port
  round in other places (JAX gathers bf16 corners and sums them in bf16;
  the port rounds the value once and sums in fp32; XLA's and oneDNN's bf16
  convolutions round their sums differently), so the planes within 2e-2 of
  their scale and the features within 3e-2 of theirs. That tolerance is
  wider than the rounding itself, so the test also holds that with
  ``attn_value_bf16`` every MSDA call takes a bf16-representable value, and
  without it none does.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.ops import msda as jmsda
from selfocc_tpu_torch import train as ttrain_driver
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.ops import msda
from test_torch_port_models import jax_variable_shapes, random_variables
from test_torch_port_train import perturb
from utils_tiny import make_cameras, tiny_config
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy
SHAPES = ((9, 11), (5, 6))


def assert_scaled_close(got, ref, rtol, name=""):
    """max|got - ref| <= rtol * max|ref| (+ 1e-7)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    tol = rtol * float(np.abs(ref).max()) + 1e-7
    assert err <= tol, f"{name}: max|d| {err:.3e} > {tol:.3e}"


def shared_case(seed, B=2, Q=37, H=4, D=8, P=3, shapes=SHAPES):
    """numpy inputs of the head-shared op, locations in [-0.1, 1.1]; a
    location within 1e-3 px of a pixel knot moves 2e-3 px off it (the
    bilinear slope jumps there, and the two packages reach the pixel
    through differently rounded expressions)."""
    rng = np.random.RandomState(seed)
    L = sum(h * w for h, w in shapes)
    value = rng.randn(B, L, H, D).astype(np.float32)
    loc = (rng.rand(B, Q, len(shapes), P, 2) * 1.2 - 0.1).astype(np.float32)
    size = np.array([[w, h] for h, w in shapes], np.float32)[:, None, :]
    px = loc * size - 0.5
    frac = px - np.floor(px)
    loc = np.where((frac < 1e-3) | (frac > 1 - 1e-3), loc + 2e-3 / size,
                   loc).astype(np.float32)
    att = rng.rand(B, Q, H, len(shapes) * P).astype(np.float32)
    att = np.exp(att) / np.exp(att).sum(-1, keepdims=True)
    att = att.reshape(B, Q, H, len(shapes), P).astype(np.float32)
    cot = rng.randn(B, Q, H * D).astype(np.float32)
    return value, loc, att, cot


@functools.lru_cache(maxsize=None)
def jax_shared_vjp(bundle):
    """Jitted forward and vjp of the JAX head-shared op (head 0's
    locations, here every head's)."""
    def f(v, loc, att, cot):
        def op(v_, loc_, att_):
            B, Q, Lv, P, _ = loc_.shape
            loc6 = jnp.broadcast_to(loc_[:, :, None],
                                    (B, Q, att_.shape[2], Lv, P, 2))
            return jmsda.ms_deform_attn(v_, SHAPES, loc6, att_,
                                        shared_locations=True,
                                        bundle_corners=bundle)
        out, vjp = jax.vjp(op, v, loc, att)
        return out, vjp(cot)
    return jax.jit(f)


@pytest.mark.parametrize("bundle,fwd_rtol,grad_rtols,width", [
    ("full", 1e-5, (1e-5, 1e-5, 1e-5), (4, 8)),
    ("none", 2e-2, (4e-2, 2e-2, 2e-2), (4, 8)),
    # H * D / 4 = 15 float4s, no multiple of the kernels' 8-lane groups:
    # the width csrc/msda_shared.cu's masked tail and segmented weight
    # sums are held to on the card
    ("full", 1e-5, (1e-5, 1e-5, 1e-5), (5, 12))],
    ids=["fp32-payloads", "bf16-payloads", "fp32-payloads-H5-D12"])
def test_shared_op_matches_jax(bundle, fwd_rtol, grad_rtols, width):
    H, D = width
    value, loc, att, cot = shared_case(0, H=H, D=D)
    ref, ref_grads = jax_shared_vjp(bundle)(value, loc, att, cot)
    got = msda.ms_deform_attn_shared_plain(T(value), SHAPES, T(loc), T(att))
    assert_scaled_close(got.numpy(), ref, fwd_rtol, "forward")
    grads = msda.msda_shared_bwd_plain(T(value), SHAPES, T(loc), T(att),
                                       T(cot))
    for g, r, rtol, name in zip(grads, ref_grads, grad_rtols,
                                ("value", "locations", "weights")):
        assert_scaled_close(g.numpy(), r, rtol, name)


def test_shared_plain_equals_per_head_plain_on_broadcast_locations():
    value, loc, att, cot = (T(x) for x in shared_case(1, H=6, D=4, P=5))
    H = att.shape[2]
    loc6 = loc[:, :, None].expand(-1, -1, H, -1, -1, -1).contiguous()
    shared = msda.ms_deform_attn_shared_plain(value, SHAPES, loc, att)
    per_head = msda.ms_deform_attn_plain(value, SHAPES, loc6, att)
    # one grid_sample over all heads' channels against one per head: the
    # same bilinear terms, the same sums
    assert torch.equal(shared, per_head)
    gs = msda.msda_shared_bwd_plain(value, SHAPES, loc, att, cot)
    gh = msda.msda_bwd_plain(value, SHAPES, loc6, att, cot)
    # the shared location gradient is the per-head one summed over heads
    for g, r, name in zip(gs, (gh[0], gh[1].sum(2), gh[2]),
                          ("value", "locations", "weights")):
        assert_scaled_close(g.numpy(), r.numpy(), 1e-6, name)
    # the autograd Function takes the plain versions on CPU tensors
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, att)]
    out = msda.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2],
                              shared_locations=True)
    assert torch.equal(out.detach(), shared)
    out.backward(cot)
    for leaf, g in zip(leaves, gs):
        assert torch.equal(leaf.grad, g)
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, SHAPES, loc6, att, shared_locations=True)


# ------------------------------------------------------------- compaction

COMPACT_CASES = [dict(cross_visible_capacity=0.75),
                 dict(cross_visible_capacity=0.75, shared_locations=True,
                      msda_bundle="full")]
COMPACT_IDS = ["per-head", "shared"]


@functools.lru_cache(maxsize=None)
def tiny_variables():
    """Random numpy weights of the tiny model on the tiny backbone: the
    options under test leave every parameter's shape as it is."""
    cfg = tiny_config(backbone="tiny")
    shapes = jax_variable_shapes(JSegmentor(cfg=cfg.model), cfg)
    return random_variables(shapes, np.random.RandomState(0))


@functools.lru_cache(maxsize=None)
def jax_representation(enc_items):
    """The JAX tiny encoder with the options ``enc_items`` (sorted (key,
    value) pairs), jitted once per option set: (variables, imgs,
    lidar2img) -> (planes, sown intermediates)."""
    cfg = tiny_config(backbone="tiny", enc_kw=dict(enc_items))
    jmodel = JSegmentor(cfg=cfg.model)
    return jax.jit(lambda v, i, m: jmodel.apply(
        v, i, m, train=False, method="get_representation",
        mutable=["consts", "intermediates"]))


def overhead_lidar2img(img_hw=(32, 48), height=30.0):
    """(4, 4) lidar-to-image of a camera ``height`` m above the origin
    looking straight down (image x along +x, y along -y): it sees every
    query of the tiny planes."""
    H, W = img_hw
    K = np.array([[0.8 * W, 0, W / 2, 0], [0, 0.8 * W, H / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    cam2lidar = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, height],
                          [0, 0, 0, 1]], np.float64)
    return (K @ np.linalg.inv(cam2lidar)).astype(np.float32)


def encoder_inputs(seed=0, overhead=False):
    """Images and lidar-to-image matrices of the tiny rig's two cameras at
    32 x 48 (``overhead``: the first looks down on the whole scene)."""
    cams = make_cameras(2, (32, 48))
    imgs = np.random.RandomState(seed).rand(1, 2, 32, 48,
                                            3).astype(np.float32)
    lidar2img = np.array(cams["lidar2img"], np.float32)
    if overhead:
        lidar2img[0, 0] = overhead_lidar2img()
    return imgs, lidar2img


def port_models(enc_kw):
    """The port's tiny model with the options ``enc_kw`` and its dense twin
    (capacity 1), both with ``tiny_variables``."""
    cfg = tiny_config(backbone="tiny", enc_kw=enc_kw)
    dense_cfg = dataclasses.replace(cfg.model, encoder=dataclasses.replace(
        cfg.model.encoder, cross_visible_capacity=1.0))
    models = []
    for model_cfg in (cfg.model, dense_cfg):
        models.append(TPVSegmentor(model_cfg).eval())
        models[-1].load_state_dict(from_jax_variables(tiny_variables()),
                                   strict=True)
    return models


def encoder_case(enc_kw, seed=0, overhead=False):
    """JAX planes (with the sown overflow counts), the port's model with
    the same weights and its dense twin, and the port's inputs."""
    imgs, lidar2img = encoder_inputs(seed, overhead)
    ref, state = jax_representation(tuple(sorted(enc_kw.items())))(
        jax.tree_util.tree_map(jnp.asarray, tiny_variables()), imgs,
        lidar2img)
    sown = {k: int(v[0]) for k, v in
            state["intermediates"].get("encoder", {}).items()}
    return ([np.asarray(r) for r in ref], sown, port_models(enc_kw),
            (T(imgs), T(lidar2img)))


@pytest.mark.parametrize("enc_kw", COMPACT_CASES, ids=COMPACT_IDS)
def test_compaction_is_exact_and_matches_jax(enc_kw):
    ref, sown, (tmodel, dense_model), inputs = encoder_case(enc_kw)
    # the compaction engaged on the hw and zh / wz planes (M < Q), and no
    # camera overflowed
    assert sorted(sown) == [f"visible_overflow_{i}" for i in range(3)]
    assert set(sown.values()) == {0}
    with torch.no_grad():
        compact = tmodel.get_representation(*inputs)
        dense = dense_model.get_representation(*inputs)
    assert [int(o) for o in tmodel.encoder.visible_overflow] == [0, 0, 0]
    assert dense_model.encoder.visible_overflow is None
    for c, d, r in zip(compact, dense, ref):
        assert torch.equal(c, d)
        assert_scaled_close(c.numpy(), r, 1e-5)


@pytest.mark.parametrize("enc_kw", COMPACT_CASES, ids=COMPACT_IDS)
def test_compaction_gradient_matches_dense(enc_kw):
    # a loss of the planes through the compact branch (argsort, gathers,
    # the rows' copy back, MSDA's backward on (cams, M) rows) against the
    # dense branch on the same weights: the same terms, summed in another
    # order where a query's offsets and weights take several cameras'
    # cotangents, so every gradient within 1e-5 of its largest magnitude
    imgs, lidar2img = (T(x) for x in encoder_inputs())
    rng = np.random.RandomState(4)
    grads, cots = [], None
    for m in port_models(enc_kw):
        planes = m.get_representation(imgs, lidar2img)
        if cots is None:
            cots = [T(rng.randn(*p.shape).astype(np.float32))
                    for p in planes]
        m.zero_grad()
        sum((p * c).sum() for p, c in zip(planes, cots)).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()
                      if p.grad is not None})
    compact, dense = grads
    assert set(compact) == set(dense)
    assert any(".attn_hw.deformable_attention.sampling_offsets" in n
               for n in dense)
    for n, ref in dense.items():
        assert_scaled_close(compact[n].numpy(), ref.numpy(), 1e-5, n)


def test_compaction_overflow_matches_jax():
    # the overhead camera sees all 289 hw and 153 zh / wz queries: 33 and
    # 25 beyond the capacities' 256 and 128 rows
    ref, sown, (tmodel, _), inputs = encoder_case(
        dict(cross_visible_capacity=0.75), seed=1, overhead=True)
    with torch.no_grad():
        got = tmodel.get_representation(*inputs)
    overflow = [int(o) for o in tmodel.encoder.visible_overflow]
    assert overflow == [sown[f"visible_overflow_{i}"] for i in range(3)]
    assert overflow == [289 - 256, 153 - 128, 153 - 128]
    for g, r in zip(got, ref):
        assert_scaled_close(g.numpy(), r, 1e-5)


def test_attn_value_bf16_matches_jax(monkeypatch):
    from selfocc_tpu_torch.models import encoder as tencoder
    ref, _, (tmodel, _), inputs = encoder_case(
        dict(attn_value_bf16=True, cross_visible_capacity=0.75), seed=2)
    seen = []

    def recording(value, *args, **kw):
        seen.append(bool(torch.equal(value, value.bfloat16().float())))
        return msda.ms_deform_attn(value, *args, **kw)
    monkeypatch.setattr(tencoder, "ms_deform_attn", recording)
    with torch.no_grad():
        got = tmodel.get_representation(*inputs)
        # every MSDA call (the self-attention and the three planes' cross-
        # attentions) took a bf16-representable value
        assert seen == [True] * 4
        for module in tmodel.modules():
            if hasattr(module, "value_bf16"):
                module.value_bf16 = False
        seen.clear()
        tmodel.get_representation(*inputs)
        # without the flag no value is
        assert seen == [False] * 4
    for g, r in zip(got, ref):
        assert_scaled_close(g.numpy(), r, 2e-2)


# ------------------------------------------------------------ bf16 compute

def bf16_case(which):
    """(JAX module, its random numpy variables, the port's module with the
    same weights, NHWC inputs) for the ResNet-50 backbone at a 64 x 96
    input, or the FPN on the tiny pyramid of a 32 x 48 input; both with
    bf16 compute."""
    from collections import OrderedDict
    from selfocc_tpu.models.fpn import FPN as JFPN
    from selfocc_tpu.models.resnet import ResNet50 as JResNet50
    from selfocc_tpu_torch import bridge
    from selfocc_tpu_torch.models.fpn import FPN
    from selfocc_tpu_torch.models.resnet import ResNet50
    rng = np.random.RandomState(3)
    if which == "resnet50":
        jmod = JResNet50(dtype=jnp.bfloat16, remat_blocks=False)
        inputs = rng.randn(1, 64, 96, 3).astype(np.float32)
        tmod = ResNet50(torch.bfloat16)
    else:
        chans = (32, 64, 128, 256)
        jmod = JFPN(in_channels=chans, out_channels=32, num_outs=4,
                    dtype=jnp.bfloat16)
        inputs = [rng.randn(1, h, w, c).astype(np.float32) for (h, w), c in
                  zip(((8, 12), (4, 6), (2, 3), (1, 2)), chans)]
        tmod = FPN(chans, 32, torch.bfloat16)
    key = jax.random.PRNGKey(0)
    train = (False,) if which == "resnet50" else ()
    np_vars = random_variables(jax.eval_shape(
        lambda: jmod.init(key, inputs, *train)), rng)
    sd = OrderedDict()
    if which == "resnet50":
        bridge._backbone(sd, np_vars["params"], np_vars["batch_stats"])
    else:
        for name, p in np_vars["params"].items():
            kind, i = name.rsplit("_", 1)
            bridge._conv(sd, f"img_neck.{kind}_convs.{i}.conv", p)
    prefix = "img_backbone." if which == "resnet50" else "img_neck."
    tmod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, *train))(
        jax.tree_util.tree_map(jnp.asarray, np_vars), inputs)
    return tmod.eval(), inputs, ref


@pytest.mark.parametrize("which", ["fpn", "resnet50"])
def test_bf16_compute_matches_jax(which):
    tmod, inputs, ref = bf16_case(which)
    nchw = (T(inputs).permute(0, 3, 1, 2) if which == "resnet50" else
            [T(x).permute(0, 3, 1, 2) for x in inputs])
    with torch.no_grad():
        got = tmod(nchw)
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        assert_scaled_close(g.float().permute(0, 2, 3, 1).numpy(),
                            np.asarray(r, np.float32), 3e-2)


def test_segmentor_computes_the_backbone_and_neck_in_bf16():
    cfg = get_config("tiny")
    for backbone, want in (("tiny", torch.float32),
                           ("resnet50", torch.bfloat16)):
        model = dataclasses.replace(
            cfg.model, compute_dtype="bfloat16", backbone_type=backbone,
            fpn_in_channels=(256, 512, 1024, 2048) if backbone == "resnet50"
            else cfg.model.fpn_in_channels)
        tmodel = TPVSegmentor(model).eval()
        imgs = torch.rand(1, 1, 32, 48, 3)
        with torch.no_grad():
            # ResNet-50 computes in bf16, TinyBackbone in fp32 (the JAX
            # package gives it no dtype), the FPN in bf16, and the features
            # reach the encoder in fp32
            stages = tmodel.img_backbone(imgs[0].permute(0, 3, 1, 2))
            assert {f.dtype for f in stages} == {want}
            assert {f.dtype for f in tmodel.img_neck(stages)} == \
                {torch.bfloat16}
            feats = tmodel.extract_img_feat(imgs)
        assert {f.dtype for f in feats} == {torch.float32}


def test_amp_sets_the_compute_dtype():
    args = ttrain_driver.parse_args(["--py-config", "tiny", "--amp"])
    assert ttrain_driver.config_of(args).model.compute_dtype == "bfloat16"
    args = ttrain_driver.parse_args(["--py-config", "tiny_fast"])
    cfg = ttrain_driver.config_of(args)
    assert cfg.model.compute_dtype is None
    assert cfg.model.encoder.shared_locations
