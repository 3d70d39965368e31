"""The UNet2D backbone (EfficientNet encoder, AdaBins decoder) and the
identity neck, against the JAX package on the CPU: the encoder at
``(0.5, 0.5)`` scaling in eval and train mode (its outputs and the updated
BatchNorm statistics, on an odd-sized input that every stride-2 block pads
asymmetrically), ``resize_bilinear_ac``, ``DecoderBN`` and ``UNet2D``; a
``tiny`` segmentor with ``backbone_type="unet2d"`` at ``(0.25, 0.35)`` and
``neck_type="identity"`` (``get_representation``, and one training step:
losses, every gradient, the BatchNorm statistics, against one jitted JAX
loss-and-grad); HF ``EfficientNetModel``'s keys into the port's encoder
(strict load, the same outputs as the JAX converter's).

Tolerances: eval-mode outputs 1e-5 of their scale; train-mode outputs 3e-5
of their scale (the batch statistics of the small maps, 12 values a
channel at the top, amplify the two packages' fp32 rounding of the
preceding convolutions: 1.0e-5 measured); running statistics rtol 1e-5,
atol 1e-6; the step's losses rtol 1e-5, and its gradients and running
statistics ``max|d| <= 1e-4 * max|ref| + 1e-7`` per tensor, as the
gradients in ``test_torch_port_train.py`` (the tiny step's top map has 4
values a channel, two cameras of 1 x 2: their batch variance amplifies the
forward's rounding, 1.4e-5 of 1.1 measured at ``top_bn``, the same with
flax's E[x^2] - E[x]^2 variance in the port).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.models import efficientnet as jeff
from selfocc_tpu.models import unet2d as junet
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import train_lib as jtrain
from selfocc_tpu.utils.effnet_import import (
    convert_hf_efficientnet as jconvert_effnet)
from selfocc_tpu_torch import bridge
from selfocc_tpu_torch import losses as tlosses
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models import efficientnet as teff
from selfocc_tpu_torch.models import unet2d as tunet
from selfocc_tpu_torch.models.fpn import IdentityNeck
from selfocc_tpu_torch.models.initializers import init_weights
from selfocc_tpu_torch.models.segmentor import TPVSegmentor, check_ported
from selfocc_tpu_torch.utils import train_lib as ttrain
from selfocc_tpu_torch.utils.effnet_import import convert_hf_efficientnet
from test_torch_port_threads import share_cores_with_xdist_workers
from test_torch_port_train import (assert_grad_close, jax_draws, no_dropout,
                                   perturb)
from test_torch_port_variants import assert_scaled_close, tiny_batch, to_np
from torch_port_jax import (memoised_jax_init, quick_apply,  # noqa: F401
                            quick_jit)

share_cores_with_xdist_workers()

T = torch.from_numpy
SMALL = (0.5, 0.5)
TINY_UNET = (0.25, 0.35)


def nchw(x):
    return T(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def randomise(module, seed):
    """Seeded JAX-like init (``init_weights``), then every parameter and
    running statistic moved off it: tensors by 0.1 of their spread,
    BatchNorm and LayerNorm scales and biases by 0.1, variances into
    [0.5, 1.5)."""
    init_weights(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            noise = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif t.dim() > 1:
                t.add_(0.1 * float(t.std()) * noise)
            elif t.is_floating_point():
                t.add_(0.1 * noise)
    return module


def detached(sd):
    """Copies of ``sd``'s tensors: JAX may read a numpy view of a torch
    buffer after the call returns, and a train-mode forward updates the
    running statistics in place."""
    return {k: v.detach().clone() for k, v in sd.items()}


def jax_encoder_variables(sd):
    """A port EfficientNet encoder's state dict as flax variables: its keys
    are HF's, so the JAX package's own converter reads it."""
    return jax.tree_util.tree_map(np.array, jconvert_effnet(detached(sd)))


def jax_decoder_variables(sd):
    """A port ``DecoderBN``'s state dict (the reference's keys) as flax
    variables, as ``tests/test_unet2d_golden.py`` converts the reference
    module's."""
    sd = {k: v.numpy() for k, v in detached(sd).items()}

    def conv(k):
        return np.ascontiguousarray(sd[f"{k}.weight"].transpose(2, 3, 1, 0))

    params, stats = {}, {}
    for name in {k.split(".")[0] for k in sd}:
        if not name.startswith("up"):
            params[name] = {"kernel": conv(name), "bias": sd[f"{name}.bias"]}
            continue
        p, b = {}, {}
        for i in (0, 1):
            c, n = f"{name}._net.{3 * i}", f"{name}._net.{3 * i + 1}"
            p[f"conv{i}"] = {"kernel": conv(c), "bias": sd[f"{c}.bias"]}
            p[f"bn{i}"] = {"scale": sd[f"{n}.weight"],
                           "bias": sd[f"{n}.bias"]}
            b[f"bn{i}"] = {"mean": sd[f"{n}.running_mean"],
                           "var": sd[f"{n}.running_var"]}
        params[name], stats[name] = p, b
    return {"params": params, "batch_stats": stats}


def jax_unet_variables(model):
    """A port ``UNet2D``'s weights as the flax ``UNet2D``'s variables."""
    sd = model.state_dict()
    enc = jax_encoder_variables(strip_prefix(sd, "encoder"))
    dec = jax_decoder_variables(strip_prefix(sd, "decoder"))
    return {"params": {"encoder": enc["params"], "decoder": dec["params"]},
            "batch_stats": {"encoder": enc["batch_stats"],
                            "decoder": dec["batch_stats"]}}


def strip_prefix(sd, key):
    return {k[len(key) + 1:]: v for k, v in sd.items()
            if k.startswith(key + ".")}


def encoder_state_dict(params, stats):
    """flax encoder variables back in the port's keys (the bridge's)."""
    sd = {}
    bridge.efficientnet(sd, "e", params, stats)
    return strip_prefix(sd, "e")


def decoder_state_dict(params, stats):
    sd = {}
    bridge.adabins_decoder(sd, "d", params, stats)
    return strip_prefix(sd, "d")


def assert_stats_close(got_module, ref_sd):
    got = got_module.state_dict()
    keys = [k for k in got if "running" in k]
    assert keys and set(keys) <= set(ref_sd)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), ref_sd[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def tiny_unet(cfg):
    """``cfg`` (either package's ``tiny``) on the UNet2D backbone with the
    identity neck, as a user's variant config builds it."""
    m = dataclasses.replace(
        cfg.model, backbone_type="unet2d", neck_type="identity",
        fpn_in_channels=(cfg.model.embed_dims,) * 4, unet_scaling=TINY_UNET)
    return dataclasses.replace(cfg, model=m)


# ------------------------------------------------------------ encoder
ODD_INPUT = (2, 65, 97, 3)   # every stride-2 block pads an odd size


@pytest.fixture(scope="module")
def encoder_case():
    """A randomised port (0.5, 0.5) encoder, its weights as the JAX
    encoder's variables, and an odd-sized input."""
    tm = randomise(teff.EfficientNetEncoder(teff.EfficientNetConfig(*SMALL)),
                   0)
    x = np.random.RandomState(0).randn(*ODD_INPUT).astype(np.float32)
    return tm, jax_encoder_variables(tm.state_dict()), x


def encoder_taps(tm, x, train):
    with torch.no_grad():
        stem, stages, top = tm.train(train)(nchw(x))
    return [stem] + stages + [top]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_efficientnet_encoder_matches_jax(encoder_case, train):
    tm, jvars, x = encoder_case
    jm = jeff.EfficientNetEncoder(jeff.EfficientNetConfig(*SMALL))
    tm = copy.deepcopy(tm)
    got = encoder_taps(tm, x, train)
    if train:
        (stem, stages, top), mut = quick_apply(
            jm, jvars, x, train=True, mutable=["batch_stats"])
    else:
        stem, stages, top = quick_apply(jm, jvars, x, train=False)
    assert len(got) == len(stages) + 2 == 9
    for i, (a, b) in enumerate(zip(got, [stem] + list(stages) + [top])):
        assert_scaled_close(nhwc(a), b, 3e-5 if train else 1e-5, f"tap {i}")
    if train:
        assert_stats_close(tm, encoder_state_dict(
            jvars["params"], to_np(mut["batch_stats"])))


# ------------------------------------------------------------ decoder
@pytest.mark.parametrize("size", [(10, 14), (9, 13), (3, 4), (5, 7), (1, 2)])
def test_resize_bilinear_ac_matches_jax(size):
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    got = tunet.resize_bilinear_ac(nchw(x), *size)
    ref = junet.resize_bilinear_ac(jnp.asarray(x), *size)
    assert_scaled_close(nhwc(got), ref, 1e-6, f"{size}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_decoder_bn_matches_jax(train):
    # five taps at strides 2 .. 32 of a 64 x 96 image, B7-like ratios
    rng = np.random.RandomState(2)
    taps = [rng.randn(2, 64 // s, 96 // s, c).astype(np.float32)
            for s, c in zip((2, 4, 8, 16, 32), (16, 24, 40, 112, 64))]
    td = randomise(tunet.DecoderBN(16, 64, (16, 24, 40, 112)), 1)
    jvars = jax_decoder_variables(td.state_dict())
    jd = junet.DecoderBN(out_feature=16, num_features=64)
    if train:
        ref, mut = quick_apply(jd, jvars, taps, train=True,
                               mutable=["batch_stats"])
    else:
        ref = quick_apply(jd, jvars, taps, train=False)
    with torch.no_grad():
        got = td.train(train)([nchw(t) for t in taps])
    assert [tuple(g.shape[-2:]) for g in got] == [(32, 48), (16, 24),
                                                  (8, 12), (4, 6)]
    for g, r, name in zip(got, ref, ("1_2", "1_4", "1_8", "1_16")):
        assert_scaled_close(nhwc(g), r, 3e-5 if train else 1e-5, name)
    if train:
        assert_stats_close(td, decoder_state_dict(
            jvars["params"], to_np(mut["batch_stats"])))


def test_unet2d_matches_jax():
    x = np.random.RandomState(3).rand(2, 64, 96, 3).astype(np.float32)
    tm = randomise(tunet.UNet2D(16, teff.EfficientNetConfig(*TINY_UNET)), 2)
    jm = junet.UNet2D(out_feature=16,
                      encoder_cfg=jeff.EfficientNetConfig(*TINY_UNET))
    ref = quick_apply(jm, jax_unet_variables(tm), x, train=False)
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 32, 48), (2, 16, 16, 24), (2, 16, 8, 12), (2, 16, 4, 6)]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_scaled_close(nhwc(g), r, 1e-5, f"level {i}")


# ------------------------------------------------------------ tiny model
@pytest.mark.parametrize("option,value", [
    ("backbone_type", "unet2d"), ("neck_type", "identity")])
def test_unet_options_are_ported(option, value):
    # the JAX package's own config with the option: check_ported lets it
    # through and the segmentor builds it
    cfg = dataclasses.replace(jget_config("tiny").model, **{option: value})
    check_ported(cfg)
    model = TPVSegmentor(dataclasses.replace(get_config("tiny").model,
                                             **{option: value}))
    if option == "neck_type":
        assert isinstance(model.img_neck, IdentityNeck)
        assert not list(model.img_neck.parameters())
    else:
        assert isinstance(model.img_backbone, tunet.UNet2D)


@pytest.fixture(scope="module")
def unet_step():
    """One JAX ``tiny`` UNet2D loss-and-grad (dropout 0) and its eval-mode
    representation, in one ``quick_jit``; the port's on the same weights
    and draws. The JAX variables: the plain ``tiny`` model's init (the
    memoised ``init_variables`` that ``test_torch_port_train.py`` also
    runs: the lifter, encoder, head and geometry tables are the same, only
    the backbone and neck differ) with its backbone and FPN swapped for a
    randomised port UNet2D's weights, every other parameter perturbed."""
    base = no_dropout(jget_config("tiny"))
    cfg = no_dropout(tiny_unet(jget_config("tiny")))
    tcfg = no_dropout(tiny_unet(get_config("tiny")))
    batch = tiny_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jeval.init_variables(JSegmentor(cfg=base.model), base,
                                     jbatch)
    params = {k: v for k, v in to_np(variables["params"]).items()
              if k not in ("img_backbone", "img_neck")}
    params = perturb(params, np.random.RandomState(0))
    unet = randomise(tunet.UNet2D(32, teff.EfficientNetConfig(*TINY_UNET)),
                     3)
    uvars = jax_unet_variables(unet)
    np_vars = {"params": dict(params, img_backbone=uvars["params"]),
               "batch_stats": {"img_backbone": uvars["batch_stats"]}}
    jmodel = JSegmentor(cfg=cfg.model)
    jkey = jax.random.PRNGKey(3)
    compute = jtrain.make_loss_fn(jmodel, cfg)

    def rep_and_step(p, bs, consts, b, key):
        rep = jmodel.apply({"params": p, "batch_stats": bs,
                            "consts": consts}, b["imgs"], b["lidar2img"],
                           train=False, method="get_representation")
        return rep, jax.value_and_grad(compute, has_aux=True)(
            p, bs, consts, b, key, 0)

    rep, ((tot, (ldict, new_bs)), grads) = quick_jit(
        rep_and_step, np_vars["params"], np_vars["batch_stats"],
        variables["consts"], jbatch, jkey)
    jres = {"rep": [np.asarray(p) for p in rep], "total": float(tot),
            "losses": {k: float(v) for k, v in ldict.items()},
            "grads": from_jax_variables({"params": to_np(grads)}),
            "stats": from_jax_variables({"params": np_vars["params"],
                                         "batch_stats": to_np(new_bs)})}
    tmodel = TPVSegmentor(tcfg.model)
    tmodel.load_state_dict(from_jax_variables(np_vars), strict=True)
    tbatch = {k: T(v.copy()) for k, v in batch.items()}
    with torch.no_grad():
        trep = tmodel.eval().get_representation(tbatch["imgs"],
                                                tbatch["lidar2img"])
    tmodel.train()
    out = tmodel(tbatch["imgs"], tbatch["lidar2img"],
                 tbatch[tcfg.model.head.trans_kw], train=True,
                 draws=jax_draws(jkey, cfg), **ttrain.aug_kwargs(tbatch))
    ttot, tldict = tlosses.MultiLoss(tcfg.loss_cfgs)(
        ttrain.build_loss_inputs(tcfg, out, tbatch))
    ttot.backward()
    return jres, tmodel, [p.numpy() for p in trep], float(ttot.detach()), {
        k: float(v.detach()) for k, v in tldict.items()}


def test_tiny_unet_representation_matches_jax(unet_step):
    jres, _, rep, _, _ = unet_step
    assert len(rep) == len(jres["rep"]) == 3
    for i, (a, b) in enumerate(zip(rep, jres["rep"])):
        assert_scaled_close(a, b, 1e-5, f"plane {i}")


def test_tiny_unet_losses_match_jax(unet_step):
    jres, _, _, total, losses = unet_step
    assert set(losses) == set(jres["losses"])
    for k, v in jres["losses"].items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total, jres["total"], rtol=1e-5)


def test_tiny_unet_gradients_match_jax(unet_step):
    jres, tmodel, _, _, _ = unet_step
    named = dict(tmodel.named_parameters())
    assert set(named) == set(jres["grads"])
    assert any(k.startswith("img_backbone.encoder.encoder.blocks.")
               for k in named)
    for name, g in jres["grads"].items():
        assert named[name].grad is not None, name
        assert_grad_close(named[name].grad.numpy(), g.numpy(), name)


def test_tiny_unet_batchnorm_stats_match_jax(unet_step):
    # the train-mode forward's running statistics (momentum 0.99 in the
    # encoder, 0.9 in the decoder) against the JAX step's batch_stats
    jres, tmodel, _, _, _ = unet_step
    stats = {k: v for k, v in tmodel.state_dict().items() if "running" in k}
    assert any(".decoder.up2." in k for k in stats)
    for k, v in stats.items():
        assert_grad_close(v.numpy(), jres["stats"][k].numpy(), k)


def test_frozen_unet_backbone_gets_no_gradient():
    cfg = tiny_unet(get_config("tiny"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, freeze_img_backbone=True))
    model = TPVSegmentor(cfg.model).train()
    batch = {k: T(v.copy()) for k, v in tiny_batch(cfg).items()}
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "img_backbone" in k and "running" in k}
    feats = model.extract_img_feat(batch["imgs"])
    assert not any(f.requires_grad for f in feats)
    # BatchNorm statistics still update, as the reference's do
    after = model.state_dict()
    assert any(not torch.equal(after[k], v) for k, v in before.items())


# ------------------------------------------------------------ HF keys
def test_hf_efficientnet_loads_strictly_and_matches_jax_import(
        monkeypatch):
    # HF's torch modules only: transformers imports no TensorFlow then
    monkeypatch.setenv("USE_TF", "0")
    pytest.importorskip("transformers")
    from transformers import EfficientNetConfig as HFCfg
    from transformers.models.efficientnet.modeling_efficientnet import (
        EfficientNetModel)
    torch.manual_seed(0)
    hf = EfficientNetModel(HFCfg(image_size=64, hidden_dim=640,
                                 width_coefficient=SMALL[0],
                                 depth_coefficient=SMALL[1])).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.uniform_(-0.05, 0.05)
        for m in hf.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    sd = hf.state_dict()
    tm = teff.EfficientNetEncoder(teff.EfficientNetConfig(*SMALL))
    tm.load_state_dict(convert_hf_efficientnet(sd), strict=True)
    # the encoder test's input: the JAX side's compile is the one cached
    x = np.random.RandomState(5).randn(*ODD_INPUT).astype(np.float32)
    jm = jeff.EfficientNetEncoder(jeff.EfficientNetConfig(*SMALL))
    stem, stages, top = quick_apply(jm, jax_encoder_variables(sd), x,
                                    train=False)
    got = encoder_taps(tm, x, False)
    for i, (a, b) in enumerate(zip(got, [stem] + list(stages) + [top])):
        assert_scaled_close(nhwc(a), b, 1e-5, f"tap {i}")
