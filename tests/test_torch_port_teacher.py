"""The online semantic teacher (Swin + UperNet, ``--teacher-ckpt``) and the
``extra`` key maps, against the JAX package on the CPU: ``SwinBackbone`` in
both partition modes, ``adaptive_avg_pool``, ``SwinUperNet``; HF
``UperNetForSemanticSegmentation``'s keys into the port (strict load, the
same logits as the JAX converter's); ``TorchSemTeacher``'s logits and maps
against ``JaxSemTeacher`` on a 96 x 160 image; ``from_checkpoint`` from
``.pt`` and ``.safetensors`` (the port's reader against
``safetensors.numpy``'s writer and the other way round); ``load_weights
(extra=)`` against ``convert_reference_state_dict(extra=)``;
``train.main --teacher-ckpt`` filling a batch's missing ``sem_gt``; and
``tools/precompute_sem.py`` against ``tools/precompute_sem_jax.py``.

The teacher here is a small Swin (embed 16, depths 2/2/2/2, window 7) under
a 16-channel UperNet with 5 classes and random weights: the real one
resizes every image to height 512, which at Swin-T width costs minutes on
a CPU. Tolerances: features and logits 1e-5 of their scale (the resized
image's: 1e-4 of its [0, 255] scale, jax.image.resize's cubic against
torch's antialiased bicubic); class maps equal wherever the two largest
logits differ by more than 1e-4.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.models import swin as jswin
from selfocc_tpu.models import upernet as jupernet
from selfocc_tpu.utils import openseed_utils as jteacher
from selfocc_tpu.utils import swin_import as jimport
from selfocc_tpu_torch import bridge
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models import swin as tswin
from selfocc_tpu_torch.models import upernet as tupernet
from selfocc_tpu_torch.models.initializers import init_weights
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import openseed_utils as tteacher
from selfocc_tpu_torch.utils import swin_import as timport
from selfocc_tpu_torch.utils.runtime import load_weights
from test_torch_port_threads import share_cores_with_xdist_workers
from test_torch_port_variants import assert_scaled_close
from torch_port_jax import (memoised_jax_init, quick_apply,  # noqa: F401
                            quick_jit)

share_cores_with_xdist_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES, CHANNELS = 5, 16
SWIN = dict(patch_size=4, embed_dim=16, depths=(2, 2, 2, 2),
            num_heads=(1, 2, 2, 4), window_size=7)
IMG = (96, 160)


def randomise(module, seed):
    """Seeded JAX-like init, then every parameter and statistic moved off
    it (the bias tables and BatchNorms included)."""
    init_weights(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            noise = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                t.copy_(0.5 + noise.abs())
            elif name.endswith(("weight", "bias", "table", "running_mean")):
                t.add_(0.05 * noise)
    return module


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def teacher_state_dict(seed=0):
    model = tupernet.SwinUperNet(CLASSES, tswin.SwinConfig(**SWIN), CHANNELS)
    return randomise(model, seed).state_dict()


def hf_checkpoint(sd):
    """``sd`` as an HF checkpoint has it: BatchNorm counters, the
    relative-position index and an auxiliary head besides."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith("running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
        if k.endswith("relative_position_bias_table"):
            w = SWIN["window_size"]
            out[k[:-len("bias_table")] + "index"] = torch.from_numpy(
                tswin._rel_pos_index(w).astype(np.int64))
    out["auxiliary_head.classifier.weight"] = torch.zeros(CLASSES, 8, 1, 1)
    return out


def jax_logits(teacher, imgs, size):
    """``JaxSemTeacher``'s forward up to the logits (its ``_forward``
    without the argmax), NCHW."""
    x = jnp.asarray(imgs, jnp.float32)
    b, h, w, _ = x.shape
    x = jax.image.resize(x, (b, 512, int(round(512 * w / h)), 3), "cubic")
    x = (x - jnp.asarray(teacher.IMAGENET_MEAN)) / jnp.asarray(
        teacher.IMAGENET_STD)
    out = quick_jit(teacher.model.apply, teacher.variables, x)
    out = jax.image.resize(out, (b,) + tuple(size) + (out.shape[-1],),
                           "linear")
    return np.asarray(out).transpose(0, 3, 1, 2)


def assert_maps_equal_off_ties(got, ref, logits):
    """Class maps equal wherever the two largest logits differ by more
    than 1e-4."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    top2 = np.sort(np.asarray(logits), axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], ref[clear])


def images(seed, n=1, hw=IMG):
    return (np.random.RandomState(seed).rand(n, *hw, 3) * 255).astype(
        np.float32)


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("always_partition", [True, False])
def test_swin_backbone_matches_jax(always_partition):
    # window 4 over 128 x 160: the maps 32x40 .. 4x5 are padded to whole
    # windows, and at 4x5 SwinModel's semantics drop the shift
    cfg = dict(SWIN, window_size=4)
    tm = tswin.SwinBackbone(tswin.SwinConfig(**cfg), always_partition)
    randomise(tm, 3)
    x = images(4, 2, (128, 160)) / 255.0
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    jm = jswin.SwinBackbone(jswin.SwinConfig(**cfg), always_partition)
    ref = quick_apply(jm, {"params": jimport.convert_hf_swin_backbone(
        tm.state_dict())}, x)
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 32, 40), (2, 32, 16, 20), (2, 64, 8, 10), (2, 128, 4, 5)]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_scaled_close(nhwc(g), r, 1e-5, f"stage {i}")


@pytest.mark.parametrize("hw,out", [((7, 9), 1), ((7, 9), 2), ((7, 9), 3),
                                    ((7, 9), 6), ((4, 5), 6)])
def test_adaptive_avg_pool_matches_jax(hw, out):
    x = np.random.RandomState(5).randn(2, *hw, 3).astype(np.float32)
    got = tupernet.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     out)
    ref = jupernet.adaptive_avg_pool(jnp.asarray(x), out)
    assert_scaled_close(nhwc(got), ref, 1e-6, f"{hw} -> {out}")


def test_swin_upernet_matches_jax():
    # 64 x 96: the top map is 2 x 3, so the pyramid's pools of 3 and 6 are
    # resized down as well as up
    sd = teacher_state_dict(6)
    tm = tupernet.SwinUperNet(CLASSES, tswin.SwinConfig(**SWIN), CHANNELS)
    tm.load_state_dict(sd, strict=True)
    x = images(7, 2, (64, 96)) / 100.0
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    jm = jupernet.SwinUperNet(CLASSES, jswin.SwinConfig(**SWIN), CHANNELS)
    ref = quick_apply(jm, jimport.convert_hf_upernet(sd), x)
    assert got.shape == (2, CLASSES, 64, 96)
    assert_scaled_close(nhwc(got), ref, 1e-5, "logits")


def test_hf_upernet_loads_strictly_and_matches_jax_import(monkeypatch):
    # HF's torch modules only: transformers imports no TensorFlow then
    monkeypatch.setenv("USE_TF", "0")
    pytest.importorskip("transformers")
    from transformers import SwinConfig as HFSwin
    from transformers import UperNetConfig, UperNetForSemanticSegmentation
    torch.manual_seed(0)
    hf = UperNetForSemanticSegmentation(UperNetConfig(
        backbone_config=HFSwin(
            embed_dim=16, depths=[2, 2, 2, 2], num_heads=[1, 2, 2, 4],
            window_size=7, drop_path_rate=0.0,
            out_features=["stage1", "stage2", "stage3", "stage4"]),
        hidden_size=CHANNELS, num_labels=CLASSES, use_auxiliary_head=True,
        auxiliary_in_channels=64)).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.uniform_(-0.1, 0.1)
        for m in hf.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    sd = hf.state_dict()
    tm = tupernet.SwinUperNet(CLASSES, tswin.SwinConfig(**SWIN), CHANNELS)
    tm.load_state_dict(timport.convert_hf_upernet(sd), strict=True)
    # the SwinUperNet test's input: the JAX side's compile is the one cached
    x = images(8, 2, (64, 96)) / 100.0
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    jm = jupernet.SwinUperNet(CLASSES, jswin.SwinConfig(**SWIN), CHANNELS)
    ref = quick_apply(jm, jimport.convert_hf_upernet(sd), x)
    assert_scaled_close(nhwc(got), ref, 1e-5, "logits")


# ------------------------------------------------------------ the teacher
@pytest.fixture(scope="module")
def teachers():
    sd = teacher_state_dict(0)
    lut = np.array([4, 3, 2, 1, 0, 2])
    port = tteacher.TorchSemTeacher(sd, CLASSES, tswin.SwinConfig(**SWIN),
                                    CHANNELS, lut=lut)
    ref = jteacher.JaxSemTeacher(jimport.convert_hf_upernet(sd), CLASSES,
                                 jswin.SwinConfig(**SWIN), CHANNELS, lut=lut)
    return sd, port, ref


def test_teacher_logits_match_jax(teachers):
    _, port, ref = teachers
    imgs = images(9).astype(np.uint8)
    got = port.logits(imgs)
    assert got.shape == (1, CLASSES) + IMG
    assert_scaled_close(got.numpy(), jax_logits(ref, imgs, IMG), 1e-5,
                        "logits")


def test_teacher_maps_match_jax(teachers):
    # the maps through the lut, at the image's size and at another
    # uint8, as the tools read images: the JAX tool's compile is this one
    _, port, ref = teachers
    imgs = images(9).astype(np.uint8)
    logits = port.logits(imgs)
    got = port(imgs)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert_maps_equal_off_ties(got.numpy(), ref(imgs), logits.numpy())


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_teacher_from_checkpoint(teachers, tmp_path, fmt):
    sd, port, _ = teachers
    path = str(tmp_path / f"teacher.{fmt}")
    ckpt = hf_checkpoint(sd)
    if fmt == "pt":
        torch.save({"state_dict": ckpt}, path)
    else:
        timport.write_safetensors(path, ckpt)
    loaded = tteacher.TorchSemTeacher.from_checkpoint(path)
    assert loaded.model.backbone.cfg == tswin.SwinConfig(**SWIN)
    got = loaded.model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    # the JAX package's loader reads the same file to the same teacher
    jvars = jimport.load_teacher_checkpoint(path)
    ref = jax.tree_util.tree_map(np.asarray, jimport.convert_hf_upernet(sd))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, jvars), ref)


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.RandomState(10)
    arrays = {"a.f32": rng.randn(3, 4).astype(np.float32),
              "b.f16": rng.randn(5).astype(np.float16),
              "c.i64": rng.randint(-9, 9, (2, 3, 2)).astype(np.int64),
              "d.u8": rng.randint(0, 255, (7,)).astype(np.uint8),
              "e.bool": rng.rand(4) > 0.5,
              "f.scalar": np.array(3.5, np.float32)}
    theirs = str(tmp_path / "theirs.safetensors")
    st.save_file(arrays, theirs, metadata={"format": "pt"})
    got = timport.read_safetensors(theirs)
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        assert got[k].shape == a.shape
        np.testing.assert_array_equal(got[k].numpy(), a)
    ours = str(tmp_path / "ours.safetensors")
    timport.write_safetensors(ours, {k: torch.from_numpy(np.array(a))
                                     for k, a in arrays.items()})
    back = st.load_file(ours)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)
    bf = torch.randn(6, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    timport.write_safetensors(ours, {"g": bf})
    assert torch.equal(timport.read_safetensors(ours)["g"], bf)


# ------------------------------------------------------------ drivers
def test_load_weights_extra_matches_ref_import(tmp_path):
    # a fork that names the field MLP glin{i} (the JAX test's
    # test_extra_mapping_divergent_fork_naming): the port renames, the JAX
    # package maps to flax paths with a transpose; the same weights land
    from selfocc_tpu.utils import ref_import as ri
    cfg = get_config("tiny")
    src = TPVSegmentor(cfg.model)
    init_weights(src, torch.Generator().manual_seed(0))
    sd = src.state_dict()
    field = "head.model.field"
    fork_names = {f"{field}.density_net.1": f"{field}.glin0",
                  f"{field}.density_net.3": f"{field}.glin_out"}
    fork = {}
    for k, v in sd.items():
        for ours, theirs in fork_names.items():
            if k.startswith(ours + "."):
                k = theirs + k[len(ours):]
        fork[k] = v
    path = str(tmp_path / "fork.pth")
    torch.save({"state_dict": fork}, path)
    dst = TPVSegmentor(cfg.model)
    with pytest.raises(RuntimeError, match="missing"):
        load_weights(dst, torch_ckpt=path)
    extra = {f"{theirs}.{leaf}": f"{ours}.{leaf}"
             for ours, theirs in fork_names.items()
             for leaf in ("weight", "bias")}
    load_weights(dst, torch_ckpt=path, extra=extra)
    for k, v in sd.items():
        assert torch.equal(dst.state_dict()[k], v), k
    jextra = {}
    for (theirs, name) in (("head.model.field.glin0", "density_0"),
                           ("head.model.field.glin_out", "density_out")):
        jextra[f"{theirs}.weight"] = (("head", "field", name, "kernel"),
                                      ri._lin_w)
        jextra[f"{theirs}.bias"] = (("head", "field", name, "bias"), ri._arr)
    fork_field = {k: v for k, v in fork.items() if ".glin" in k}
    params, _, unmatched = ri.convert_reference_state_dict(fork_field,
                                                           extra=jextra)
    assert unmatched == []
    mapped = {}
    bridge._field(mapped, jax.tree_util.tree_map(
        np.asarray, params["head"]["field"]), "f")
    for k, v in mapped.items():
        ours = "head.model.field." + k[len("f."):]
        np.testing.assert_array_equal(dst.state_dict()[ours].numpy(),
                                      v.numpy(), err_msg=ours)


class _NoSemGt:
    """A dataset's items without ``sem_gt`` (a batch the teacher fills)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return {k: v for k, v in self.ds[i].items() if k != "sem_gt"}


def test_train_main_teacher_fills_sem_gt(teachers, tmp_path, monkeypatch):
    from selfocc_tpu_torch import train as ttrain
    from selfocc_tpu_torch.utils import runtime
    from selfocc_tpu_torch.utils.train_lib import Trainer
    sd, _, ref = teachers
    ckpt = str(tmp_path / "teacher.safetensors")
    timport.write_safetensors(ckpt, hf_checkpoint(sd))
    monkeypatch.setattr(ttrain, "get_dataset",
                        lambda *a, **k: _NoSemGt(runtime.get_dataset(*a, **k)))
    seen = []
    step = Trainer.step

    def caught(self, batch, *args, **kwargs):
        seen.append({k: batch[k].clone() for k in ("curr_imgs", "sem_gt")
                     if k in batch})
        return step(self, batch, *args, **kwargs)

    monkeypatch.setattr(Trainer, "step", caught)
    ttrain.main(["--py-config", "tiny", "--synthetic", "--max-steps", "1",
                 "--device", "cpu", "--work-dir", str(tmp_path / "w"),
                 "--teacher-ckpt", ckpt, "--prefetch", "0"])
    assert len(seen) == 1 and "sem_gt" in seen[0]
    cfg = get_config("tiny")
    curr = seen[0]["curr_imgs"].numpy()[0] * 256.0
    sem = seen[0]["sem_gt"].numpy()
    assert sem.shape == (1, cfg.num_cams) + tuple(cfg.img_size)
    jax_ref = jteacher.JaxSemTeacher(
        jimport.load_teacher_checkpoint(ckpt), CLASSES,
        jswin.SwinConfig(**SWIN), CHANNELS)
    port = tteacher.TorchSemTeacher(sd, CLASSES, tswin.SwinConfig(**SWIN),
                                    CHANNELS)
    assert_maps_equal_off_ties(sem[0], jax_ref(curr, size=cfg.img_size),
                               port.logits(curr, cfg.img_size).numpy())


def test_precompute_sem_matches_jax_tool(teachers, tmp_path, monkeypatch):
    import cv2
    sd, port, _ = teachers
    ckpt = str(tmp_path / "teacher.pt")
    torch.save(hf_checkpoint(sd), ckpt)
    # two images, one a batch: the JAX tool's compile is the maps test's
    imgs = np.concatenate([images(9), images(11)]).astype(np.uint8)
    os.makedirs(tmp_path / "imgs")
    for i, im in enumerate(imgs):
        cv2.imwrite(str(tmp_path / "imgs" / f"cam{i}.png"), im[..., ::-1])
    glob_ = str(tmp_path / "imgs" / "*.png")
    sys.path.insert(0, os.path.join(REPO, "selfocc_tpu_torch", "tools"))
    try:
        import precompute_sem as tool
    finally:
        sys.path.pop(0)
    tool.main(["--img-glob", glob_, "--out-dir", str(tmp_path / "ours"),
               "--teacher-ckpt", ckpt, "--device", "cpu", "--batch", "1"])
    spec = importlib.util.spec_from_file_location(
        "precompute_sem_jax", os.path.join(REPO, "tools",
                                           "precompute_sem_jax.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    monkeypatch.setattr(sys, "argv", [
        "precompute_sem_jax.py", "--img-glob", glob_, "--out-dir",
        str(tmp_path / "theirs"), "--teacher-ckpt", ckpt, "--batch", "1"])
    jtool.main()
    logits = port.logits(imgs).numpy()
    for i in range(len(imgs)):
        name = f"cam{i}.png.npy"
        assert_maps_equal_off_ties(
            np.load(tmp_path / "ours" / name)[None],
            np.load(tmp_path / "theirs" / name)[None], logits[i:i + 1])
