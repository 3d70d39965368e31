"""The port's native image decoder (``selfocc_tpu_torch/native``) on the
CPU: it builds here (g++ with libjpeg and libpng), decodes as cv2 does (PNG
exactly, JPEG within 2 LSBs on the mean, normalised and resized within
0.05), falls back to cv2 where a decode fails, equals the JAX package's
``NativeImageLoader`` bit for bit (both built from one source), reports a
failed build with its reason, and its source and bindings equal their
originals apart from the leading comment and the build."""
import ast
import os

import cv2
import numpy as np
import pytest

from selfocc_tpu import native as jnative
from selfocc_tpu_torch import native
from test_torch_port_copies import _code
from test_torch_port_threads import share_cores_with_xdist_workers

share_cores_with_xdist_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = [103.53, 116.28, 123.675]
STD = [57.375, 57.12, 58.395]


@pytest.fixture()
def imgs_on_disk(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i, ext in enumerate((".png", ".png", ".jpg", ".jpg")):
        img = (rng.rand(40, 64, 3) * 255).astype(np.uint8)
        p = str(tmp_path / f"img{i}{ext}")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def test_native_builds():
    status = native.native_status()
    assert native.native_available(), status
    assert status["decoder"] == "native" and status["reason"] == ""
    assert os.path.dirname(status["library"]) == str(native.BUILD_DIR)
    assert native.get_shared_loader() is native.get_shared_loader()


def test_decode_png_equals_cv2(imgs_on_disk):
    out = native.NativeImageLoader(num_threads=2).decode_batch(
        imgs_on_disk[:2], crop_hw=(32, 48))
    assert out.shape == (2, 32, 48, 3) and out.dtype == np.float32
    for i, p in enumerate(imgs_on_disk[:2]):
        ref = cv2.imread(p, cv2.IMREAD_COLOR).astype(np.float32)[:32, :48]
        np.testing.assert_array_equal(out[i], ref)


def test_decode_jpeg_close_to_cv2(imgs_on_disk):
    # JPEG decoders may differ by a few LSBs (IDCT variants)
    out = native.NativeImageLoader(num_threads=2).decode_batch(
        imgs_on_disk[2:], crop_hw=(40, 64))
    for i, p in enumerate(imgs_on_disk[2:]):
        ref = cv2.imread(p, cv2.IMREAD_COLOR).astype(np.float32)
        assert np.mean(np.abs(out[i] - ref)) < 2.0


@pytest.mark.parametrize("which", [0, 2], ids=["png", "jpeg"])
def test_normalize_and_resize(imgs_on_disk, which):
    out = native.NativeImageLoader(num_threads=2).decode_batch(
        imgs_on_disk[which:which + 1], crop_hw=(40, 64), out_hw=(20, 32),
        mean=MEAN, std=STD)
    assert out.shape == (1, 20, 32, 3)
    ref = cv2.imread(imgs_on_disk[which], cv2.IMREAD_COLOR).astype(
        np.float32)
    ref = cv2.resize(ref, (32, 20), interpolation=cv2.INTER_LINEAR)
    ref = (ref - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
    np.testing.assert_allclose(out[0], ref, atol=0.05)


def test_missing_file_falls_back(tmp_path, imgs_on_disk):
    # a file the native decoder cannot read (a BMP: neither JPEG nor PNG
    # magic) sends the whole batch to cv2, which decodes it: finite and
    # cv2's; a file no decoder reads raises from the cv2 path
    rng = np.random.RandomState(1)
    bmp = str(tmp_path / "x.png")
    cv2.imwrite(str(tmp_path / "x.bmp"),
                (rng.rand(16, 16, 3) * 255).astype(np.uint8))
    os.replace(str(tmp_path / "x.bmp"), bmp)
    paths = [imgs_on_disk[0], bmp]
    out = native.NativeImageLoader(num_threads=2).decode_batch(
        paths, crop_hw=(16, 16))
    assert np.isfinite(out).all()
    for i, p in enumerate(paths):
        ref = cv2.imread(p, cv2.IMREAD_COLOR).astype(np.float32)[:16, :16]
        np.testing.assert_array_equal(out[i], ref)
    with pytest.raises(AttributeError):      # cv2.imread gives None
        native.NativeImageLoader(num_threads=2).decode_batch(
            [imgs_on_disk[0], str(tmp_path / "missing.png")],
            crop_hw=(16, 16))


@pytest.mark.parametrize("kw", [
    dict(crop_hw=(32, 48)),
    dict(crop_hw=(40, 64), out_hw=(20, 32), mean=MEAN, std=STD),
    dict(crop_hw=(36, 60), to_bgr=False)], ids=["crop", "resize", "rgb"])
def test_decode_batch_equals_the_jax_loader(imgs_on_disk, kw):
    assert jnative.native_available()
    got = native.NativeImageLoader(num_threads=3).decode_batch(
        imgs_on_disk, **kw)
    ref = jnative.NativeImageLoader(num_threads=3).decode_batch(
        imgs_on_disk, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_failed_build_gives_its_reason_and_the_loaders_cv2(
        tmp_path, monkeypatch, imgs_on_disk):
    from selfocc_tpu_torch.data.kitti_dataset import Kitti_One_Frame
    so, reason = native.build(cxx=str(tmp_path / "no-such-g++"),
                              build_dir=tmp_path / "b0")
    assert so is None and "no-such-g++" in reason and "not found" in reason
    so, reason = native.build(cxx="false", build_dir=tmp_path / "b1")
    assert so is None and "exited 1" in reason
    assert [n for n in os.listdir(tmp_path / "b1")
            if not n.endswith(".lock")] == []     # nothing half-built
    # the module as it is after a failed build: no library, the reason kept
    monkeypatch.setattr(native, "_STATUS", dict(native._STATUS))
    monkeypatch.setattr(native, "_SHARED", None)
    assert native._load_lib(cxx="false", build_dir=tmp_path / "b2") is None
    monkeypatch.setattr(native, "_LIB", None)
    status = native.native_status()
    assert status["decoder"] == "cv2" and "exited 1" in status["reason"]
    assert not native.native_available()
    assert native.get_shared_loader() is None

    class Frame:
        img_H, img_W = 32, 48
    got = Kitti_One_Frame.read_surround_imgs(Frame(), imgs_on_disk)
    for p, g in zip(imgs_on_disk, got):
        ref = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32)
        np.testing.assert_array_equal(g, ref[:32, :48])


def _without_leading_comment(path):
    lines = open(path).read().split("\n")
    i = 0
    while lines[i].startswith("//"):
        i += 1
    return "\n".join(lines[i:])


def test_source_and_bindings_equal_their_originals():
    assert _without_leading_comment(
        os.path.join(REPO, "selfocc_tpu_torch", "native", "loader.cpp")) == \
        _without_leading_comment(
            os.path.join(REPO, "selfocc_tpu", "native", "loader.cpp"))
    trees = [ast.parse(open(m.__file__).read()) for m in (jnative, native)]
    ref, got = (_code(t) for t in trees)
    names = ("native_available", "NativeImageLoader",
             "NativeImageLoader.__init__", "NativeImageLoader.__del__",
             "NativeImageLoader.decode_batch", "get_shared_loader")
    for k in names:
        assert got[k] == ref[k], k
    # the library's entry points take the same argument types
    for fn in ("loader_create", "loader_destroy", "loader_decode_batch",
               "loader_image_shape"):
        assert getattr(native._LIB, fn).argtypes == \
            getattr(jnative._LIB, fn).argtypes, fn
