"""ctypes bindings for the native C++ image-decode pipeline (loader.cpp) —
the port's copy of ``selfocc_tpu/native/__init__.py``.

``NativeImageLoader`` decodes batches of JPEG/PNG files on a persistent C++
thread pool directly into numpy buffers (crop/resize/BGR/normalize fused),
in place of a Python ``cv2.imread`` loop. The three training loaders
(``data/nuscenes_dataset``, ``kitti_dataset``, ``kitti_raw_dataset``) read
their images through ``get_shared_loader``. ``native_available``,
``NativeImageLoader`` and ``get_shared_loader`` are the JAX package's, word
for word; only the build differs.

The shared object is built on first import with g++ (the JAX package's
``Makefile`` flags and libraries, no nvcc) into
``selfocc_tpu_torch/_build/libselfocc_loader.so``, rebuilt when
``loader.cpp`` is newer. A process compiles to a name of its own and moves
the library into place under a file lock, so processes that import the
module together build it once. When the build fails (no compiler, no
libjpeg or libpng headers) or the library does not load, the loaders decode
with cv2, as the JAX package's do, and ``native_status()`` says which
decoder runs and why; the reason is logged once, as a warning.
"""
from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libselfocc_loader.so"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")

_log = logging.getLogger(__name__)


def build(cxx: Optional[str] = None, build_dir: Path = BUILD_DIR
          ) -> Tuple[Optional[Path], str]:
    """Compile ``loader.cpp`` into ``build_dir / LIB_NAME`` unless a library
    at least as new as the source is there. Returns ``(path, "")``, or
    ``(None, reason)`` when it cannot be built: the compiler missing, or its
    last lines of output (a missing ``jpeglib.h`` or ``png.h`` shows
    there). ``cxx`` defaults to ``$CXX`` or ``g++``."""
    cxx = cxx or os.environ.get("CXX") or "g++"
    build_dir = Path(build_dir)
    so = build_dir / LIB_NAME
    if so.exists() and so.stat().st_mtime >= SOURCE.stat().st_mtime:
        return so, ""
    compiler = shutil.which(cxx)
    if compiler is None:
        return None, f"no C++ compiler ({cxx!r} not found)"
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"{LIB_NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and so.stat().st_mtime >= SOURCE.stat().st_mtime:
            return so, ""                # another process built it
        tmp = build_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [compiler, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE),
               *LDLIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return None, f"{' '.join(cmd)}: {e}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            tail = "\n".join((proc.stderr or proc.stdout).strip()
                             .splitlines()[-8:])
            return None, (f"{' '.join(cmd)} exited {proc.returncode}:\n"
                          f"{tail}")
        os.replace(tmp, so)
    return so, ""


_STATUS = {"decoder": "cv2", "reason": "not built yet", "library": None}


def native_status() -> dict:
    """Which decoder the loaders run: ``{"decoder": "native" | "cv2",
    "reason": why cv2 ("" when native), "library": the .so or None}``."""
    return dict(_STATUS)


def _load_lib(cxx: Optional[str] = None, build_dir: Path = BUILD_DIR):
    global _STATUS
    so, reason = build(cxx, build_dir)
    lib = None
    if so is not None:
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            reason = f"loading {so}: {e}"
    if lib is None:
        _STATUS = {"decoder": "cv2", "reason": reason, "library": None}
        _log.warning("native image decoder unavailable, the loaders decode "
                     "with cv2: %s", reason)
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.c_int]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_decode_batch.restype = ctypes.c_int
    lib.loader_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
    lib.loader_image_shape.restype = ctypes.c_int
    lib.loader_image_shape.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    _STATUS = {"decoder": "native", "reason": "", "library": str(so)}
    return lib


_LIB = _load_lib()


def native_available() -> bool:
    return _LIB is not None


class NativeImageLoader:
    """Batched image decoding on a C++ thread pool (cv2 fallback)."""

    def __init__(self, num_threads: int = 0):
        self._pool = None
        if _LIB is not None:
            self._pool = _LIB.loader_create(num_threads)

    def __del__(self):
        if _LIB is not None and self._pool:
            _LIB.loader_destroy(self._pool)

    def decode_batch(self, paths: Sequence[str], crop_hw, out_hw=None,
                     to_bgr: bool = True, mean=None, std=None,
                     pad_val: float = 0.0) -> np.ndarray:
        """Decode -> top-left crop to ``crop_hw`` -> optional bilinear resize
        to ``out_hw`` -> optional normalize. Returns (N, H, W, 3) float32."""
        ch, cw = crop_hw
        oh, ow = out_hw if out_hw is not None else (ch, cw)
        n = len(paths)
        out = np.empty((n, oh, ow, 3), np.float32)
        if self._pool is not None:
            arr = (ctypes.c_char_p * n)(
                *[p.encode() for p in paths])
            mean_p = std_p = None
            if mean is not None:
                mean_arr = (ctypes.c_float * 3)(*[float(m) for m in mean])
                std_arr = (ctypes.c_float * 3)(*[float(s) for s in std])
                mean_p = ctypes.cast(mean_arr,
                                     ctypes.POINTER(ctypes.c_float))
                std_p = ctypes.cast(std_arr, ctypes.POINTER(ctypes.c_float))
            ok = _LIB.loader_decode_batch(
                self._pool, arr, n, ch, cw, oh, ow, int(to_bgr), mean_p,
                std_p, float(pad_val),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if ok == n:
                return out
        # cv2 fallback (also covers partial decode failures)
        import cv2
        for i, p in enumerate(paths):
            img = cv2.imread(p, cv2.IMREAD_COLOR).astype(np.float32)
            if not to_bgr:
                img = img[..., ::-1]
            img = img[:ch, :cw]
            if (oh, ow) != img.shape[:2]:
                img = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
            if mean is not None:
                img = (img - np.asarray(mean, np.float32)) / \
                    np.asarray(std, np.float32)
            out[i, :img.shape[0], :img.shape[1]] = img
        return out


_SHARED: Optional[NativeImageLoader] = None


def get_shared_loader() -> Optional[NativeImageLoader]:
    """Process-wide loader instance (datasets share one thread pool)."""
    global _SHARED
    if not native_available():
        return None
    if _SHARED is None:
        _SHARED = NativeImageLoader()
    return _SHARED
