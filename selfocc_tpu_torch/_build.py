"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into its own shared library, ``_build/lib<name>.so``, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

then loaded with ``ctypes``. Sources never include PyTorch's headers, so a
build takes seconds. ``build_all`` starts one ``nvcc`` per stale source, all
at once, and waits for them together. Pointers travel as ``ctypes.c_void_p``
(``tensor.data_ptr()``) and every entry point returns ``cudaGetLastError()``,
which ``check`` turns into an exception.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("neus_weights", "trilinear", "msda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# ctypes argument types of the C entry points
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of selfocc_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not so.exists():
        return True
    src_mtime = (CSRC / f"{name}.cu").stat().st_mtime
    return so.stat().st_mtime < src_mtime


def build_all(names: Iterable[str] = KERNELS, force: bool = False,
              ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every stale kernel library in parallel (one nvcc each).

    Returns ``{name: {"seconds": wall, "log": compiler stderr}}`` for the
    sources that were compiled. Raises ``RuntimeError`` with the compiler's
    output when any build fails.
    """
    names = [n for n in names if force or _stale(n)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    procs = {}
    t0 = time.time()
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    results, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib_path(name))
        results[name] = {"seconds": time.time() - t0, "log": out}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if stale.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    point returns an ``int`` CUDA status."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(status: int, name: str):
    """Raise when a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch "
                           "(cudaGetLastError)")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda_tensor(t, name: str, dtype, ndim: Optional[int] = None):
    """Kernel-side argument checks: CUDA, dtype, rank, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
