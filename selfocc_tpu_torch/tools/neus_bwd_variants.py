"""Build variants of ``neus_weights_bwd``'s staged instances (above 256
samples a ray) from ``csrc/neus_weights.cu`` and time them beside the
shipped kernel on the card.

- ``shipped``: the source as it is (one pass up to 512 samples at run
  lengths K of 9, 10, 12 and 16; as many blocks as fit the card, each warp
  loading its next ray while it scans this one);
- ``k16``: one instance, K = 16, for every S in (256, 512], the tail of
  each lane's run masked;
- ``one_ray_a_warp``: a block for every 8 rays, so no warp has a next ray
  to load ahead;
- ``three_blocks``: ``__launch_bounds__`` asking for 3 resident blocks an
  SM (at most 85 registers a thread; the shipped instances take 86-128,
  2 blocks).

Each variant is checked against ``weights_grad_plain`` (1e-4 of the
largest magnitude) and timed at the importance recipe's shapes (4096 x
320, the up-sample rounds' 4096 x 271 / 287 / 303, the eval chunk's
32768 x 320): device ms (``torch.profiler``, 20 calls) in two rounds, the
variants in turn. ``ptxas -v``'s registers and spills of each variant's
staged kernels go to the log.

    python3 selfocc_tpu_torch/tools/neus_bwd_variants.py [OUT]

Run from the repository root on a machine with a CUDA card and ``nvcc``;
OUT defaults to ``work_dirs/neus_bwd_variants`` (git-ignored) and gets the
variants' sources, libraries and ``results.json``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, "selfocc_tpu_torch", "csrc", "neus_weights.cu")
SHAPES = ((4096, 320), (4096, 271), (4096, 287), (4096, 303), (32768, 320))

RUN_CHOICE = "  return k <= 10 ? k : (k <= 12 ? 12 : 16);"
GRID = "  const dim3 grid(static_cast<unsigned>(want < fit ? want : fit));"
BOUNDS = ("__global__ void __launch_bounds__(kWarpsPerBlock * 32)\n"
          "    neus_weights_bwd_staged_kernel(")


def variants(src: str) -> dict:
    for s in (RUN_CHOICE, GRID, BOUNDS):
        assert src.count(s) == 1, f"source changed: {s!r}"
    return {"shipped": src,
            "k16": src.replace(RUN_CHOICE, "  return 16;"),
            "one_ray_a_warp": src.replace(
                GRID, "  const dim3 grid(static_cast<unsigned>(want));"),
            "three_blocks": src.replace(BOUNDS, BOUNDS.replace(
                "kWarpsPerBlock * 32)", "kWarpsPerBlock * 32, 3)"))}


def build(out_dir: str) -> dict:
    from selfocc_tpu_torch import _build
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in variants(open(SOURCE).read()).items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "staged" in line and "Compiling entry" in line:
                for nxt in lines[i + 1:i + 4]:
                    if "registers" in nxt or "spill" in nxt:
                        print(f"  {name}: {line.split(chr(39))[1]} "
                              f"{nxt.strip()}", flush=True)
        lib = ctypes.CDLL(so)
        lib.neus_weights_bwd.argtypes = [_build.PTR, _build.PTR, _build.PTR,
                                         _build.I64, _build.I32, _build.PTR]
        lib.neus_weights_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from selfocc_tpu_torch import _build
    from selfocc_tpu_torch.ops import render_weights as rw
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "work_dirs", "neus_bwd_variants")
    os.makedirs(out_dir, exist_ok=True)
    if not torch.cuda.is_available():
        sys.exit("neus_bwd_variants: no CUDA device")
    print(f"card: {cs.card_name()}", flush=True)
    libs = build(out_dir)
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(cs.SEED + 7)

    def call(lib, alpha, gw):
        out = torch.empty_like(alpha)
        R, S = alpha.shape
        _build.check(lib.neus_weights_bwd(
            _build.ptr(alpha), _build.ptr(gw), _build.ptr(out), R, S,
            _build.stream_ptr(device)), "neus_weights_bwd")
        return out

    results = {name: {} for name in libs}
    for R, S in SHAPES:
        alpha = torch.rand((R, S), generator=g, device=device) ** 4
        alpha[::7, 100:110] = 1.0
        alpha[::5, :20] = 0.0
        gw = torch.randn((R, S), generator=g, device=device)
        ref = rw.weights_grad_plain(alpha, gw)
        tol = 1e-4 * float(ref.abs().max()) + 1e-7
        key = f"{R}x{S}"
        for name, lib in libs.items():
            err = cs.max_err(call(lib, alpha, gw), ref)
            cs.check(f"{name} ({R} x {S})", err, tol)
            results[name][key] = {"max_abs_err": err, "device_ms": []}
        for _ in range(2):
            for name, lib in libs.items():
                results[name][key]["device_ms"].append(cs.device_ms(
                    lambda lib=lib: call(lib, alpha, gw), 20))
        for name in libs:
            print(f"  {name} {key}: device ms "
                  f"{results[name][key]['device_ms']}", flush=True)
        del alpha, gw, ref
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
