"""Chip smoke test of the PyTorch/CUDA port (``selfocc_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card. It builds the port's CUDA kernels from ``csrc/``, holds
each kernel against its plain PyTorch version at the shapes of one real call
of the flagship ``nuscenes_occ`` depth eval, then runs one full-width
synthetic frame (6 cameras at 384x800, 2,160,000 rays x 256 samples) through
``selfocc_tpu_torch.eval_depth``'s code path with seeded random weights,
after one cold frame on another input that pays the one-time costs. It
checks that every kernel was launched by that run, that the depths are finite
and inside the rays' [near, far] band, and that a 4096-ray subset rendered
with the kernels on the card matches the plain versions on the CPU.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is non-zero; without a CUDA card it exits 2 before doing anything.
Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

SEED = 0
CHUNK = 32768          # rays per render chunk (eval_depth's default)
SUBSET_RAYS = 4096


def log(msg):
    print(msg, flush=True)


def timed(fn, reps, warmup=1):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def check(name, err, tol):
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol:.0e})")


def kernel_checks(device):
    """Each kernel against its plain version at flagship call shapes (timed)
    and at a few off-flagship shapes (checked only)."""
    import torch
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    g = torch.Generator(device=device).manual_seed(SEED)
    res = {}

    # kernel 1: one render chunk of NeuS alpha, incl. saturated samples
    alpha = torch.rand((CHUNK, 256), generator=g, device=device)
    alpha[::7, 100:110] = 1.0
    alpha[::5, :20] = 0.0
    w_k = render_weights.neus_weights_fwd(alpha)
    w_p = render_weights.weights_from_alpha_plain(alpha)
    err = max_err(w_k, w_p)
    check("neus_weights_fwd (32768 x 256)", err, 2e-5)
    res["neus_weights_fwd"] = dict(
        max_abs_err=err,
        ms=timed(lambda: render_weights.neus_weights_fwd(alpha), 20),
        plain_ms=timed(lambda: render_weights.weights_from_alpha_plain(alpha),
                       20))

    # kernel 2: depth-path volume (channel 0 of 257x257x25), one chunk of
    # sample points, a margin of them outside the volume
    vol = torch.randn((1, 257, 257, 25), generator=g, device=device)
    hi = torch.tensor([257.0, 257.0, 25.0], device=device)
    pts = torch.rand((CHUNK * 256, 3), generator=g, device=device) \
        * (hi + 3.0) - 1.5
    v_k, g_k = interp.trilinear_cf_with_grad_fwd(vol, pts)
    v_p, g_p = interp.trilinear_sample_cf_with_grad_plain(vol, pts)
    err = max(max_err(v_k, v_p), max_err(g_k, g_p))
    check("trilinear_cf_with_grad_fwd (C=1, 8.4M points)", err, 1e-5)
    res["trilinear_cf_with_grad_fwd"] = dict(
        max_abs_err=err,
        ms=timed(lambda: interp.trilinear_cf_with_grad_fwd(vol, pts), 10),
        plain_ms=timed(
            lambda: interp.trilinear_sample_cf_with_grad_plain(vol, pts), 3))

    # kernel 3: hw-plane image cross-attention (6 cams, 4 FPN levels of a
    # 384x800 input, 66049 queries, 8 points) and the TPV self-attention
    # (78899 queries over the 3 planes, 12 points)
    def msda_case(B, Q, shapes, P):
        L = sum(h * w for h, w in shapes)
        value = torch.randn((B, L, 6, 16), generator=g, device=device)
        loc = torch.rand((B, Q, 6, len(shapes), P, 2), generator=g,
                         device=device) * 1.2 - 0.1
        att = torch.rand((B, Q, 6, len(shapes) * P), generator=g,
                         device=device).softmax(-1)
        return value, shapes, loc, att.reshape(B, Q, 6, len(shapes), P)

    out = {}
    for tag, case in (
            ("cross", msda_case(6, 66049, ((96, 200), (48, 100), (24, 50),
                                           (12, 25)), 8)),
            ("self", msda_case(1, 78899, ((257, 257), (25, 257), (257, 25)),
                               12))):
        o_k = msda.msda_fwd(*case)
        o_p = msda.ms_deform_attn_plain(*case)
        err = max_err(o_k, o_p)
        del o_p
        check(f"msda_fwd ({tag})", err, 1e-5)
        out[tag] = dict(err=err, ms=timed(lambda: msda.msda_fwd(*case), 5),
                        plain_ms=timed(
                            lambda: msda.ms_deform_attn_plain(*case), 3))
        del case
        torch.cuda.empty_cache()

    # off-flagship shapes the kernels also take: a ragged sample count, the
    # 25-channel volume of the rgb/sem render, small and wide MSDA heads
    a = torch.rand((37, 19), generator=g, device=device)
    a[:, 5:8] = 1.0
    check("neus_weights_fwd (37 x 19)", max_err(
        render_weights.neus_weights_fwd(a),
        render_weights.weights_from_alpha_plain(a)), 2e-5)
    vol25 = torch.randn((25, 257, 257, 25), generator=g, device=device)
    p25 = pts[:100_000]
    v_k, g_k = interp.trilinear_cf_with_grad_fwd(vol25, p25)
    v_p, g_p = interp.trilinear_sample_cf_with_grad_plain(vol25, p25)
    check("trilinear_cf_with_grad_fwd (C=25)",
          max(max_err(v_k, v_p), max_err(g_k, g_p)), 1e-5)
    for B, Q, H, D, shapes, P in ((2, 37, 3, 4, ((6, 8), (3, 4)), 5),
                                  (1, 300, 8, 160, ((9, 7), (4, 5)), 3)):
        L = sum(h * w for h, w in shapes)
        value = torch.randn((B, L, H, D), generator=g, device=device)
        loc = torch.rand((B, Q, H, len(shapes), P, 2), generator=g,
                         device=device) * 1.4 - 0.2
        att = torch.rand((B, Q, H, len(shapes), P), generator=g,
                         device=device)
        case = (value, shapes, loc, att / att.sum((-1, -2), keepdim=True))
        check(f"msda_fwd (H={H}, D={D})", max_err(
            msda.msda_fwd(*case), msda.ms_deform_attn_plain(*case)), 1e-5)

    res["msda_fwd"] = dict(
        max_abs_err=max(out["cross"]["err"], out["self"]["err"]),
        ms=out["cross"]["ms"],
        plain_ms=out["cross"]["plain_ms"], self_attn_ms=out["self"]["ms"],
        self_attn_plain_ms=out["self"]["plain_ms"])
    return res


def full_frame(device):
    """One full-width nuscenes_occ frame through the eval_depth code path,
    with the launch counts of that run."""
    import torch
    from selfocc_tpu.configs.experiments import get_config
    from selfocc_tpu_torch import eval_depth
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)

    cfg = get_config("nuscenes_occ")
    t0 = time.time()
    model = eval_depth.build_model(cfg, SEED, device)
    ds = eval_depth.get_dataset(cfg, synthetic=True)
    log(f"  model + synthetic dataset set-up {time.time() - t0:.1f}s")
    logger = eval_depth.get_logger()

    # a cold frame first (lazy CUDA module loading, cuDNN heuristics), then
    # the measured frame on another input, counts reset just before it
    cold = eval_depth.evaluate(cfg, model, [ds[1]], device, 1, CHUNK, logger)
    log(f"  cold frame: prepare {cold['prepare_s']:.3f}s render "
        f"{cold['render_s']:.3f}s")
    item = ds[0]
    wrappers = (render_weights.neus_weights_fwd,
                interp.trilinear_cf_with_grad_fwd, msda.msda_fwd)
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = eval_depth.evaluate(cfg, model, [item], device, 1, CHUNK, logger)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["cold"] = {k: cold[k] for k in ("prepare_s", "render_s")}
    log(f"  launches in the frame: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the main path")

    # depth bounds: 0 <= depth <= far, in z-depth units per ray
    batch = eval_depth.to_device(item, device)
    rays = eval_ray_grid(cfg, device=device)
    origin, direction = rays_for_cams(eval_trans_mats(batch, cfg), rays)
    if origin.shape[0] != 2_160_000:
        raise AssertionError(f"{origin.shape[0]} rays, expected 2160000")
    dn = torch.linalg.norm(direction, dim=-1)
    near, far = neus.ray_aabb_near_far(origin, direction / dn[:, None],
                                       cfg.model.head.roi_aabb)
    depth = res["last_depth"].reshape(-1).to(device)
    if not bool(torch.isfinite(depth).all()):
        raise AssertionError("non-finite depth")
    if bool((depth < 0).any()) or bool((depth > far / dn * (1 + 1e-5)).any()):
        raise AssertionError("depth outside [0, far]")
    log(f"  depth finite, in [0, far]; range {float(depth.min()):.3f} .. "
        f"{float(depth.max()):.3f} m")

    # a 4096-ray subset: kernels on the card vs plain versions on the CPU
    idx = torch.linspace(0, origin.shape[0] - 1, SUBSET_RAYS,
                         device=device).long()
    o_s, d_s = origin[idx], direction[idx]
    outputs = ("depth", "acc")
    volume = ChunkedRenderer(model).prepare(batch["imgs"], batch["lidar2img"])
    gpu = ChunkedRenderer(model, chunk=SUBSET_RAYS,
                          outputs=outputs).render(volume, o_s, d_s)
    cpu_model = copy.deepcopy(model).cpu()
    cpu = ChunkedRenderer(cpu_model, chunk=SUBSET_RAYS, outputs=outputs) \
        .render(volume.cpu(), o_s.cpu(), d_s.cpu())
    sub_err = {k: float(abs(gpu[k].astype("float64") - cpu[k]).max())
               for k in outputs}
    log(f"  4096-ray subset, kernels vs plain (CPU): {sub_err}")
    if not (sub_err["depth"] <= 1e-3 and sub_err["acc"] <= 1e-4):
        raise AssertionError(f"subset render disagrees: {sub_err}")
    acc = torch.from_numpy(gpu["acc"]).to(device)
    d_sub = torch.from_numpy(gpu["depth"]).to(device)
    lo, hi = (acc * near[idx] / dn[idx]), (acc * far[idx] / dn[idx])
    if bool((d_sub < lo - 1e-3).any()) or bool((d_sub > hi + 1e-3).any()):
        raise AssertionError("subset depth outside [acc*near, acc*far]")
    res["subset_err"] = sub_err
    res["launches"] = launches
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    from selfocc_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False      # the exact tier is fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    built = _build.build_all(force=True, ptxas_verbose=True)
    log(f"[build] {len(built)} kernels in {time.time() - t0:.1f}s (parallel)")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[kernels] each against its plain version at flagship shapes")
    t0 = time.time()
    kres = kernel_checks(device)
    log(f"[kernels] done in {time.time() - t0:.1f}s")

    log("[frame] nuscenes_occ, 1 synthetic frame, full width")
    fres = full_frame(device)
    rays_per_s = fres["rays"] / fres["render_s"]
    log(f"[frame] prepare {fres['prepare_s']:.3f}s render "
        f"{fres['render_s']:.3f}s ({rays_per_s:.0f} rays/s), peak "
        f"{fres['max_memory_gb']:.2f} GiB allocated")

    sources = {"neus_weights_fwd": ("selfocc_tpu_torch/csrc/neus_weights.cu",
                                    "selfocc_tpu/ops/render_pallas.py:54"),
               "trilinear_cf_with_grad_fwd": (
                   "selfocc_tpu_torch/csrc/trilinear.cu",
                   "selfocc_tpu/ops/interp.py:159"),
               "msda_fwd": ("selfocc_tpu_torch/csrc/msda.cu",
                            "selfocc_tpu/ops/msda.py:160")}
    kernels = []
    for name, (src, replaces) in sources.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": fres["launches"][name]}
        entry.update(kres[name])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels,
                      "frame": {"prepare_s": fres["prepare_s"],
                                "render_s": fres["render_s"],
                                "rays": fres["rays"],
                                "rays_per_s": rays_per_s,
                                "max_memory_gb": fres["max_memory_gb"],
                                "cold_frame": fres["cold"],
                                "subset_max_abs_err": fres["subset_err"]}}),
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
