"""Chip smoke test of the PyTorch/CUDA port (``selfocc_tpu_torch``).

    python3 chip_smoke.py [--phases kernels,train]

Needs one CUDA card. It builds the port's CUDA kernels from ``csrc/`` (one
``nvcc`` per source, in parallel) and runs these phases; any failed check
raises and the exit code is non-zero.

- ``[kernels]``: each kernel against its plain PyTorch version at the shapes
  of its main-path calls, timed with CUDA events (median after a warm-up):
  the forwards of the eval frame (NeuS weights, MSDA hw-, zh/wz-plane
  cross- and self-attention), the backwards of the training step
  (``msda_bwd`` on the same three calls), the trilinear forward and
  backward at the main paths' own points (the first 4096-ray training
  chunk at C = 25 and C = 1, the first 32768-ray frame chunk at C = 1) and
  on uniform random points, and ``gather_rows`` on an fp32 table of
  28-byte rows. ``--baseline DIR`` (a checkout of another commit) also
  times that checkout's trilinear kernels at the main paths' points, in
  turns with this one's.
- ``[gather]``: ``gather_rows``'s own path (no production path calls it):
  one call through the public wrapper at ``tools/bench_gather.py``'s shape,
  launches counted, held against ``index_select`` (exact), then timed
  against its plain version and ``index_select``.
- ``[frame]``: one full-width ``nuscenes_occ`` depth-eval frame (6 cameras at
  384x800, 2,160,000 rays x 256 samples) through ``eval_depth``'s code path
  with seeded random weights after a cold frame; depths finite and in band,
  a 4096-ray subset on the card against the plain versions on the CPU.
- ``[train-parity]``: one ``tiny`` training step with the kernels on the card,
  rendered in checkpointed chunks of 20 rays (48 rays: the last chunk is
  padded), against the same step rendered densely with the plain versions
  on the CPU (same weights and draws, dropout 0): loss dict and every
  parameter gradient.
- ``[train]``: ``nuscenes_occ`` at full width (ResNet-50 + FPN, 4 encoder
  layers, a (25, 257, 257, 25) volume, 28,800 rays x 256 samples, the five
  losses, AdamW with clipping), synthetic batch, seeded weights: one cold
  step, then 3 measured steps (forward / backward / optimizer split by
  synchronised host clocks, peak memory, losses, grad_norm), a
  ``torch.profiler`` look at one warm step (the 15 kernels with the most
  device time, the trilinear kernels by instance), then the same step with
  one dense render
  (``train_ray_chunk = 0``): one warm-up step and one measured step.

``--phases`` runs a subset (then no result line is printed). Each path's
launch counts are set to 0 just before it runs and read just after; a
kernel of the path that was not launched fails the run (the trilinear
wrappers' counts also by instance: C = 1 ``plane``, C > 1 ``rows``). Prints a
``{"kernels": [...]}`` line, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 before
doing anything. Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time

SEED = 0
PARITY_RAY_CHUNK = 20  # tiny renders 48 rays: chunks 20, 20, 8 + 12 padded
CHUNK = 32768          # rays per render chunk (eval_depth's default)
SUBSET_RAYS = 4096
TRAIN_CHUNK_POINTS = 4096 * 256   # one training render chunk's samples
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
GRAD_RTOL = 1e-4                  # max|d| <= 1e-4 * max|ref| + 1e-7
# fp32 operations (an FMA counts 2) that MSDA needs per sampled point, once
# per point (pixel position, corner weights; the backward also scales the
# location gradient by the level size) and per (point, channel): forward,
# the 4-corner blend and the attention-weighted accumulate; backward, the
# blend, its dot with the cotangent, g * a, the 4 corner adds into
# grad_value, the x and y slopes and their accumulation
MSDA_FWD_OPS = (12, 10)
MSDA_BWD_OPS = (14, 33)
PHASES = ("kernels", "gather", "frame", "train-parity", "train")


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


def device_ms(fn, reps):
    """Device milliseconds per call of ``fn()``: the time of the CUDA
    kernels it launches (a wrapper's fills included), summed by
    ``torch.profiler`` over ``reps`` calls after a warm-up. Unlike
    ``timed`` it leaves out the gaps in which the card waits for the
    host's next launch, which dominate calls of a few tens of µs. A
    profile that recorded no device time (seen once in a run of many) is
    taken again; None if the third is empty too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    return None


def bound(nbytes, flops):
    """Least milliseconds the card could take: the larger of the bytes over
    the HBM rate and the fp32 operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def check(name, err, tol):
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol:.1e})")


def check_grads(name, got, ref):
    """Each gradient tensor within GRAD_RTOL of its reference's max;
    returns the largest absolute error."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        err = max_err(g, r)
        check(f"{name} grad {i}", err,
              GRAD_RTOL * float(r.abs().max()) + 1e-7)
        worst = max(worst, err)
    return worst


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_record(err, ms, plain_ms, bytes_flops, library_ms=None, **extra):
    b_ms, by = bound(*bytes_flops)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=by, library_ms=library_ms)
    rec.update(extra)
    return rec


def msda_case(g, device, B, Q, shapes, P, H=6, D=16):
    """Random MSDA inputs, some locations outside [0, 1]. The slope of
    bilinear interpolation jumps at integer pixel positions, and the plain
    version reaches the pixel through grid_sample's ``((2 loc - 1) + 1) w -
    1) / 2``, which rounds differently from the kernel's ``loc w - 0.5``; so
    locations within 1e-3 px of a knot are moved 2e-3 px off it, or the
    location gradients of a few thousand of the 76M points would compare
    slopes of neighbouring cells."""
    import torch
    L = sum(h * w for h, w in shapes)
    value = torch.randn((B, L, H, D), generator=g, device=device)
    loc = torch.rand((B, Q, H, len(shapes), P, 2), generator=g,
                     device=device) * 1.2 - 0.1
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=device)[:, None, :]           # (Lv, 1, 2)
    px = loc * size - 0.5
    frac = px - px.floor()
    loc = torch.where((frac < 1e-3) | (frac > 1 - 1e-3), loc + 2e-3 / size,
                      loc)
    att = torch.rand((B, Q, H, len(shapes) * P), generator=g,
                     device=device).softmax(-1)
    return value, shapes, loc, att.reshape(B, Q, H, len(shapes), P)


def msda_points(case):
    value, _, loc, _ = case
    return loc[..., 0].numel(), value.shape[3]


def render_grid_points(head, origin, direction, t_rand=None):
    """Grid-space (fractional index) sample points of rays, ray-major, as
    ``NeuSHead.render_rays`` makes them: box near / far, uniform bins
    (jittered by ``t_rand``), ``meter2grid``."""
    import torch
    from selfocc_tpu_torch.models import neus
    unit = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    near, far = neus.ray_aabb_near_far(origin, unit, head.roi_aabb,
                                       head.near_plane, head.far_plane)
    mids = neus.sample_uniform(near, far, head.num_samples, t_rand).mids
    pos = origin[:, None, :] + unit[:, None, :] * mids[..., None]
    return head.field.mapping.meter2grid(pos).reshape(-1, 3).contiguous()


def step_points(device):
    """The trilinear kernels' points on the main paths: the first 4096-ray
    chunk of the [train] step (its synthetic batch, the head's cellular
    sampler and jitter from a seeded generator; 1,048,576 points) and the
    first 32768-ray chunk of the [frame] render (the fixed eval grid, no
    jitter; 8,388,608 points)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.geometry.projection import rays_from_img2lidar
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.eval_lib import (eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("nuscenes_occ")
    h = cfg.model.head
    head = TPVSegmentor(cfg.model).head
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rays = head.ray_sampler(device, gen)
    origin, direction = rays_from_img2lidar(batch[h.trans_kw], rays)
    origin = origin[:, :, None, :].expand(direction.shape).reshape(-1, 3)
    direction = direction.reshape(-1, 3)
    n = h.train_ray_chunk
    t_rand = torch.rand((n, head.num_samples + 1), generator=gen,
                        device=device)
    train = render_grid_points(head, origin[:n], direction[:n], t_rand)
    origin, direction = rays_for_cams(eval_trans_mats(batch, cfg),
                                      eval_ray_grid(cfg, device=device))
    frame = render_grid_points(head, origin[:CHUNK], direction[:CHUNK])
    return train, frame


def corner_voxels(pts, shape):
    """The distinct in-volume corner voxels of (N, 3) points: the volume
    rows a trilinear forward must read (its bound's input bytes)."""
    import torch
    H, W, D = shape
    base = torch.floor(pts).long()
    flat = []
    for k in range(8):
        c = base + torch.tensor([k >> 2, (k >> 1) & 1, k & 1],
                                device=pts.device)
        ok = ((c >= 0) & (c < torch.tensor([H, W, D], device=pts.device))
              ).all(-1)
        flat.append(((c[:, 0] * W + c[:, 1]) * D + c[:, 2])[ok])
    return int(torch.unique(torch.cat(flat)).numel())


def trilinear_case(interp, vol, pts, g, cots=("vals", "grad0")):
    """The forward and backward kernels on one input against their plain
    versions; returns (forward error, (backward error, its tolerance),
    cotangents)."""
    import torch
    C = vol.shape[0]
    v_k, g_k = interp.trilinear_cf_with_grad_fwd(vol, pts)
    v_p, g_p = interp.trilinear_sample_cf_with_grad_plain(vol, pts)
    fwd = max(max_err(v_k, v_p), max_err(g_k, g_p))
    del v_k, g_k, v_p, g_p
    gv = (torch.randn((pts.shape[0], C), generator=g, device=pts.device)
          if "vals" in cots else None)
    gg = (torch.randn((pts.shape[0], 3), generator=g, device=pts.device)
          if "grad0" in cots else None)
    got = interp.trilinear_bwd(vol, pts, gv, gg)
    ref = interp.trilinear_bwd_plain(vol, pts, gv, gg)
    tol = GRAD_RTOL * float(ref.abs().max()) + 1e-7
    bwd = max_err(got, ref)
    return fwd, (bwd, tol), (gv, gg)


def load_baseline_interp(root):
    """``ops.interp`` of the ``selfocc_tpu_torch`` package under ``root``
    (a checkout of another commit), imported as a package of another name
    so that it builds and loads its own kernels beside this checkout's."""
    import importlib
    import importlib.util
    from pathlib import Path
    name = "baseline_selfocc_tpu_torch"
    pkg = Path(root).resolve() / "selfocc_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.interp")


def trilinear_checks(g, device, baseline=None):
    """The trilinear forward and backward at the main paths' own points
    (timed), on uniform random points as in earlier runs (timed: a second
    column), and at off-path inputs that reach every branch of the kernels
    (checked only). Forward tolerance 1e-5 abs; backward GRAD_RTOL of the
    plain gradient's max: the chains and the atomics add in another order
    than the plain version. With ``baseline`` (a checkout of another
    commit), that checkout's kernels are timed at the main paths' points in
    turns with this one's (baseline, this, this, baseline)."""
    import torch
    from selfocc_tpu_torch.ops import interp
    shape = (257, 257, 25)
    # the step's decoded volume is channel-last (field.decode); the sdf
    # queries read its first channel as a contiguous plane
    vol25 = torch.randn(shape + (25,), generator=g,
                        device=device).permute(3, 0, 1, 2)
    vol1 = interp.first_channel(vol25)
    train_pts, frame_pts = step_points(device)
    hi = torch.tensor(shape, dtype=torch.float32, device=device)
    uniform = torch.rand((CHUNK * 256, 3), generator=g, device=device) \
        * (hi + 3.0) - 1.5
    pts = {"train": train_pts, "frame": frame_pts, "uniform": uniform,
           "uniform_1m": uniform[:TRAIN_CHUNK_POINTS].contiguous()}
    voxels = {k: corner_voxels(p, shape) for k, p in pts.items()}
    log(f"  points: train chunk {train_pts.shape[0]} ({voxels['train']} "
        f"corner voxels), frame chunk {frame_pts.shape[0]} "
        f"({voxels['frame']}), uniform {uniform.shape[0]} / "
        f"{TRAIN_CHUNK_POINTS}")
    cases = {}

    def case(tag, kind, vol, key, reps):
        p = pts[key]
        n, C = p.shape[0], vol.shape[0]
        fwd, (bwd, tol), (gv, gg) = trilinear_case(interp, vol, p, g)
        check(f"trilinear_cf_with_grad_fwd ({tag})", fwd, 1e-5)
        check(f"trilinear_bwd ({tag})", bwd, tol)
        if kind == "fwd":
            rec = kernel_record(
                fwd, timed(lambda: interp.trilinear_cf_with_grad_fwd(vol, p),
                           reps),
                timed(lambda: interp.trilinear_sample_cf_with_grad_plain(
                    vol, p), 3),
                (voxels[key] * C * 4 + nbytes(p) + n * (C + 3) * 4,
                 n * (20 + 16 * C + 96)))
        else:
            rec = kernel_record(
                bwd, timed(lambda: interp.trilinear_bwd(vol, p, gv, gg),
                           reps),
                timed(lambda: interp.trilinear_bwd_plain(vol, p, gv, gg), 3),
                (nbytes(p, gv, gg, vol), n * 8 * (9 + 2 * C)))
        if kind == "fwd":
            dev = device_ms(lambda: interp.trilinear_cf_with_grad_fwd(vol, p),
                            reps)
        else:
            dev = device_ms(lambda: interp.trilinear_bwd(vol, p, gv, gg),
                            reps)
        cases[f"{kind}_{tag}"] = dict(rec, device_ms=dev, C=C, points=n)
        del gv, gg
        torch.cuda.empty_cache()

    case("c25_train", "fwd", vol25, "train", 20)
    case("c1_train", "fwd", vol1, "train", 20)
    case("c1_frame", "fwd", vol1, "frame", 10)
    case("c1_uniform", "fwd", vol1, "uniform", 10)
    case("c25_uniform", "fwd", vol25, "uniform_1m", 10)
    case("c25_train", "bwd", vol25, "train", 20)
    case("c1_train", "bwd", vol1, "train", 20)
    case("c25_uniform", "bwd", vol25, "uniform_1m", 10)
    case("c1_uniform", "bwd", vol1, "uniform_1m", 10)
    for k, r in cases.items():
        log(f"  trilinear {k}: ms {r['ms']:.4g}, device_ms "
            f"{r['device_ms']}, plain_ms "
            f"{r['plain_ms']:.4g}, bound_ms {r['bound_ms']:.4g} "
            f"({r['bound_by']})")

    # off-path inputs, checked only: every channel case of both instances
    # (C = 1; scalar rows of 2, 3, 5, 25, 28 channels; 33, past one warp of
    # channel lanes) on a small volume, rays through it and out of it,
    # uniform points with a margin outside and 1/8 of them on integer
    # knots, a ragged count; a ray whose samples all lie in one cell (every
    # lane of a warp shares every corner); each cotangent alone; the
    # training chunk in shuffled order
    small = (13, 17, 9)
    sh = torch.tensor(small, dtype=torch.float32, device=device)
    o = torch.rand((40, 3), generator=g, device=device) * sh * 0.5 + sh / 4
    d = torch.randn((40, 3), generator=g, device=device)
    t = torch.sort(torch.rand((40, 97), generator=g, device=device), -1)[0]
    ray_pts = (o[:, None] + d[:, None] / d.norm(dim=-1, keepdim=True)[
        :, None] * t[..., None] * 1.3 * float(sh.max())).reshape(-1, 3)
    uni = torch.rand((5003, 3), generator=g, device=device) * (sh + 3) - 1.5
    uni[::8] = torch.round(uni[::8])
    cell = torch.tensor([4.3, 5.1, 2.3], device=device) + 0.5 * torch.rand(
        (4099, 3), generator=g, device=device)
    for C in (1, 2, 3, 5, 25, 28, 33):
        vol = torch.randn(small + (C,), generator=g,
                          device=device).permute(3, 0, 1, 2)
        for tag, p, cots in (("rays", ray_pts, ("vals", "grad0")),
                             ("uniform + knots", uni, ("vals", "grad0")),
                             ("one cell", cell, ("vals", "grad0")),
                             ("rays, grad_vals only", ray_pts, ("vals",)),
                             ("rays, grad_grad0 only", ray_pts, ("grad0",))):
            fwd, (bwd, tol), _ = trilinear_case(interp, vol, p, g, cots)
            check(f"trilinear_cf_with_grad_fwd (C={C}, {tag}, "
                  f"N={p.shape[0]})", fwd, 1e-5)
            check(f"trilinear_bwd (C={C}, {tag})", bwd, tol)
    perm = torch.randperm(train_pts.shape[0], generator=g, device=device)
    for vol in (vol25, vol1):
        fwd, (bwd, tol), _ = trilinear_case(interp, vol, train_pts[perm], g)
        check(f"trilinear_cf_with_grad_fwd (C={vol.shape[0]}, train chunk "
              "shuffled)", fwd, 1e-5)
        check(f"trilinear_bwd (C={vol.shape[0]}, train chunk shuffled)",
              bwd, tol)
    del uniform, pts, perm
    torch.cuda.empty_cache()

    res = {}
    for name, kind, main, shape in (
            ("trilinear_cf_with_grad_fwd", "fwd", "fwd_c1_frame",
             "C=1, 8388608 frame-chunk points"),
            ("trilinear_bwd", "bwd", "bwd_c25_train",
             "C=25, 1048576 train-chunk points")):
        mine = {k: r for k, r in cases.items() if k.startswith(kind)}
        res[name] = dict(cases[main], shape=shape, cases=mine)
        res[name]["max_abs_err"] = max(r["max_abs_err"]
                                       for r in mine.values())
    if baseline is not None:
        res["trilinear_ab"] = trilinear_ab(
            load_baseline_interp(baseline), interp, vol25, train_pts,
            frame_pts, g)
    del vol25, vol1, train_pts, frame_pts
    torch.cuda.empty_cache()
    return res


def trilinear_ab(base, this, vol25, train_pts, frame_pts, g):
    """Median ms of the two checkouts' trilinear kernels at the main paths'
    points, in turns: baseline, this, this, baseline. Each gets the volume
    in the layout its own decode produces (the baseline's kernels read
    channel-first, ``kernel_volume`` marks this one's)."""
    import torch
    n = train_pts.shape[0]
    gv25 = torch.randn((n, 25), generator=g, device=train_pts.device)
    gv1 = torch.randn((n, 1), generator=g, device=train_pts.device)
    gg = torch.randn((n, 3), generator=g, device=train_pts.device)

    def calls(mod):
        layout = getattr(mod, "kernel_volume", torch.Tensor.contiguous)
        v25 = layout(vol25)
        v1 = layout(vol25[:1])
        return {
            "fwd_c25_train": lambda: mod.trilinear_cf_with_grad_fwd(
                v25, train_pts),
            "fwd_c1_train": lambda: mod.trilinear_cf_with_grad_fwd(
                v1, train_pts),
            "fwd_c1_frame": lambda: mod.trilinear_cf_with_grad_fwd(
                v1, frame_pts),
            "bwd_c25_train": lambda: mod.trilinear_bwd(v25, train_pts, gv25,
                                                       gg),
            "bwd_c1_train": lambda: mod.trilinear_bwd(v1, train_pts, gv1,
                                                      gg)}

    runs = {"baseline": [], "this": []}
    for side in ("baseline", "this", "this", "baseline"):
        fns = calls(base if side == "baseline" else this)
        runs[side].append({k: (timed(f, 20), device_ms(f, 20))
                           for k, f in fns.items()})
        del fns
        torch.cuda.empty_cache()
    out = {side: {k: sorted(r[k] for r in rs) for k in rs[0]}
           for side, rs in runs.items()}
    for k in out["this"]:
        log(f"  A/B {k} (event ms, device ms): baseline {out['baseline'][k]}"
            f", this {out['this'][k]}")
    return out


def kernel_checks(device, baseline=None):
    """Each kernel against its plain version at main-path call shapes
    (timed) and at a few off-flagship shapes (checked only); ``baseline``:
    see ``trilinear_checks``."""
    import torch
    from selfocc_tpu_torch.ops import gather_rows, msda, render_weights
    g = torch.Generator(device=device).manual_seed(SEED)
    res = {}

    # NeuS weights: one eval render chunk, incl. saturated samples
    alpha = torch.rand((CHUNK, 256), generator=g, device=device)
    alpha[::7, 100:110] = 1.0
    alpha[::5, :20] = 0.0
    err = max_err(render_weights.neus_weights_fwd(alpha),
                  render_weights.weights_from_alpha_plain(alpha))
    check("neus_weights_fwd (32768 x 256)", err, 2e-5)
    res["neus_weights_fwd"] = kernel_record(
        err, timed(lambda: render_weights.neus_weights_fwd(alpha), 20),
        timed(lambda: render_weights.weights_from_alpha_plain(alpha), 20),
        (2 * nbytes(alpha), 6 * alpha.numel()), shape="32768 x 256")

    res.update(trilinear_checks(g, device, baseline))

    # MSDA at its three main-path call shapes: the hw-plane image
    # cross-attention (6 cams, 4 FPN levels of a 384x800 input, 66049
    # queries, 8 points), the zh- and wz-plane ones (6425 queries, 48
    # points) and the TPV self-attention (78899 queries over the 3 planes,
    # 12 points); forward and backward
    fpn = ((96, 200), (48, 100), (24, 50), (12, 25))
    fwd, bwd = {}, {}
    for tag, args in (
            ("cross", (6, 66049, fpn, 8)), ("zh", (6, 6425, fpn, 48)),
            ("self", (1, 78899, ((257, 257), (25, 257), (257, 25)), 12))):
        case = msda_case(g, device, *args)
        value, shapes, loc, att = case
        pts_n, D = msda_points(case)
        o_k = msda.msda_fwd(*case)
        err = max_err(o_k, msda.ms_deform_attn_plain(*case))
        check(f"msda_fwd ({tag})", err, 1e-5)
        fwd[tag] = kernel_record(
            err, timed(lambda: msda.msda_fwd(*case), 5),
            timed(lambda: msda.ms_deform_attn_plain(*case), 3),
            (nbytes(value, loc, att, o_k),
             pts_n * (MSDA_FWD_OPS[0] + D * MSDA_FWD_OPS[1])))
        grad_out = torch.randn(o_k.shape, generator=g, device=device)
        del o_k
        torch.cuda.empty_cache()
        got = msda.msda_bwd(*case, grad_out)
        ref = msda.msda_bwd_plain(*case, grad_out)
        err = check_grads(f"msda_bwd ({tag})", got, ref)
        del got, ref
        torch.cuda.empty_cache()
        bwd[tag] = kernel_record(
            err, timed(lambda: msda.msda_bwd(*case, grad_out), 5),
            timed(lambda: msda.msda_bwd_plain(*case, grad_out), 2),
            (2 * nbytes(value, loc, att) + nbytes(grad_out),
             pts_n * (MSDA_BWD_OPS[0] + D * MSDA_BWD_OPS[1])))
        del case, value, loc, att, grad_out
        torch.cuda.empty_cache()
    for name, rec in (("msda_fwd", fwd), ("msda_bwd", bwd)):
        res[name] = dict(rec["cross"], shape="cross hw plane")
        for tag, key in (("zh", "zh"), ("self", "self_attn")):
            for k in ("ms", "plain_ms", "bound_ms"):
                res[name][f"{key}_{k}"] = rec[tag][k]
        res[name]["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())

    # off-flagship shapes the kernels also take: a ragged sample count; MSDA
    # at every instance of its kernels (float4 lanes at D = 4, 24 and 1024,
    # scalar lanes at D = 6 and 66, channel chunks at D = 66 and 1024, a
    # value 4 bytes off 16-byte alignment, query counts no multiple of the
    # block's 8-query tile); fp32 rows of a width that is no multiple of 16
    # bytes
    a = torch.rand((37, 19), generator=g, device=device)
    a[:, 5:8] = 1.0
    check("neus_weights_fwd (37 x 19)", max_err(
        render_weights.neus_weights_fwd(a),
        render_weights.weights_from_alpha_plain(a)), 2e-5)
    small4 = ((12, 10), (6, 5), (3, 3), (2, 2))
    for B, Q, H, D, shapes, P, shift in (
            (2, 37, 3, 4, ((6, 8), (3, 4)), 5, False),
            (1, 300, 8, 24, ((9, 7), (4, 5)), 3, False),
            (1, 45, 5, 6, small4, 48, False),
            (1, 19, 1, 1024, ((9, 7), (4, 5)), 3, False),
            (1, 23, 2, 66, ((9, 7), (4, 5)), 4, False),
            (2, 41, 6, 16, small4, 8, True)):
        value, shapes, loc, att = msda_case(g, device, B, Q, shapes, P, H, D)
        if shift:
            buf = torch.empty(value.numel() + 1, device=device)
            buf[1:].copy_(value.reshape(-1))
            value = buf[1:].view(value.shape)
        case = (value, shapes, loc, att)
        tag = f"H={H}, D={D}, Q={Q}" + (", value +4 bytes" if shift else "")
        check(f"msda_fwd ({tag})", max_err(
            msda.msda_fwd(*case), msda.ms_deform_attn_plain(*case)), 1e-5)
        gout = torch.randn((B, Q, H * D), generator=g, device=device)
        check_grads(f"msda_bwd ({tag})", msda.msda_bwd(*case, gout),
                    msda.msda_bwd_plain(*case, gout))
    t = torch.randn((50, 7), generator=g, device=device)
    i = torch.randint(0, 50, (512,), generator=g, device=device,
                      dtype=torch.int32)
    check("gather_rows (fp32, 28-byte rows)", max_err(
        gather_rows.gather_rows(t, i), t.index_select(0, i.long())), 0.0)
    for name, rec in res.items():
        log(f"  {name}: " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()
                                      if k.endswith("ms") and v is not None))
    return res


def reset_counts(wrappers):
    for fn in wrappers:
        fn.launches = 0
        if hasattr(fn, "plane_launches"):
            fn.plane_launches = 0


def read_counts(wrappers, path, instances=("plane",)):
    """Each wrapper's launches in the path; the trilinear wrappers' also by
    kernel instance (``plane``: C = 1, ``rows``: C > 1). Fails if a wrapper,
    or one of ``instances`` of the trilinear kernels, was not launched."""
    counts = {fn.__name__: fn.launches for fn in wrappers}
    for fn in wrappers:
        if hasattr(fn, "plane_launches"):
            kinds = {"plane": fn.plane_launches,
                     "rows": fn.launches - fn.plane_launches}
            counts.update({f"{fn.__name__}.{k}": kinds[k] for k in instances})
    log(f"  launches in the {path}: {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the {path}")
    return counts


def gather_path(device):
    """gather_rows's own path (no production path calls it): one call
    through the public wrapper at tools/bench_gather.py's default shape,
    its launches counted, held exactly against index_select; then timed."""
    import torch
    from selfocc_tpu_torch.ops import gather_rows
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    table = torch.randn((257 * 257 * 25, 200), generator=g, device=device
                        ).to(torch.bfloat16)
    idx = torch.randint(0, table.shape[0], (1 << 21,), generator=g,
                        device=device, dtype=torch.int32)
    reset_counts([gather_rows.gather_rows_fwd])
    out = gather_rows.gather_rows(table, idx)
    torch.cuda.synchronize()
    counts = read_counts([gather_rows.gather_rows_fwd], "gather phase")
    err = max_err(out, torch.index_select(table, 0, idx))
    check("gather_rows (2^21 rows of 1651225 x 200 bf16)", err, 0.0)
    rec = kernel_record(
        err, timed(lambda: gather_rows.gather_rows(table, idx), 10),
        timed(lambda: gather_rows.gather_rows_plain(table, idx), 10),
        (2 * nbytes(out) + nbytes(idx), 0),
        library_ms=timed(lambda: torch.index_select(table, 0, idx), 10),
        shape="2^21 x 200 bf16", launches=counts["gather_rows_fwd"])
    del table, idx, out
    torch.cuda.empty_cache()
    return rec


def full_frame(device):
    """One full-width nuscenes_occ frame through the eval_depth code path,
    with the launch counts of that run."""
    import torch
    from selfocc_tpu_torch import eval_depth
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    from selfocc_tpu_torch.utils.runtime import (get_dataset, get_logger,
                                                 to_device)

    cfg = get_config("nuscenes_occ")
    t0 = time.time()
    model = eval_depth.build_model(cfg, SEED, device)
    ds = get_dataset(cfg, synthetic=True)
    log(f"  model + synthetic dataset set-up {time.time() - t0:.1f}s")
    logger = get_logger()

    # a cold frame first (lazy CUDA module loading, cuDNN heuristics), then
    # the measured frame on another input, counts reset just before it
    cold = eval_depth.evaluate(cfg, model, [ds[1]], device, 1, CHUNK, logger)
    log(f"  cold frame: prepare {cold['prepare_s']:.3f}s render "
        f"{cold['render_s']:.3f}s")
    item = ds[0]
    wrappers = (render_weights.neus_weights_fwd,
                interp.trilinear_cf_with_grad_fwd, msda.msda_fwd)
    reset_counts(wrappers + (msda.msda_bwd, interp.trilinear_bwd))
    torch.cuda.reset_peak_memory_stats()
    res = eval_depth.evaluate(cfg, model, [item], device, 1, CHUNK, logger)
    launches = read_counts(wrappers, "eval frame")
    if msda.msda_bwd.launches or interp.trilinear_bwd.launches:
        raise AssertionError("the no-grad eval frame launched a backward")
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["cold"] = {k: cold[k] for k in ("prepare_s", "render_s")}

    # depth bounds: 0 <= depth <= far, in z-depth units per ray
    batch = to_device(item, device)
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
    del model, cpu_model, volume
    torch.cuda.empty_cache()
    return res


def train_parity(device):
    """One tiny step: kernels on the card vs plain versions on the CPU,
    same weights and draws, dropout 0."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.losses import MultiLoss
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    from selfocc_tpu_torch.utils.train_lib import build_loss_inputs

    cfg = get_config("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=dataclasses.replace(cfg.model.encoder,
                                               dropout=0.0)))
    h = cfg.model.head
    item = get_dataset(cfg, synthetic=True)[0]
    g = torch.Generator().manual_seed(SEED)
    R = cfg.num_cams * h.ray_number[0] * h.ray_number[1]
    draws = {"cellular": torch.rand(4, generator=g),
             "t_rand": torch.rand((R, h.num_samples + 1), generator=g),
             "bkgd": torch.rand((R, 3), generator=g)}
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(SEED))
    results = []
    for dev, chunk in ((device, PARITY_RAY_CHUNK), (torch.device("cpu"), 0)):
        m = copy.deepcopy(model).to(dev).train()
        m.head.train_ray_chunk = chunk
        batch = to_device(item, dev)
        out = m(batch["imgs"], batch["lidar2img"], batch[h.trans_kw],
                train=True, draws=draws)
        tot, ldict = MultiLoss(cfg.loss_cfgs)(
            build_loss_inputs(cfg, out, batch))
        tot.backward()
        results.append((
            {k: float(v.detach()) for k, v in ldict.items()},
            {n: p.grad.detach().cpu() for n, p in m.named_parameters()}))
    (l_k, g_k), (l_p, g_p) = results
    for k in l_p:
        err = abs(l_k[k] - l_p[k])
        check(f"tiny loss {k}", err, 1e-5 * abs(l_p[k]) + 1e-7)
    worst = 0.0
    for n in g_p:
        err = max_err(g_k[n], g_p[n])
        tol = GRAD_RTOL * float(g_p[n].abs().max()) + 1e-7
        if not err <= tol:
            raise AssertionError(f"tiny grad {n}: {err:.3e} > {tol:.3e}")
        worst = max(worst, err / tol)
    log(f"  chunks of {PARITY_RAY_CHUNK} rays on the card vs dense on the "
        f"CPU: {len(g_p)} parameter gradients within tolerance (worst "
        f"{worst:.2f} of its tolerance); losses {l_k}")
    return {"losses_cuda": l_k, "losses_cpu": l_p,
            "worst_grad_err_over_tol": worst}


def full_train(device):
    """nuscenes_occ at full width: one cold step, 3 measured steps, a
    profiled warm step, then a warm-up and a measured step with one dense
    render (no checkpointed chunks)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    from selfocc_tpu_torch.train import build_trainer
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device

    cfg = get_config("nuscenes_occ")
    t0 = time.time()
    trainer = build_trainer(cfg, SEED, device)
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    log(f"  set-up {time.time() - t0:.1f}s; train_ray_chunk "
        f"{cfg.model.head.train_ray_chunk}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    sync = torch.cuda.synchronize

    def finite(m):
        bad = [k for k, v in m.items()
               if k != "times" and not torch.isfinite(torch.as_tensor(v))]
        if bad:
            raise AssertionError(f"non-finite train metrics: {bad}")

    def show(tag, m):
        vals = {k: float(v) for k, v in m.items() if k != "times"}
        log(f"  {tag}: " + ", ".join(f"{k}={v:.6g}" for k, v in
                                     sorted(vals.items()))
            + " | " + ", ".join(f"{k}={v:.3f}" for k, v in
                                m["times"].items()))
        return vals

    t0 = time.perf_counter()
    finite(cold := trainer.step(batch, gen, sync=sync))
    cold_s = time.perf_counter() - t0
    show("cold step", cold)
    wrappers = (render_weights.neus_weights_fwd,
                interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
                msda.msda_fwd, msda.msda_bwd)
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(3):
        t0 = time.perf_counter()
        m = trainer.step(batch, gen, sync=sync)
        wall = time.perf_counter() - t0
        finite(m)
        steps.append(dict(show(f"step {i}", m), step_s=wall,
                          **m["times"]))
    launches = read_counts(wrappers, "training steps", ("plane", "rows"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: sorted(s[k] for s in steps)[1]
           for k in ("step_s", "forward_s", "backward_s", "optimizer_s")}
    log(f"  median step {med['step_s']:.3f}s (forward "
        f"{med['forward_s']:.3f}, backward {med['backward_s']:.3f}, "
        f"optimizer {med['optimizer_s']:.3f}); peak {peak:.2f} GiB")
    prof = profile_step(trainer, batch, gen, med["step_s"])

    # the same step with one dense render: does checkpointing pay for
    # itself, and would the step fit without it
    trainer.model.head.train_ray_chunk = 0
    finite(trainer.step(batch, gen, sync=sync))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = trainer.step(batch, gen, sync=sync)
    dense = dict(show("dense-render step", m),
                 step_s=time.perf_counter() - t0, **m["times"],
                 max_memory_gb=torch.cuda.max_memory_allocated() / 2**30)
    finite(m)
    trainer.model.head.train_ray_chunk = cfg.model.head.train_ray_chunk
    log(f"  dense-render step {dense['step_s']:.3f}s, peak "
        f"{dense['max_memory_gb']:.2f} GiB")
    return {"cold_step_s": cold_s, "median": med, "steps": steps,
            "max_memory_gb": peak,
            "launches_per_step": {k: v / 3 for k, v in launches.items()},
            "launches": launches, "profile": prof,
            "train_ray_chunk": cfg.model.head.train_ray_chunk,
            "dense_render_step": dense}


def profile_step(trainer, batch, gen, step_s):
    """torch.profiler over one warm step: device time by kernel (CUDA-side
    events only, so an op and the kernel it launched count once), the share
    of the backward kernels, kernel time over the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step(batch, gen, sync=torch.cuda.synchronize)
    wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = sorted((e for e in averages
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    total_us = sum(e.self_device_time_total for e in kernels)

    def share(key):
        return sum(e.self_device_time_total for e in kernels
                   if key in e.key) / max(total_us, 1)

    top = [{"name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3,
            "share": e.self_device_time_total / max(total_us, 1)}
           for e in kernels[:15]]
    res = {"profiled_wall_ms": wall_ms, "kernel_ms": total_us / 1e3,
           "kernel_launches": sum(e.count for e in kernels),
           "device_busy_share": total_us / 1e6 / step_s,
           "msda_bwd_share": share("msda_bwd_kernel"),
           "trilinear_bwd_share": share("trilinear_bwd"),
           "msda_fwd_share": share("msda_fwd_kernel"),
           "trilinear_fwd_share": share("trilinear_cf_with_grad_fwd"),
           "neus_weights_share": share("neus_weights"),
           "top": top}
    log(f"  profiled step: wall {wall_ms:.1f} ms, {res['kernel_launches']} "
        f"kernels, {total_us / 1e3:.1f} ms of kernel time "
        f"({res['device_busy_share']:.0%} of the unprofiled step); msda_bwd "
        f"{res['msda_bwd_share']:.1%}, trilinear_bwd "
        f"{res['trilinear_bwd_share']:.1%}, msda_fwd "
        f"{res['msda_fwd_share']:.1%}, trilinear fwd "
        f"{res['trilinear_fwd_share']:.1%} of kernel time")
    for t in top:
        log(f"    {t['device_ms']:9.2f} ms {t['share']:6.1%} "
            f"x{t['calls']:<5d} {t['name']}")
    # the trilinear kernels by instance: in-step ms, calls, ms per call
    tri = {}
    for e in kernels:
        m = re.search(r"trilinear_\w+_kernel", e.key)
        if m:
            t = tri.setdefault(m.group(0), {"calls": 0, "device_ms": 0.0})
            t["calls"] += e.count
            t["device_ms"] += e.self_device_time_total / 1e3
    for name, t in sorted(tri.items()):
        t["ms_per_call"] = t["device_ms"] / max(t["calls"], 1)
        log(f"    trilinear by instance: {name} x{t['calls']} "
            f"{t['device_ms']:.2f} ms ({t['ms_per_call']:.4f} ms per call)")
    res["trilinear_kernels"] = tri
    res["trilinear_ms"] = sum(t["device_ms"] for t in tri.values())
    log(f"    trilinear in the step: {res['trilinear_ms']:.2f} ms")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="a checkout of another commit: [kernels] also times "
                    "its trilinear kernels at the main paths' points, in "
                    "turns with this checkout's")
    args = ap.parse_args()
    wanted = args.phases.split(",")
    if set(wanted) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(wanted) - set(PHASES))}")
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

    runs = {"kernels": lambda: kernel_checks(device, args.baseline),
            "gather": lambda: gather_path(device),
            "frame": lambda: full_frame(device),
            "train-parity": lambda: train_parity(device),
            "train": lambda: full_train(device)}
    phases = {}
    for tag in PHASES:
        if tag not in wanted:
            continue
        log(f"[{tag}]")
        t0 = time.time()
        phases[tag] = runs[tag]()
        log(f"[{tag}] done in {time.time() - t0:.1f}s")
    if len(phases) < len(PHASES):
        log(f"partial run ({', '.join(phases)}): no result line")
        return

    kres = dict(phases["kernels"], gather_rows=phases["gather"])
    fres, tres = phases["frame"], phases["train"]
    log(f"[frame] prepare {fres['prepare_s']:.3f}s render "
        f"{fres['render_s']:.3f}s ({fres['rays'] / fres['render_s']:.0f} "
        f"rays/s), peak {fres['max_memory_gb']:.2f} GiB allocated")
    sources = {
        "neus_weights_fwd": ("neus_weights.cu",
                             "selfocc_tpu/ops/render_pallas.py:54"),
        "trilinear_cf_with_grad_fwd": ("trilinear.cu",
                                       "selfocc_tpu/ops/interp.py:159"),
        "trilinear_bwd": ("trilinear.cu", "selfocc_tpu/ops/interp.py:159"),
        "msda_fwd": ("msda.cu", "selfocc_tpu/ops/msda.py:160"),
        "msda_bwd": ("msda.cu", "selfocc_tpu/ops/msda.py:160"),
        "gather_rows": ("gather_rows.cu",
                        "selfocc_tpu/ops/gather_rows.py:82")}
    kernels = []
    for name, (src, replaces) in sources.items():
        entry = {"name": name, "route": "cuda",
                 "source": f"selfocc_tpu_torch/csrc/{src}",
                 "replaces": replaces,
                 "launches": tres["launches"].get(name)}
        for kind in ("plane", "rows"):
            if f"{name}.{kind}" in tres["launches"]:
                entry[f"launches_{kind}"] = tres["launches"][f"{name}.{kind}"]
        entry.update(kres[name])
        if name in fres["launches"]:
            entry["launches_eval_frame"] = fres["launches"][name]
        kernels.append(entry)
    print(json.dumps({
        "kernels": kernels,
        "frame": {"prepare_s": fres["prepare_s"],
                  "render_s": fres["render_s"], "rays": fres["rays"],
                  "rays_per_s": fres["rays"] / fres["render_s"],
                  "max_memory_gb": fres["max_memory_gb"],
                  "cold_frame": fres["cold"],
                  "subset_max_abs_err": fres["subset_err"]},
        "train_parity": phases["train-parity"],
        "train": {k: v for k, v in tres.items() if k != "launches"}}),
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
