"""Chip smoke test of the PyTorch/CUDA port (``selfocc_tpu_torch``).

    python3 chip_smoke.py [--phases kernels,train]

Needs one CUDA card. It builds the port's CUDA kernels from ``csrc/`` (one
``nvcc`` per source, in parallel) and runs these phases; any failed check
raises and the exit code is non-zero.

- ``[kernels]``: each kernel against its plain PyTorch version at the shapes
  of its main-path calls, timed with CUDA events (median after a warm-up):
  the fused NeuS render forward and backward (the geo-only eval chunk, the
  first training chunk with its strided sdf, each cotangent alone, and
  off-path shapes: no zero gradients, S = 16, 19, 100, 130, 200, 250, 255,
  ragged R, saturated samples, rows off alignment; then every output
  element written once at ragged S, none past the last row, no load past
  the inputs, the same bits on five calls), the alpha-input NeuS weights (plus
  ``weights_from_alpha``'s own path, launches counted), the forwards of the
  eval frame (MSDA hw-, zh/wz-plane cross- and self-attention), the
  backwards of the training step (``msda_bwd`` on the same three calls),
  the trilinear forward and backward at the main paths' own points (the
  first 4096-ray training chunk at C = 25 and C = 1, the first 32768-ray
  frame chunk at C = 1) and on uniform random points, the values-only
  trilinear forward ``trilinear_cf_fwd`` at the dense occupancy query's
  shape (timed against ``F.grid_sample`` too) and at off-path channel
  counts and row strides, and ``gather_rows`` on an fp32 table of 28-byte
  rows. ``--baseline DIR`` (a checkout of
  another commit) also times that checkout's trilinear kernels at the main
  paths' points, in turns with this one's (and ``[frame]`` profiles that
  checkout's eval frame beside this one's).
- ``[gather]``: ``gather_rows``'s own path (no production path calls it):
  one call through the public wrapper at ``tools/bench_gather.py``'s shape,
  launches counted, held against ``index_select`` (exact), then timed
  against its plain version and ``index_select``.
- ``[frame]``: one full-width ``nuscenes_occ`` depth-eval frame (6 cameras at
  384x800, 2,160,000 rays x 256 samples) through ``eval_depth``'s code path
  with seeded random weights after a cold frame; depths finite and in band,
  a 4096-ray subset on the card against the plain versions on the CPU;
  ``neus_render_fwd`` once per render chunk; then the frame's device work
  on a batch already on the card under
  ``torch.cuda.set_sync_debug_mode("error")``, and a profile of a warm
  frame: kernels and kernel time of the prepare, of one render chunk and
  of the whole render (with ``--baseline``, the other checkout's frame
  too, in turns).
- ``[occ]``: one full-width ``nuscenes_occ`` occupancy frame through
  ``eval_iou``'s code path with seeded weights after a cold frame: the
  Occ3D query (``--occ3d --sem``) by gather and by separable lerps and the
  OpenOccupancy 512x512x40 query against a fabricated label file, each
  with ``prepare_s``, ``query_s``, peak memory, launch counts and a
  profile of its warm device part, which also runs under
  ``torch.cuda.set_sync_debug_mode("error")``; ``trilinear_cf_fwd``
  against its plain version on a 1,048,576-point slab of the dense grid
  and at the 640,000 Occ3D points (there ``F.grid_sample`` is timed on the
  same values, without and with its channel-first copy); the Occ3D
  occupancy and classes of the kernel path against the plain path, and
  separable against gather.
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
  device time, the trilinear kernels by instance, the fused NeuS render's
  in-step ms per call), a warm step under
  ``torch.cuda.set_sync_debug_mode("error")`` without ``sync`` (as
  ``train.py`` runs it), then the same step with one dense render
  (``train_ray_chunk = 0``): one warm-up step and one measured step.
- ``[data]``: the nuScenes data path on a full-size nuScenes-format dataset
  fabricated in a temporary directory (one scene of 8 keyframes, 6 cameras
  of 900x1600 JPEGs, 34,000-point lidar sweeps, the sweeps and temporal_v2
  infos, Occ3D labels for keyframe 0, offline teacher maps), registered as
  the configs ``nuscenes_occ_fab`` / ``nuscenes_novel_depth_fab``: the
  host seconds per train item of ``build_dataset`` (with a cProfile of two
  items) and ``BatchPrefetcher``'s items/s at depth 2; 4 ``nuscenes_occ``
  steps from the loader through ``train.main`` with ``--ckpt-freq-iters
  2``, a ``--iter-resume`` run from the step-2 checkpoint (the same items;
  losses within rtol 1e-5, bit-equality reported; the two runs' weights;
  the same step's backward twice), one whole epoch for the steady step
  time (against ``[train]``'s synthetic step when it ran); one val frame
  through ``eval_depth.main`` and one through ``eval_iou.main`` (Occ3D by
  gather); ``eval_novel_depth.main`` with ``--depth-tgt raw`` and
  ``max`` (two frames: prepare and render per neighbour, rays/s, peak),
  then on one neighbour: depths finite and in band, ``max_depth`` on the
  card against the CPU plain path on 4096 rays (the same sample except
  where the two largest w / deltas lie within 1e-6), a warm render under
  ``torch.cuda.set_sync_debug_mode("error")`` and the kernels and kernel
  ms of a 32768-ray chunk and a neighbour's render with and without
  ``max_depth``. Each driver run's launch counts are reset just before it
  and read just after.

``--phases`` runs a subset (then no result line is printed). Each path's
launch counts are set to 0 just before it runs and read just after; a
kernel of the path that was not launched fails the run (the trilinear
wrappers' counts also by instance: C = 1 ``plane``, C > 1 ``rows``), and so
does a launch of ``neus_weights_fwd`` on a main path (the render is fused;
its count comes from ``weights_from_alpha``'s own path). Prints a
``{"kernels": [...]}`` line, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 before
doing anything. Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
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
# fp32 operations per sample of the fused NeuS render (a transcendental
# counts 1): forward, the cosine (5), the section estimate and its two
# sigmoids (18), alpha and its log (7), the scan and the weight (3), the
# composites and the normal (17); the backward recomputes those and adds
# G (10), the recurrence (4), the chain through the sigmoids and the
# cosine (22) and the normal's projection (17)
RENDER_FWD_OPS = 50
RENDER_BWD_OPS = 103
PHASES = ("kernels", "gather", "frame", "occ", "train-parity", "train",
          "data")
OPENOCC_PCR = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)   # 512 x 512 x 40 at 0.2
OCC_SLAB = 1 << 20    # dense-grid points held against the plain version


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


def load_baseline(root):
    """The name under which the ``selfocc_tpu_torch`` package under ``root``
    (a checkout of another commit) is imported: another name, so that it
    builds and loads its own kernels beside this checkout's."""
    import importlib.util
    from pathlib import Path
    name = "baseline_selfocc_tpu_torch"
    if name not in sys.modules:
        pkg = Path(root).resolve() / "selfocc_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return name


def trilinear_checks(g, device, baseline=None):
    """The trilinear forward and backward at the main paths' own points
    (timed), on uniform random points as in earlier runs (timed: a second
    column), and at off-path inputs that reach every branch of the kernels
    (checked only). Forward tolerance 1e-5 abs; backward GRAD_RTOL of the
    plain gradient's max: the chains and the atomics add in another order
    than the plain version. With ``baseline`` (a checkout of another
    commit), that checkout's kernels are timed at the main paths' points in
    turns with this one's (baseline, this, this, baseline)."""
    import importlib
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
            importlib.import_module(f"{load_baseline(baseline)}.ops.interp"),
            interp, vol25, train_pts,
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


def channel_close(got, ref):
    """The largest error of each channel of (N, C) values over 1e-5 of that
    channel's largest reference magnitude (<= 1 passes), and the largest
    absolute error."""
    d = (got.double() - ref.double()).abs().amax(0)
    scale = ref.double().abs().amax(0).clamp_min(1e-30)
    return float((d / (1e-5 * scale)).max()), float(d.max())


def grid_sample_of(vol_cf, pts):
    """``F.grid_sample`` computing trilinear values of a (C, H, W, D)
    volume at (N, 3) fractional (h, w, d) indices: a 5-D channel-first
    input (its own contiguous copy), align_corners=True, zeros padding; x
    <-> d, y <-> w, z <-> h, normalised as 2 i / (n - 1) - 1. Returns
    (call, copy) where call() gives (N, C) and copy() makes the input."""
    import torch
    import torch.nn.functional as F
    C, H, W, D = vol_cf.shape
    x = vol_cf.contiguous()[None]
    grid = torch.stack([2 * pts[:, 2] / (D - 1) - 1,
                        2 * pts[:, 1] / (W - 1) - 1,
                        2 * pts[:, 0] / (H - 1) - 1], -1).view(1, 1, 1, -1, 3)

    def call():
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True).view(C, -1).T

    return call, vol_cf.contiguous


def dense_grid_points(cfg, device):
    """The OpenOccupancy 512 x 512 x 40 grid of the occupancy query as
    fractional indices of ``cfg``'s decoded volume."""
    from selfocc_tpu_torch.geometry.mappings import make_mapping
    from selfocc_tpu_torch.models.heads import uniform_axes_on, uniform_grid
    xyz = uniform_grid(*uniform_axes_on(OPENOCC_PCR, 0.2, device))
    return make_mapping(**cfg.model.head.mapping_args).meter2grid(
        xyz.reshape(-1, 3)).contiguous()


def values_kernel_checks(g, device):
    """``trilinear_cf_fwd`` (the values-only forward) at the dense
    occupancy query's shape (the 512 x 512 x 40 grid, 10,485,760 points, on
    a random (25, 257, 257, 25) channel-last volume): against its plain
    version (each channel within 1e-5 of its max) and ``F.grid_sample``,
    timed (events and device time, the channel-first copy that
    ``grid_sample`` needs timed apart). Then off-path inputs, checked only:
    C = 1, 2, 3, 5, 21, 25, 33, volumes that are channel slices of wider
    rows (row stride > C), rays, uniform points with knots, one-cell runs;
    and the values agree with the with-grad forward's (the same value
    arithmetic; bit-equal cases are counted)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import interp
    cfg = get_config("nuscenes_occ")
    shape = (257, 257, 25)
    vol = torch.randn(shape + (25,), generator=g,
                      device=device).permute(3, 0, 1, 2)
    pts = dense_grid_points(cfg, device)
    n, C = pts.shape[0], vol.shape[0]
    got = interp.trilinear_cf_fwd(vol, pts)
    ref = interp.trilinear_sample_cf_plain(vol, pts)
    rel, err = channel_close(got, ref)
    check("trilinear_cf_fwd (dense query, C=25, 10485760 points) / "
          "channel tolerance", rel, 1.0)
    lib, copy = grid_sample_of(vol, pts)
    lib_rel, lib_err = channel_close(lib(), ref)
    log(f"  F.grid_sample at the dense query: {lib_err:.3e} from the "
        f"plain version ({lib_rel:.3f} of 1e-5 per channel)")
    del got, ref
    torch.cuda.empty_cache()
    voxels = corner_voxels(pts, shape)
    rec = kernel_record(
        err, timed(lambda: interp.trilinear_cf_fwd(vol, pts), 10),
        timed(lambda: interp.trilinear_sample_cf_plain(vol, pts), 3),
        (voxels * C * 4 + nbytes(pts) + n * C * 4, n * (20 + 16 * C)),
        library_ms=timed(lib, 10), library="F.grid_sample",
        library_copy_ms=timed(copy, 10),
        library_device_ms=device_ms(lib, 10),
        device_ms=device_ms(lambda: interp.trilinear_cf_fwd(vol, pts), 10),
        shape="dense query, C=25, 10485760 points", points=n, C=C,
        corner_voxels=voxels, channel_rel_err=rel)
    log(f"  trilinear_cf_fwd dense query: ms {rec['ms']:.4g}, device_ms "
        f"{rec['device_ms']}, plain_ms {rec['plain_ms']:.4g}, grid_sample "
        f"{rec['library_ms']:.4g} (+ copy {rec['library_copy_ms']:.4g}), "
        f"bound_ms {rec['bound_ms']:.4g} ({rec['bound_by']})")
    del vol, pts, lib, copy
    torch.cuda.empty_cache()

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
    same = total = 0
    for C in (1, 2, 3, 5, 21, 25, 33):
        full = torch.randn(small + (C + 4,), generator=g, device=device)
        for tag, v in (("contiguous", full[..., :C].contiguous()),
                       ("row stride", full[..., 4:])):
            v = v.permute(3, 0, 1, 2)
            for ptag, p in (("rays", ray_pts), ("uniform + knots", uni),
                            ("one cell", cell)):
                got = interp.trilinear_cf_fwd(v, p)
                err = max_err(got, interp.trilinear_sample_cf_plain(v, p))
                check(f"trilinear_cf_fwd (C={C}, {tag}, {ptag}, "
                      f"N={p.shape[0]})", err, 1e-5)
                if tag == "contiguous":
                    wg = interp.trilinear_cf_with_grad_fwd(v, p)[0]
                    check(f"  against trilinear_cf_with_grad_fwd",
                          max_err(got, wg), 1e-6)
                    same += bool(torch.equal(got, wg))
                    total += 1
    log(f"  values-only and with-grad forwards bit-equal in {same} of "
        f"{total} cases")
    torch.cuda.synchronize()
    return {"trilinear_cf_fwd": dict(rec, bit_equal_to_with_grad=[same,
                                                                  total])}


def render_case(g, device, R, S, C=1, saturated=False, misalign=False,
                zero_grads=True):
    """Inputs of the fused NeuS render on the card, laid out as the render
    passes them: sdf is ``vals[..., 0]`` of an (R, S, C) trilinear result
    (C = 1 in the geo-only eval render, 25 in training), grad (R, S, 3),
    unit directions, sorted bin edges (R, S + 1), |direction| and a 0-dim
    inv_s on the card. Every 7th sample has a zero gradient, as samples
    outside the volume do, unless ``zero_grads`` is False. ``saturated``: a
    surface in each ray at inv_s = 1e3 (behind it alpha is exactly 1), no
    zero gradients. ``misalign``:
    sdf and grad 4 bytes off 16-byte alignment (the scalar loads)."""
    import torch
    vals = 0.5 * torch.randn((R, S, C), generator=g, device=device)
    d = torch.randn((R, 3), generator=g, device=device)
    unit = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dn = torch.linalg.norm(d, dim=-1) * (0.5 + 1.5 * torch.rand(
        R, generator=g, device=device))
    near = torch.rand(R, generator=g, device=device)
    far = near + 1.0 + 5.0 * torch.rand(R, generator=g, device=device)
    u = torch.sort(torch.rand((R, S + 1), generator=g, device=device), -1)[0]
    u[:, 0], u[:, -1] = 0.0, 1.0
    edges = near[:, None] + (far - near)[:, None] * u
    grad = torch.randn((R, S, 3), generator=g, device=device)
    if saturated:
        mids = (edges[:, :-1] + edges[:, 1:]) / 2
        surface = near + 0.5 + (far - near - 1.0) * torch.rand(
            R, generator=g, device=device)
        vals[..., 0] = surface[:, None] - mids
        grad = -unit[:, None, :] + 0.1 * grad
        inv_s = torch.full((), 1e3, device=device)
    else:
        if zero_grads:
            grad[:, ::7] = 0.0
        inv_s = torch.full((), 2.7, device=device)
    sdf = vals[..., 0]
    if misalign:
        buf = torch.empty(R * S + 1, device=device)
        buf[1:].copy_(sdf.reshape(-1))
        sdf = buf[1:].view(R, S)
        buf = torch.empty(R * S * 3 + 1, device=device)
        buf[1:].copy_(grad.reshape(-1))
        grad = buf[1:].view(R, S, 3)
    return sdf, grad, unit, edges, dn, inv_s


RENDER_KEYS = ("weights", "acc", "depth", "normal_vis", "ts", "deltas")
COTANGENTS = {"all": (0, 1, 2, 3), "weights": (0,), "acc": (1,),
              "depth": (2,), "normal_vis": (3,)}


def render_fwd_error(inputs, weights=True, geometry=True):
    """neus_render_fwd against neus_composite_plain (fp32, the same
    formulas): weights, acc and normal_vis 2e-5 abs (log-sums and
    composites summed in another order), depth 1e-5 of its max, ts and
    deltas 1e-6 of their max (the same divisions). Returns the largest
    absolute error of weights, acc and normal_vis."""
    from selfocc_tpu_torch.ops import render_weights as rw
    got = rw.neus_render_fwd(*inputs, weights=weights, geometry=geometry)
    ref = rw.neus_composite_plain(*inputs)
    worst = 0.0
    for k, a, b in zip(RENDER_KEYS, got, ref):
        if (k == "weights" and not weights) or (
                k in ("ts", "deltas") and not geometry):
            if a.numel():
                raise AssertionError(f"neus_render_fwd wrote {k}")
            continue
        err = max_err(a, b)
        scale = float(b.abs().max())
        tol = {"depth": 1e-5 * scale, "ts": 1e-6 * scale,
               "deltas": 1e-6 * scale}.get(k, 2e-5)
        if not err <= tol:
            raise AssertionError(f"neus_render_fwd {k}: {err:.3e} > "
                                 f"{tol:.3e}")
        if k in ("weights", "acc", "normal_vis"):
            worst = max(worst, err)
    return worst


def render_bwd_error(inputs, cots, which, tag, opaque=False, fallbacks=None):
    """neus_render_bwd against autograd through the plain version, for the
    cotangents ``which``. The reference keeps alpha in fp32 and the rest in
    float64 (``neus_composite_plain``'s ``dtype``): alpha's prev - next
    difference costs every fp32 implementation the same digits, and the
    sums after it are taken in another order. g_sdf: GRAD_RTOL of its max.
    g_grad: GRAD_RTOL of its max over the samples whose gradient is
    clamped (|grad| < 1e-6, where the normal's 1 / 1e-6 makes g_grad ~1e3)
    and, apart, over the other samples, so that the clamped ones do not
    set the tolerance of the rest. g_inv_s, a sum of one term per sample
    that cancels: GRAD_RTOL of the sum of its per-ray terms' magnitudes.
    ``opaque`` (saturated rays) and the acc cotangent alone: there the
    gradient is ~1e-5 of its terms, set by how 1 - alpha + 1e-7 rounds, and
    the fp32 plain version itself misses that tolerance; the kernel may
    then be no further from the reference than twice the fp32 plain
    version, plus 1e-7, and each such use is appended to ``fallbacks``. In
    any other case a miss fails. Returns the largest error over its
    tolerance."""
    import torch
    from selfocc_tpu_torch.ops import render_weights as rw
    cs = [c if i in COTANGENTS[which] else None for i, c in enumerate(cots)]
    got = rw.neus_render_bwd(*inputs, *cs)
    ref = rw.neus_composite_bwd_plain(*inputs, *cs, dtype=torch.float64)
    plain = rw.neus_composite_bwd_plain(*inputs, *cs)
    R = inputs[0].shape[0]
    per_ray = rw.neus_composite_bwd_plain(
        *inputs[:5], inputs[5].expand(R, 1).clone(), *cs,
        dtype=torch.float64)[2]
    clamped = (torch.linalg.norm(inputs[1], dim=-1) < 1e-6)[..., None]
    clamped = clamped.expand(inputs[1].shape)
    parts = [("g_sdf", got[0], ref[0], plain[0], float(ref[0].abs().max()))]
    for cls, mask in (("clamped", clamped), ("unclamped", ~clamped)):
        if bool(mask.any()):
            parts.append((f"g_grad ({cls} samples)", got[1][mask],
                          ref[1][mask], plain[1][mask],
                          float(ref[1][mask].abs().max())))
    parts.append(("g_inv_s", got[2], ref[2], plain[2],
                  float(per_ray.abs().sum())))
    worst = 0.0
    for name, a, b, p, scale in parts:
        err = max_err(a, b)
        tol = GRAD_RTOL * scale + 1e-7
        plain_err = max_err(p, b)
        if not err <= tol and opaque and which == "acc" and plain_err > tol:
            log(f"  neus_render_bwd ({tag}, {which}) {name}: the fp32 plain "
                f"version is {plain_err:.3e} off the reference (tolerance "
                f"{tol:.1e}); kernel {err:.3e}, held to twice the plain's")
            tol = 2 * plain_err + 1e-7
            if fallbacks is not None:
                fallbacks.append(f"{tag}, {which}: {name}")
        if not err <= tol:
            raise AssertionError(f"neus_render_bwd ({tag}, {which}) {name}: "
                                 f"{err:.3e} > {tol:.3e}")
        worst = max(worst, err / tol)
    return worst


def render_store_check(inputs, cots, reps):
    """Every element of each output row written, nothing past the last row,
    nothing read past the inputs' last row, and the same bits on every
    call: the C entries are called directly, ``reps`` times each, on
    outputs that hold one more row than the rays, all NaN, and on the
    per-sample inputs copied into buffers whose next row is NaN (same
    strides and 16-byte alignment). Lanes that own part of a run, or none,
    sit next to other rays' rows: a store past a lane's run would race with
    that ray's own, a load past it would bring NaN into the last ray."""
    import torch
    from selfocc_tpu_torch import _build
    from selfocc_tpu_torch.ops import render_weights as rw
    lib = _build.load("neus_weights", rw._SIGNATURES)
    R, S = inputs[0].shape
    P, dev = _build.ptr, inputs[0].device

    def nan(*shape):
        return torch.full(shape, float("nan"), device=dev)

    def nan_tailed(t):
        off = t.storage_offset() % 4
        view = nan(off + (R + 1) * t.stride(0)).as_strided(
            t.shape, t.stride(), off)
        view.copy_(t)
        return view

    sdf, grad, unit, edges, dn, inv_s = inputs
    sdf, grad, edges = map(nan_tailed, (sdf, grad, edges))
    cots = [nan_tailed(cots[0]), *cots[1:]]

    def fwd():
        outs = (nan(R + 1, S), nan(R + 1), nan(R + 1), nan(R + 1, 3),
                nan(R + 1, S), nan(R + 1, S))
        _build.check(lib.neus_render_fwd(
            P(sdf), sdf.stride(0), sdf.stride(1), P(grad), P(unit),
            P(edges), P(dn), P(inv_s), *map(P, outs), R, S,
            _build.stream_ptr(dev)), "neus_render_fwd")
        return outs

    def bwd():
        outs = (nan(R + 1, S), nan(R + 1, S, 3), nan(R + 1))
        _build.check(lib.neus_render_bwd(
            P(sdf), sdf.stride(0), sdf.stride(1), P(grad), P(unit),
            P(edges), P(dn), P(inv_s), *map(P, cots), *map(P, outs), R, S,
            _build.stream_ptr(dev)), "neus_render_bwd")
        return outs

    for name, fn in (("neus_render_fwd", fwd), ("neus_render_bwd", bwd)):
        first = None
        for _ in range(reps):
            outs = fn()
            for i, o in enumerate(outs):
                if bool(o[:R].isnan().any()):
                    raise AssertionError(f"{name} ({R} x {S}): output {i} "
                                         "has NaN: an element never written "
                                         "or a load past the inputs")
                if not bool(o[R].isnan().all()):
                    raise AssertionError(f"{name} ({R} x {S}): output {i} "
                                         "written past its last row")
            if first is None:
                first = outs
            elif not all(torch.equal(a[:R], b[:R])
                         for a, b in zip(outs, first)):
                raise AssertionError(f"{name} ({R} x {S}): another result "
                                     "on a repeated call")


def render_function_check(inputs, cots):
    """The autograd Function on the card: the gradients that reach a
    (R, S, 25) trilinear result through its sdf view, the grad leaf and
    inv_s equal the backward wrapper's (the same kernel)."""
    import torch
    from selfocc_tpu_torch.ops import render_weights as rw
    sdf, grad, unit, edges, dn, inv_s = inputs
    R, S = sdf.shape
    vals = torch.zeros((R, S, 25), device=sdf.device)
    vals[..., 0] = sdf
    leaves = [t.clone().requires_grad_(True) for t in (vals, grad, inv_s)]
    outs = rw.neus_composite(leaves[0][..., 0], leaves[1], unit, edges, dn,
                             leaves[2])
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    ref = rw.neus_render_bwd(*inputs, *cots)
    for name, a, b in (("g_sdf", leaves[0].grad[..., 0], ref[0]),
                       ("g_grad", leaves[1].grad, ref[1]),
                       ("g_inv_s", leaves[2].grad, ref[2])):
        check(f"neus_composite Function on the card ({name})",
              max_err(a, b), 0.0)
    if bool(leaves[0].grad[..., 1:].any()):
        raise AssertionError("neus_composite: gradient in channels 1..24")


def render_checks(g, device):
    """The fused NeuS render, forward and backward, against its plain
    version at the main paths' chunks (timed): the geo-only eval chunk
    (32768 x 256, sdf of a 1-channel result, acc / depth / normal_vis
    written) and the first training chunk (4096 x 256, sdf of the 25-channel
    result, every output written, each cotangent alone); then off-path
    inputs (checked only): tiny's S = 16, ragged R and S (S = 19, 100,
    130, 200, 255: lanes that hold part of a run or none, next to other
    rays' rows), saturated samples, rows off 16-byte alignment; a forward
    of S = 300 (two tiles; the backward takes S <= 256). And the
    alpha-input entry neus_weights_fwd, which no main path launches any
    more, against its plain version."""
    import torch
    from selfocc_tpu_torch.ops import render_weights as rw
    res = {}

    def cotangents(inputs):
        R, S = inputs[0].shape
        return [torch.randn(shape, generator=g, device=device)
                for shape in ((R, S), (R,), (R,), (R, 3))]

    def io_bytes(inputs, outs):
        sdf = inputs[0]
        return (sdf.numel() * 4 + nbytes(*inputs[1:]) +
                sum(nbytes(o) for o in outs if o is not None))

    # the eval chunk: what ChunkedRenderer's depth render asks for
    ev = render_case(g, device, CHUNK, 256)
    err = render_fwd_error(ev, weights=False, geometry=False)
    log(f"  neus_render_fwd (eval chunk 32768 x 256): max_abs_err {err:.3e}")
    outs = rw.neus_render_fwd(*ev, weights=False, geometry=False)
    n = ev[0].numel()
    fwd = kernel_record(
        err, timed(lambda: rw.neus_render_fwd(*ev, weights=False,
                                              geometry=False), 20),
        timed(lambda: rw.neus_composite_plain(*ev), 5),
        (io_bytes(ev, outs), n * RENDER_FWD_OPS),
        shape="eval chunk 32768 x 256, geo-only",
        device_ms=device_ms(lambda: rw.neus_render_fwd(
            *ev, weights=False, geometry=False), 20))
    del ev, outs
    torch.cuda.empty_cache()

    # the first training chunk: strided sdf, every output, the backward
    tr = render_case(g, device, 4096, 256, C=25)
    cots = cotangents(tr)
    err_t = render_fwd_error(tr)
    fallbacks = []
    bwd_worst = max(render_bwd_error(tr, cots, w, "training chunk")
                    for w in COTANGENTS)
    render_function_check(tr, cots)
    outs = rw.neus_render_fwd(*tr)
    n = tr[0].numel()
    tr_rec = kernel_record(
        err_t, timed(lambda: rw.neus_render_fwd(*tr), 20),
        timed(lambda: rw.neus_composite_plain(*tr), 5),
        (io_bytes(tr, outs), n * RENDER_FWD_OPS),
        device_ms=device_ms(lambda: rw.neus_render_fwd(*tr), 20))
    for k in ("ms", "device_ms", "plain_ms", "bound_ms", "max_abs_err"):
        fwd[f"train_{k}"] = tr_rec[k]
    grads = rw.neus_render_bwd(*tr, *cots)
    bwd = kernel_record(
        bwd_worst, timed(lambda: rw.neus_render_bwd(*tr, *cots), 20),
        timed(lambda: rw.neus_composite_bwd_plain(*tr, *cots), 5),
        (io_bytes(tr, cots) + nbytes(*grads[:2]) + 4 * tr[0].shape[0],
         n * RENDER_BWD_OPS),
        shape="training chunk 4096 x 256, sdf of a 25-channel result",
        device_ms=device_ms(lambda: rw.neus_render_bwd(*tr, *cots), 20))
    bwd["max_err_over_tol"] = bwd.pop("max_abs_err")
    # the checks that held the kernel to twice the fp32 plain version's
    # distance from the reference (saturated rays, acc alone) instead
    bwd["plain_fallback"] = fallbacks
    bwd["max_abs_err"] = max(
        max_err(a, b) for a, b in zip(grads, rw.neus_composite_bwd_plain(
            *tr, *cots, dtype=torch.float64)))
    del tr, cots, outs, grads
    torch.cuda.empty_cache()

    # off-path inputs, checked only
    for tag, kw in (("training chunk, no zero gradients",
                     dict(R=4096, S=256, C=25, zero_grads=False)),
                    ("tiny S = 16, R = 37", dict(R=37, S=16)),
                    ("ragged S = 19, R = 37", dict(R=37, S=19)),
                    ("S = 200, R = 512: lanes past the ray's end",
                     dict(R=512, S=200)),
                    ("S = 255, R = 512: a lane with part of a run",
                     dict(R=512, S=255)),
                    ("S = 130, R = 512", dict(R=512, S=130)),
                    ("S = 250, R = 512", dict(R=512, S=250)),
                    ("S = 100, R = 29: runs of 4", dict(R=29, S=100)),
                    ("S = 256, R = 37, rows off alignment",
                     dict(R=37, S=256, misalign=True)),
                    ("saturated, 4096 x 256, C = 25",
                     dict(R=4096, S=256, C=25, saturated=True)),
                    ("saturated, S = 19, R = 37",
                     dict(R=37, S=19, saturated=True))):
        case = render_case(g, device, **kw)
        cots = cotangents(case)
        e_f = render_fwd_error(case)
        e_b = max(render_bwd_error(case, cots, w, tag,
                                   opaque=kw.get("saturated", False),
                                   fallbacks=fallbacks) for w in COTANGENTS)
        log(f"  neus_render ({tag}): forward max_abs_err {e_f:.3e}, "
            f"backward worst {e_b:.3f} of its tolerance (each cotangent "
            "alone and all four)")
    # ragged S: every output element written once, nothing past the rows,
    # no load past the inputs, the same bits on five calls. 513 rays: then
    # the last ray's partial lane (S = 130, 250, 255) starts 16-byte
    # aligned, where a vector load or store would be taken
    for S in (16, 19, 100, 130, 200, 250, 255, 256):
        for kw in (dict(), dict(C=25), dict(misalign=True)):
            case = render_case(g, device, 513, S, **kw)
            render_store_check(case, cotangents(case), reps=5)
    log("  neus_render (513 rays, S = 16 ... 256, contiguous, strided and "
        "misaligned sdf): every output written, none past the last row, "
        "no load past the inputs, the same on five calls")
    case = render_case(g, device, 29, 300)
    log(f"  neus_render_fwd (S = 300, R = 29: two tiles): max_abs_err "
        f"{render_fwd_error(case):.3e}")
    for k, v in (("fwd", fwd), ("bwd", bwd)):
        res[f"neus_render_{k}"] = v

    # the alpha-input entry: one eval chunk, incl. saturated samples, and a
    # ragged shape
    alpha = torch.rand((CHUNK, 256), generator=g, device=device)
    alpha[::7, 100:110] = 1.0
    alpha[::5, :20] = 0.0
    err = max_err(rw.neus_weights_fwd(alpha),
                  rw.weights_from_alpha_plain(alpha))
    check("neus_weights_fwd (32768 x 256)", err, 2e-5)
    for R, S in ((37, 19), (5, 700)):
        a = torch.rand((R, S), generator=g, device=device)
        a[:, 5:8] = 1.0
        check(f"neus_weights_fwd ({R} x {S})", max_err(
            rw.neus_weights_fwd(a), rw.weights_from_alpha_plain(a)), 2e-5)
    res["neus_weights_fwd"] = kernel_record(
        err, timed(lambda: rw.neus_weights_fwd(alpha), 20),
        timed(lambda: rw.weights_from_alpha_plain(alpha), 20),
        (2 * nbytes(alpha), 6 * alpha.numel()), shape="32768 x 256",
        device_ms=device_ms(lambda: rw.neus_weights_fwd(alpha), 20))
    del alpha
    torch.cuda.empty_cache()
    return res


def weights_path(device):
    """weights_from_alpha's own path (no main path calls it since the
    render is fused): one call through the public entry on an eval chunk's
    alpha, its launches counted, held against the plain version."""
    import torch
    from selfocc_tpu_torch.ops import render_weights as rw
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    alpha = torch.rand((CHUNK, 256), generator=g, device=device)
    reset_counts([rw.neus_weights_fwd])
    w = rw.weights_from_alpha(alpha)
    torch.cuda.synchronize()
    counts = read_counts([rw.neus_weights_fwd], "weights_from_alpha path")
    check("weights_from_alpha (32768 x 256)",
          max_err(w, rw.weights_from_alpha_plain(alpha)), 2e-5)
    return counts["neus_weights_fwd"]


def kernel_checks(device, baseline=None):
    """Each kernel against its plain version at main-path call shapes
    (timed) and at a few off-flagship shapes (checked only); ``baseline``:
    see ``trilinear_checks``."""
    import torch
    from selfocc_tpu_torch.ops import gather_rows, msda
    g = torch.Generator(device=device).manual_seed(SEED)
    res = {}

    res.update(render_checks(g, device))

    res.update(trilinear_checks(g, device, baseline))

    res.update(values_kernel_checks(g, device))

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

    # off-flagship shapes the kernels also take: MSDA at every instance of
    # its kernels (float4 lanes at D = 4, 24 and 1024, scalar lanes at D = 6
    # and 66, channel chunks at D = 66 and 1024, a value 4 bytes off 16-byte
    # alignment, query counts no multiple of the block's 8-query tile); fp32
    # rows of a width that is no multiple of 16 bytes
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


def full_frame(device, baseline=None):
    """One full-width nuscenes_occ frame through the eval_depth code path,
    with the launch counts of that run; then its device work checked for
    synchronising calls and profiled (``baseline``: see
    ``frame_profiles``)."""
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
    wrappers = (render_weights.neus_render_fwd,
                interp.trilinear_cf_with_grad_fwd, msda.msda_fwd)
    off_path = (msda.msda_bwd, interp.trilinear_bwd,
                render_weights.neus_render_bwd,
                render_weights.neus_weights_fwd)
    reset_counts(wrappers + off_path)
    torch.cuda.reset_peak_memory_stats()
    res = eval_depth.evaluate(cfg, model, [item], device, 1, CHUNK, logger)
    launches = read_counts(wrappers, "eval frame")
    stray = {fn.__name__: fn.launches for fn in off_path if fn.launches}
    if stray:
        raise AssertionError(f"the no-grad eval frame launched {stray}")
    chunks = -(-res["rays"] // CHUNK)
    res["chunks"] = chunks
    res["launches_per_chunk"] = {k: v / chunks for k, v in launches.items()}
    if launches["neus_render_fwd"] != chunks:
        raise AssertionError(f"neus_render_fwd: {launches} launches for "
                             f"{chunks} render chunks")
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["cold"] = {k: cold[k] for k in ("prepare_s", "render_s")}
    res.update(frame_device_path(cfg, model, to_device(item, device)))
    res["profile"] = frame_profiles(device, baseline)

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


def frame_device_path(cfg, model, batch):
    """The frame's device work (prepare, rays, the chunked render) on a
    batch already on the card: once under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising call
    raises; the host copy of the depths, which ``render`` makes, is left
    out)."""
    import torch
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    renderer = ChunkedRenderer(model, chunk=CHUNK, outputs=("depth",))
    rays = eval_ray_grid(cfg, device=batch["imgs"].device)

    def frame():
        volume = renderer.prepare(batch["imgs"], batch["lidar2img"])
        origin, direction = rays_for_cams(eval_trans_mats(batch, cfg), rays)
        return renderer.render_device(volume, origin, direction)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = frame()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out["depth"]).all()):
        raise AssertionError("non-finite depth in the sync-checked frame")
    log("  warm frame on the card under set_sync_debug_mode('error'): no "
        "synchronising call")
    return {"sync_checked": True}


def frame_profile(pkg, device):
    """Kernel launches and kernel time of one full-width eval frame of the
    package ``pkg`` (this checkout's, or a baseline's under its own name),
    after a warm frame, by ``torch.profiler``: the prepare, one 32768-ray
    render chunk (``ChunkedRenderer.render`` of as many rays: padding, the
    chunk and the host copy) and the whole render (66 chunks)."""
    import importlib
    import torch
    from torch.profiler import ProfilerActivity, profile

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    el, rt = mod("utils.eval_lib"), mod("utils.runtime")
    cfg = mod("configs.experiments").get_config("nuscenes_occ")
    model = mod("eval_depth").build_model(cfg, SEED, device)
    batch = rt.to_device(rt.get_dataset(cfg, synthetic=True, length=1)[0],
                         device)
    renderer = el.ChunkedRenderer(model, chunk=CHUNK, outputs=("depth",))
    origin, direction = el.rays_for_cams(
        el.eval_trans_mats(batch, cfg), el.eval_ray_grid(cfg, device=device))

    def prepare():
        return renderer.prepare(batch["imgs"], batch["lidar2img"])

    volume = prepare()
    renderer.render(volume, origin, direction)
    res = {}
    for tag, fn in (
            ("prepare", prepare),
            ("chunk", lambda: renderer.render(volume, origin[:CHUNK],
                                              direction[:CHUNK])),
            ("render", lambda: renderer.render(volume, origin, direction))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        res[f"{tag}_kernels"] = sum(e.count for e in kernels)
        res[f"{tag}_kernel_ms"] = sum(e.self_device_time_total
                                      for e in kernels) / 1e3
    del model, volume, renderer
    torch.cuda.empty_cache()
    return res


def frame_profiles(device, baseline=None):
    """``frame_profile`` of this checkout; with ``baseline``, of both
    checkouts in turns (baseline, this, this, baseline)."""
    sides = ["this"] if baseline is None else [
        "baseline", "this", "this", "baseline"]
    out = {}
    for side in sides:
        pkg = ("selfocc_tpu_torch" if side == "this"
               else load_baseline(baseline))
        r = frame_profile(pkg, device)
        log(f"  profiled frame ({side}): prepare {r['prepare_kernels']} "
            f"kernels / {r['prepare_kernel_ms']:.1f} ms, one render chunk "
            f"{r['chunk_kernels']} / {r['chunk_kernel_ms']:.2f} ms, render "
            f"{r['render_kernels']} / {r['render_kernel_ms']:.1f} ms")
        out.setdefault(side, []).append(r)
    return out


class OccItems:
    """One synthetic item as ``eval_iou.evaluate``'s dataset: its Occ3D
    labels, or (``label_path``) an OpenOccupancy label file instead."""

    def __init__(self, ds, idx, label_path=None):
        self.ds, self.idx, self.label_path = ds, idx, label_path
        if label_path is None:
            self.occ3d_labels = lambda i: ds.occ3d_labels(idx)

    def __len__(self):
        return 1

    def __getitem__(self, i):
        item = dict(self.ds[self.idx])
        if self.label_path is not None:
            item["openocc_label_path"] = self.label_path
        return item


def occ_profile(fn):
    """Kernels, kernel ms and ``trilinear_cf_fwd``'s kernel ms of one call
    of ``fn`` (a warm query's device part), by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": sum(e.count for e in kernels),
            "kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "trilinear_cf_fwd_ms": sum(
                e.self_device_time_total for e in kernels
                if "trilinear_fwd_" in e.key) / 1e3,
            "trilinear_cf_fwd_calls": sum(
                e.count for e in kernels if "trilinear_fwd_" in e.key)}


def occ_frame(device):
    """One full-width nuscenes_occ occupancy frame through the eval_iou
    code path (seeded weights, synthetic labels), after a cold frame: the
    Occ3D query (--occ3d --sem) by gather and by separable lerps and the
    OpenOccupancy 512 x 512 x 40 query (sdf, sem), each with its prepare_s,
    query_s, peak memory, launch counts (reset just before, read just
    after: trilinear_cf_fwd must be launched) and a profile of its warm
    device part. Then, on the frame's own volume: trilinear_cf_fwd against
    its plain version on a 1,048,576-point slab of the dense grid and at
    the 640,000 Occ3D points (each channel within 1e-5 of its max, timed);
    the Occ3D occupancy and classes of the kernel path against the plain
    path on the card (a voxel may differ only where |sdf| < 1e-5 or the
    logit gap < 1e-5); separable against gather (sdf_r and logits_r within
    rtol 1e-5, atol 1e-6; classes by the same gap rule); and each warm
    query's device part under set_sync_debug_mode("error")."""
    import os
    import numpy as np
    import torch
    from selfocc_tpu_torch import eval_depth, eval_iou
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.utils.eval_lib import (GridOccEvaluator,
                                                  occ3d_indices)
    from selfocc_tpu_torch.utils.runtime import (get_dataset, get_logger,
                                                 to_device)

    cfg = get_config("nuscenes_occ")
    t0 = time.time()
    model = eval_depth.build_model(cfg, SEED, device)
    ds = get_dataset(cfg, synthetic=True)
    logger = get_logger()
    # a fabricated OpenOccupancy label file (voxel rows + class column) in
    # the git-ignored work_dirs/
    os.makedirs(os.path.join("work_dirs", "chip_smoke"), exist_ok=True)
    label_path = os.path.join("work_dirs", "chip_smoke", "occ_labels.npy")
    rs = np.random.RandomState(SEED)
    np.save(label_path, np.stack([rs.randint(0, 40, 20000),
                                  rs.randint(0, 512, 20000),
                                  rs.randint(0, 512, 20000),
                                  rs.randint(1, 17, 20000)], 1))
    log(f"  model + synthetic dataset set-up {time.time() - t0:.1f}s")
    occ3d = ["--py-config", "nuscenes_occ", "--synthetic", "--occ3d", "--sem"]
    runs = {"occ3d_gather": (occ3d, None),
            "occ3d_separable": (occ3d + ["--grid-query", "separable"], None),
            "openocc": (["--py-config", "nuscenes_occ", "--synthetic",
                         "--sem"], label_path)}
    wrappers = (interp.trilinear_cf_fwd, msda.msda_fwd)
    off_path = (interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
                msda.msda_bwd)

    cold = eval_iou.evaluate(cfg, model, OccItems(ds, 1), device,
                             eval_iou.parse_args(occ3d), logger)
    log(f"  cold frame (Occ3D, gather): prepare {cold['prepare_s']:.3f}s "
        f"query {cold['query_s']:.3f}s")
    res = {"cold": {k: cold[k] for k in ("prepare_s", "query_s")}}
    for tag, (flags, path) in runs.items():
        args = eval_iou.parse_args(flags)
        reset_counts(wrappers + off_path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = eval_iou.evaluate(cfg, model, OccItems(ds, 0, path), device,
                              args, logger)
        launches = read_counts(wrappers, f"{tag} occupancy frame",
                               ("plane", "rows") if tag.startswith("occ3d")
                               else ("rows",))
        stray = {fn.__name__: fn.launches for fn in off_path if fn.launches}
        if stray:
            raise AssertionError(f"the {tag} frame launched {stray}")
        scores = {k: r[k] for k in ("iou_miou", "iou_iou", "miou_miou",
                                    "miou_iou") if k in r}
        if not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"{tag}: non-finite scores {scores}")
        res[tag] = dict(prepare_s=r["prepare_s"], query_s=r["query_s"],
                        max_memory_gb=torch.cuda.max_memory_allocated()
                        / 2**30, launches=launches, scores=scores)
        log(f"  {tag}: prepare {r['prepare_s']:.4f}s query "
            f"{r['query_s']:.4f}s, peak "
            f"{res[tag]['max_memory_gb']:.2f} GiB, {scores}")

    # the frame's device part, warm: profiled and sync-checked
    batch = to_device(ds[0], device)
    volume = GridOccEvaluator(model).prepare(batch["imgs"], batch["lidar2img"])
    pcr, expansion = eval_iou.OCC3D_SCENES[0]
    ev = {q: GridOccEvaluator(model, query=q)
          for q in ("gather", "separable")}
    pts = eval_iou.occ3d_ego_to_grid_coords(pcr, expansion, np.eye(4))
    idx = torch.from_numpy(occ3d_indices(
        pts, pcr, expansion, ev["gather"].grid_shape(pcr, 0.2))).to(device)
    calls = {
        "occ3d_gather": lambda: ev["gather"].query_grid_occ3d_device(
            volume, tuple(pcr), 0.2, idx),
        "occ3d_separable": lambda: ev["separable"].query_grid_occ3d_device(
            volume, tuple(pcr), 0.2, idx),
        "openocc": lambda: ev["gather"].query_grid_device(
            volume, OPENOCC_PCR, 0.2, keys=("sdf", "sem"))}
    for tag, fn in calls.items():
        fn()
        res[tag]["profile"] = occ_profile(fn)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(v.float()).all())
                   for v in out.values()):
            raise AssertionError(f"{tag}: non-finite outputs")
        res[tag]["sync_checked"] = True
        log(f"  {tag} warm device part: {res[tag]['profile']}; no "
            "synchronising call under set_sync_debug_mode('error')")
        del out

    # trilinear_cf_fwd against its plain version on the frame's volume
    grid = dense_grid_points(cfg, device)
    mid = grid.shape[0] // 2
    slab = grid[mid - OCC_SLAB // 2: mid + OCC_SLAB // 2].contiguous()
    del grid
    dense = ev["gather"]._dense(volume, pcr, 0.2, ("sdf", "logits"))
    sdf_v, logit_v = dense["sdf"][..., None].permute(3, 0, 1, 2), \
        dense["logits"].permute(3, 0, 1, 2)
    kern = {}
    for tag, vol, p in (("dense slab, C=25", volume, slab),
                        ("Occ3D logits, C=21, row 25", logit_v, idx),
                        ("Occ3D sdf plane, row 25", sdf_v, idx)):
        p = p.reshape(-1, 3).contiguous()
        row = interp.row_stride(vol)      # the query's layout: read in place
        kv = vol if row is not None else interp.kernel_volume(vol)
        got = interp.trilinear_cf_fwd(kv, p)
        ref = interp.trilinear_sample_cf_plain(vol, p)
        rel, err = channel_close(got, ref)
        check(f"trilinear_cf_fwd ({tag}, {p.shape[0]} points) / channel "
              "tolerance", rel, 1.0)
        n, C = p.shape[0], vol.shape[0]
        b_ms, by = bound(corner_voxels(p, tuple(vol.shape[1:])) * C * 4
                         + nbytes(p) + n * C * 4, n * (20 + 16 * C))
        kern[tag] = {"max_abs_err": err, "channel_rel_err": rel,
                     "points": int(n), "C": int(C), "row": row,
                     "bound_ms": b_ms, "bound_by": by,
                     "ms": timed(lambda: interp.trilinear_cf_fwd(kv, p), 10),
                     "device_ms": device_ms(
                         lambda: interp.trilinear_cf_fwd(kv, p), 10),
                     "plain_ms": timed(
                         lambda: interp.trilinear_sample_cf_plain(vol, p), 3)}
        if tag.startswith("Occ3D"):
            # the library call on the same values: F.grid_sample on a
            # channel-first copy, timed without and with making the copy
            lib, _ = grid_sample_of(vol, p)
            lib_rel, lib_err = channel_close(lib(), ref)

            def lib_copy(vol=vol, p=p):
                return grid_sample_of(vol, p)[0]()
            kern[tag].update(
                library="F.grid_sample", library_max_abs_err=lib_err,
                library_channel_rel_err=lib_rel, library_ms=timed(lib, 10),
                library_device_ms=device_ms(lib, 10),
                library_with_copy_ms=timed(lib_copy, 10),
                library_with_copy_device_ms=device_ms(lib_copy, 10))
            del lib
        log(f"  trilinear_cf_fwd {tag}: {kern[tag]}")
        del got, ref
    res["kernel_vs_plain"] = kern

    # Occ3D occupancy and classes: the kernel path against the plain path
    # (the plain versions run on the card) and separable against gather
    flat, shape = ev["gather"]._flat_grid(pcr, 0.2, device)
    field = model.head.field
    vals = interp.trilinear_sample_cf_plain(volume, field.mapping.meter2grid(
        flat)).reshape(shape + (volume.shape[0],))
    n_sh = field.n_sh
    plain_sdf = interp.trilinear_sample_cf_plain(
        vals[..., :1].permute(3, 0, 1, 2), idx)[..., 0]
    plain_logits = interp.trilinear_sample_cf_plain(
        vals[..., 1 + n_sh:].permute(3, 0, 1, 2), idx)
    del vals, flat, dense, sdf_v, logit_v
    torch.cuda.empty_cache()
    out = {q: ev[q].query_grid_occ3d_device(volume, tuple(pcr), 0.2, idx)
           for q in ev}
    g = out["gather"]
    flips = {}
    for name, ref_sdf, ref_logits, ref_sem in (
            ("kernel vs plain", plain_sdf, plain_logits,
             plain_logits.argmax(-1)),
            ("separable vs gather", g["sdf_r"], g["logits_r"], g["sem_r"])):
        o = g if name == "kernel vs plain" else out["separable"]
        if name == "separable vs gather":
            for k, r in (("sdf_r", ref_sdf), ("logits_r", ref_logits)):
                bad = ((o[k] - r).abs() > 1e-5 * r.abs() + 1e-6).sum()
                if int(bad):
                    raise AssertionError(f"{name}: {int(bad)} {k} values "
                                         "beyond rtol 1e-5, atol 1e-6")
        occ_d = (o["sdf_r"] <= 0) != (ref_sdf <= 0)
        occ_bad = occ_d & ~((o["sdf_r"].abs() < 1e-5)
                            | (ref_sdf.abs() < 1e-5))
        top = torch.topk(o["logits_r"], 2, dim=-1).values
        sem_d = o["sem_r"] != ref_sem
        sem_bad = sem_d & ~((top[..., 0] - top[..., 1]) < 1e-5)
        flips[name] = {"occupancy_differ": int(occ_d.sum()),
                       "class_differ": int(sem_d.sum()),
                       "sdf_max_abs_err": max_err(o["sdf_r"], ref_sdf),
                       "logits_max_abs_err": max_err(o["logits_r"],
                                                     ref_logits)}
        log(f"  Occ3D {name}: {flips[name]}")
        if int(occ_bad.sum()) or int(sem_bad.sum()):
            raise AssertionError(f"Occ3D {name}: {int(occ_bad.sum())} "
                                 f"occupancy and {int(sem_bad.sum())} class "
                                 "differences outside the flip rule")
    res["flips"] = flips
    del model, volume, out, g, plain_sdf, plain_logits, slab, idx
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
    wrappers = (render_weights.neus_render_fwd,
                render_weights.neus_render_bwd,
                interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
                msda.msda_fwd, msda.msda_bwd)
    reset_counts(wrappers + (render_weights.neus_weights_fwd,))
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
    if render_weights.neus_weights_fwd.launches:
        raise AssertionError("the training steps launched neus_weights_fwd")
    launches["neus_weights_fwd"] = 0
    chunks = -(-cfg.num_cams * cfg.model.head.ray_number[0]
               * cfg.model.head.ray_number[1]
               // cfg.model.head.train_ray_chunk)
    # each checkpointed chunk renders twice (forward, then the recompute
    # in the backward) and differentiates once
    if (launches["neus_render_fwd"] != 3 * 2 * chunks
            or launches["neus_render_bwd"] != 3 * chunks):
        raise AssertionError(f"neus_render launches {launches} for 3 steps "
                             f"of {chunks} chunks")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: sorted(s[k] for s in steps)[1]
           for k in ("step_s", "forward_s", "backward_s", "optimizer_s")}
    log(f"  median step {med['step_s']:.3f}s (forward "
        f"{med['forward_s']:.3f}, backward {med['backward_s']:.3f}, "
        f"optimizer {med['optimizer_s']:.3f}); peak {peak:.2f} GiB")
    prof = profile_step(trainer, batch, gen, med["step_s"])

    # a warm step on a batch already on the card, as train.py runs it (no
    # sync): any synchronising call in it raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = trainer.step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    finite(m)
    log("  warm step under set_sync_debug_mode('error'): no synchronising "
        "call")

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
            "max_memory_gb": peak, "sync_checked": True,
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
           "neus_render_share": share("neus_render"),
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
    # the fused NeuS render: in-step ms per call and calls
    neus = {}
    for e in kernels:
        m = re.search(r"neus_render_(fwd|bwd)_kernel", e.key)
        if m:
            t = neus.setdefault(f"neus_render_{m.group(1)}",
                                {"calls": 0, "device_ms": 0.0})
            t["calls"] += e.count
            t["device_ms"] += e.self_device_time_total / 1e3
    for name, t in sorted(neus.items()):
        t["ms_per_call"] = t["device_ms"] / max(t["calls"], 1)
        log(f"    {name} in the step: x{t['calls']} {t['device_ms']:.3f} ms "
            f"({t['ms_per_call']:.4f} ms per call)")
    if set(neus) != {"neus_render_fwd", "neus_render_bwd"}:
        raise AssertionError(f"profiled step: neus_render kernels {neus}")
    res["neus_render_kernels"] = neus
    return res


NUSC_CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
             "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
FAB_SAMPLES = 8                   # one scene of 8 keyframes
FAB_STEP = 1.5                    # metres of ego motion between keyframes
FAB_IMG = (900, 1600)             # nuScenes camera images
FAB_LIDAR_POINTS = 34_000         # points per sweep, 5 float32 each
FAB_LIDAR2EGO = (0.94, 0.0, 1.84)


def rotmat_to_quat(m):
    """(w, x, y, z) of a 3x3 rotation (inverse of the loaders'
    ``quaternion_to_rotmat``)."""
    import numpy as np
    m = np.asarray(m, np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        return [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                (m[1, 0] - m[0, 1]) / s]
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
    q = [0.0] * 4
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def fabricate_nuscenes(root):
    """A full-size nuScenes-format mini dataset under ``root``, in the
    layouts of the JAX tests' fixtures (``tests/test_nuscenes_dataset.py::
    _make_mini_nuscenes``, ``tests/test_novel_eval_datasets.py::
    make_nuscenes_eval_fixture``; copied here, since the card has no JAX
    tests): one scene of 8 keyframes 1.5 m apart, 6 cameras of 900 x 1600
    JPEGs (the procedural ground scene, smooth), a lidar sweep of 34,000
    points (x, y, z, intensity, ring) per keyframe on the ground and on
    walls around the ego, the train / val sweeps infos, the temporal_v2
    infos, Occ3D ``labels.npz`` for keyframe 0 and offline teacher maps
    (768 x 1600, 21 classes) for every image. Returns the paths."""
    import math
    import os
    import pickle
    from concurrent.futures import ThreadPoolExecutor
    import cv2
    import numpy as np
    from selfocc_tpu_torch.data.synthetic import (render_synthetic_view,
                                                  surround_cameras)

    cam2ego, K = surround_cameras(6, FAB_IMG)
    l2e_t = np.asarray(FAB_LIDAR2EGO)
    ident = [1.0, 0.0, 0.0, 0.0]
    for sub in ("samples", "sem", "occ3d"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(SEED)

    def write_view(job):
        i, c = job
        ego_t = np.array([FAB_STEP * i, 0.0, 0.0])
        img = render_synthetic_view(cam2ego[c], K, FAB_IMG, shift=ego_t)
        name = f"samples/{NUSC_CAMS[c]}_{i}.jpg"
        cv2.imwrite(os.path.join(root, name),
                    (img * 255).clip(0, 255).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        # the teacher's classes by image row: sky above the horizon, road
        # below, a band of "vehicles" (class 3) around it
        rows = np.arange(768)[:, None]
        sem = np.where(rows < 440, 20, np.where(rows < 480, 3, 12))
        np.save(os.path.join(root, "sem", os.path.basename(name) + ".npy"),
                np.broadcast_to(sem, (768, 1600)).astype(np.uint8))
        return name

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_view, [(i, c) for i in range(FAB_SAMPLES)
                                   for c in range(6)]))
    scene, temporal = [], []
    for i in range(FAB_SAMPLES):
        ego_t = [FAB_STEP * i, 0.0, 0.0]
        # lidar: 3/4 of the points on the ground 2-60 m out, 1/4 on walls
        # 12-40 m out up to 4 m high (ego frame), in the lidar frame
        n_g = FAB_LIDAR_POINTS * 3 // 4
        n_w = FAB_LIDAR_POINTS - n_g
        ang = rng.uniform(0, 2 * math.pi, FAB_LIDAR_POINTS)
        r = np.concatenate([rng.uniform(2, 60, n_g), rng.uniform(12, 40, n_w)])
        z = np.concatenate([np.zeros(n_g), rng.uniform(0, 4, n_w)])
        pts = np.stack([r * np.cos(ang), r * np.sin(ang), z], 1) - l2e_t
        sweep = np.concatenate([pts, rng.uniform(0, 255, (len(r), 1)),
                                rng.randint(0, 32, (len(r), 1))], 1)
        lidar_name = f"samples/LIDAR_TOP_{i}.bin"
        sweep.astype(np.float32).tofile(os.path.join(root, lidar_name))
        data, cams = {}, {}
        for c, cam in enumerate(NUSC_CAMS):
            name = f"samples/{cam}_{i}.jpg"
            q = rotmat_to_quat(cam2ego[c][:3, :3])
            data[cam] = {
                "filename": name,
                "calib": {"camera_intrinsic": K[:3, :3].tolist(),
                          "rotation": q,
                          "translation": cam2ego[c][:3, 3].tolist()},
                "pose": {"rotation": ident, "translation": ego_t}}
            cam2lidar = cam2ego[c].copy()
            cam2lidar[:3, 3] -= l2e_t
            cams[cam] = {
                "data_path": os.path.join(root, name),
                "cam_intrinsic": K[:3, :3],
                "sensor2lidar_rotation": cam2lidar[:3, :3],
                "sensor2lidar_translation": cam2lidar[:3, 3],
                "sensor2ego_rotation": q,
                "sensor2ego_translation": cam2ego[c][:3, 3].tolist(),
                "ego2global_rotation": ident,
                "ego2global_translation": ego_t}
        data["LIDAR_TOP"] = {
            "filename": lidar_name, "token": f"lidartok{i}",
            "calib": {"rotation": ident, "translation": list(FAB_LIDAR2EGO)},
            "pose": {"rotation": ident, "translation": ego_t}}
        scene.append({"token": f"tok{i}", "timestamp": i * 0.5,
                      "scene_name": "scene-0001", "data": data})
        temporal.append({
            "token": f"tok{i}", "timestamp": i * 0.5,
            "lidar2ego_rotation": ident,
            "lidar2ego_translation": list(FAB_LIDAR2EGO),
            "ego2global_rotation": ident, "ego2global_translation": ego_t,
            "cams": cams, "lidar_path": os.path.join(root, lidar_name),
            "nice_neighbor_prev": [i - 1] if i > 0 else [],
            "nice_neighbor_next": [i + 1] if i < FAB_SAMPLES - 1 else [],
            "prev_dists": [FAB_STEP] if i > 0 else [],
            "next_dists": [FAB_STEP] if i < FAB_SAMPLES - 1 else []})
    # Occ3D labels of keyframe 0: the ground layer occupied (class 11,
    # driveable surface), the rest free (17)
    sem = np.full((200, 200, 16), 17, np.uint8)
    sem[:, :, 4] = 11
    occ = os.path.join(root, "occ3d", "scene-0001", "tok0")
    os.makedirs(occ)
    np.savez_compressed(os.path.join(occ, "labels.npz"), semantics=sem,
                        mask_camera=(rng.rand(200, 200, 16) < 0.8
                                     ).astype(np.uint8),
                        mask_lidar=np.ones((200, 200, 16), np.uint8))
    paths = {"data_path": root + "/",
             "sweeps": os.path.join(root, "infos_sweeps.pkl"),
             "temporal": os.path.join(root, "infos_val_temporal_v2.pkl"),
             "occ3d_root": os.path.join(root, "occ3d"),
             "sem_from": os.path.join(root, "sem")}
    with open(paths["sweeps"], "wb") as f:
        pickle.dump({"infos": {"scene0": scene},
                     "metadata": [("scene0", i) for i in range(FAB_SAMPLES)]},
                    f)
    with open(paths["temporal"], "wb") as f:
        pickle.dump({"infos": temporal,
                     "scene_info": {"scene-0001": (0, FAB_SAMPLES - 1)}}, f)
    return paths


def fabricated_configs(paths):
    """``nuscenes_occ`` and ``nuscenes_novel_depth`` on the fabricated
    files, registered as ``nuscenes_occ_fab`` / ``nuscenes_novel_depth_fab``
    for the drivers' ``--py-config``: the recipes' own values, with the
    data paths, the Occ3D root and the offline teacher maps (the recipe
    trains its semantic head on OpenSeeD's 21 classes, so no LUT)."""
    from selfocc_tpu_torch.configs import experiments as ex
    files = dict(data_path=paths["data_path"], imageset=paths["sweeps"],
                 occ3d_root=paths["occ3d_root"])

    def occ():
        cfg = ex.nuscenes_occ()
        return dataclasses.replace(
            cfg, name="nuscenes_occ_fab",
            train_dataset_args=dict(cfg.train_dataset_args, **files),
            val_dataset_args=dict(cfg.val_dataset_args, **files),
            wrapper_args=dict(sem_from=paths["sem_from"],
                              sem_apply_lut=False))

    def novel():
        cfg = ex.nuscenes_novel_depth()
        return dataclasses.replace(
            cfg, name="nuscenes_novel_depth_fab",
            val_dataset_args=dict(cfg.val_dataset_args,
                                  data_path=paths["data_path"],
                                  imageset=paths["temporal"]))

    ex.register_config("nuscenes_occ_fab", occ)
    ex.register_config("nuscenes_novel_depth_fab", novel)
    return occ(), novel()


def loader_rates(cfg):
    """Host seconds per train item of ``build_dataset(cfg, "train")`` (as
    ``train.py`` builds it: seeded, labels dropped) and the items per second
    of ``BatchPrefetcher`` at depth 2 over the epoch."""
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.data.prefetch import BatchPrefetcher
    ds = build_dataset(cfg, "train")
    secs = []
    for pos in range(len(ds)):
        t0 = time.perf_counter()
        item = train.host_batch(ds, pos, SEED, 0, pos)
        secs.append(time.perf_counter() - t0)
    shapes = {k: tuple(v.shape) for k, v in item.items()}
    t0 = time.perf_counter()
    n = sum(1 for _ in BatchPrefetcher(
        lambda pos: train.host_batch(ds, pos, SEED, 1, pos),
        range(len(ds)), depth=2))
    rate = n / (time.perf_counter() - t0)
    med = sorted(secs)[len(secs) // 2]
    log("  loader profile, per item (cProfile, 2 items):")
    top = loader_profile(ds)
    log(f"  loader: {len(ds)} train items, {med:.3f} s per item (median; "
        f"{min(secs):.3f}-{max(secs):.3f}), prefetch depth 2: {rate:.2f} "
        f"items/s; imgs {shapes['imgs']}, curr_imgs {shapes['curr_imgs']}, "
        f"sem_gt {shapes['sem_gt']}")
    return {"items": len(ds), "item_s": secs, "item_s_median": med,
            "prefetch_items_per_s": rate, "shapes": shapes, "profile": top}


def train_from_loader(work, synthetic_step_s, step_kernel_ms, device):
    """4 nuscenes_occ steps from the loader through ``train.main`` with an
    iteration checkpoint every 2 steps, then a ``--iter-resume`` run from
    the step-2 checkpoint to step 4: the same items, the same ``lr``, and
    steps 2 and 3's losses within [train]'s loss tolerance (rtol 1e-5;
    whether they are bit-equal is reported, with both runs' ``grad_norm``:
    the backward's atomic sums may round otherwise, see
    ``backward_repeat``; and the two runs' weights after step 3). Launch
    counts of the first run. Then a third run of one whole epoch (8 steps)
    with no iteration checkpoint: its steps 4-7, after the prefetcher's
    head start of the cold step is used up, give the steady step time from
    the loader, against [train]'s synthetic step."""
    import os
    import torch
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.ops import interp, msda, render_weights

    wrappers = (render_weights.neus_render_fwd,
                render_weights.neus_render_bwd,
                interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
                msda.msda_fwd, msda.msda_bwd)
    flags = ["--py-config", "nuscenes_occ_fab", "--seed", str(SEED),
             "--print-freq", "1", "--prefetch", "2"]
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    a = train.main(flags + ["--max-steps", "4", "--ckpt-freq-iters", "2",
                            "--work-dir", os.path.join(work, "a")])
    launches = read_counts(wrappers, "training steps from the loader",
                           ("plane", "rows"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    b = train.main(flags + ["--max-steps", "4", "--iter-resume",
                            "--resume-from",
                            os.path.join(work, "a", "ckpts", "iter_2.pt"),
                            "--work-dir", os.path.join(work, "b")])
    if b["items"] != a["items"][2:]:
        raise AssertionError(f"resumed items {b['items']} != "
                             f"{a['items'][2:]}")
    losses = {}
    for step in (2, 3):
        va, vb = a["logged"][step], b["logged"][step]
        if not all(math.isfinite(v) for v in va.values()):
            raise AssertionError(f"non-finite losses at step {step}: {va}")
        keys = [k for k in va if k not in ("grad_norm", "lr")]
        rel = max(abs(va[k] - vb[k]) / max(abs(va[k]), 1e-30) for k in keys)
        losses[f"step{step}"] = {
            "bit_equal": all(va[k] == vb[k] for k in keys),
            "max_rel_diff": rel, "lr_equal": va["lr"] == vb["lr"],
            "grad_norm": [va["grad_norm"], vb["grad_norm"]]}
        if rel > 1e-5 or va["lr"] != vb["lr"]:
            raise AssertionError(f"resumed step {step} beyond rtol 1e-5: "
                                 f"{va} vs {vb}")
    # the two runs' weights after step 3 (a: iter_4, b: final)
    wa = torch.load(os.path.join(work, "a", "ckpts", "iter_4.pt"),
                    map_location="cpu")["model"]
    wb = torch.load(os.path.join(work, "b", "ckpts", "final.pt"),
                    map_location="cpu")["model"]
    weights_diff = max(float((wa[k].double() - wb[k].double()).abs().max()
                             / max(float(wa[k].double().abs().max()),
                                   1e-30))
                       for k in wa if wa[k].is_floating_point())
    # AdamW's step is scale-free: a parameter whose gradient is rounding
    # noise moves by up to lr either way, so the largest weight difference
    # is also given in units of the two steps' lr
    lrs = a["logged"][2]["lr"] + a["logged"][3]["lr"]
    losses["weights_after_step3_max_rel_diff"] = weights_diff
    losses["weights_after_step3_max_abs_diff_in_lr"] = max(
        float((wa[k].double() - wb[k].double()).abs().max())
        for k in wa if wa[k].is_floating_point()) / lrs
    del wa, wb
    backward = backward_repeat(a["items"][0], device)
    c = train.main(flags + ["--max-steps", "8",
                            "--work-dir", os.path.join(work, "c")])
    steady = sorted(c["step_s"][4:])
    med = (steady[1] + steady[2]) / 2
    res = {"items": a["items"], "resumed_items": b["items"],
           "step_s": a["step_s"], "data_wait_s": a["data_wait_s"],
           "epoch_step_s": c["step_s"], "epoch_data_wait_s": c["data_wait_s"],
           "step_s_steady_median": med,
           "synthetic_step_s": synthetic_step_s,
           "device_busy_share": (step_kernel_ms / 1e3 / med
                                 if step_kernel_ms else None),
           "max_memory_gb": peak, "launches": launches, "resume": losses,
           "backward_repeat": backward}
    log(f"  from the loader: items {a['items']}, resumed {b['items']}; resume "
        f"{losses}; step s {[round(x, 4) for x in a['step_s']]}, waits "
        f"{[round(x, 4) for x in a['data_wait_s']]}; one epoch: step s "
        f"{[round(x, 4) for x in c['step_s']]}, waits for the batch "
        f"{[round(x, 4) for x in c['data_wait_s']]} s; steady median (steps "
        f"4-7) {med:.4f} s against the synthetic {synthetic_step_s}, busy "
        f"share {res['device_busy_share']}, peak {peak:.2f} GiB")
    return res


def backward_repeat(index, device):
    """The same full-width step's loss and gradient computed twice on the
    same weights, batch and draws (no optimizer step): how far apart the
    global gradient norms of two backward passes are (the backward's
    atomic sums, ``msda_bwd`` and ``trilinear_bwd``, add in whatever order
    the card runs them)."""
    import torch
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.utils.runtime import to_device
    from selfocc_tpu_torch.utils.train_lib import build_loss_inputs
    cfg = get_config("nuscenes_occ_fab")
    trainer = train.build_trainer(cfg, SEED, device)
    model = trainer.model.train()
    batch = to_device(train.host_batch(build_dataset(cfg, "train"), index,
                                       SEED, 0, 0), device)
    out = []
    for _ in range(2):
        gen = torch.Generator(device=device).manual_seed(SEED)
        pred = model(batch["imgs"], batch["lidar2img"],
                     batch[cfg.model.head.trans_kw], train=True,
                     generator=gen)
        tot, _ = trainer.loss_fn(build_loss_inputs(cfg, pred, batch))
        model.zero_grad(set_to_none=True)
        tot.backward()
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in model.parameters() if p.grad is not None]))
        out.append((float(tot.detach()), float(norm)))
    (l0, n0), (l1, n1) = out
    res = {"loss": [l0, l1], "grad_norm": [n0, n1],
           "grad_norm_rel_diff": abs(n0 - n1) / n0}
    log(f"  the same step's backward twice: {res}")
    del trainer, model, batch
    torch.cuda.empty_cache()
    return res


def loader_profile(ds, n=2):
    """cProfile of ``n`` train items' host builds: the functions with the
    most cumulative time."""
    import cProfile
    import pstats
    from selfocc_tpu_torch import train
    prof = cProfile.Profile()
    prof.enable()
    for pos in range(n):
        train.host_batch(ds, pos, SEED, 2, pos)
    prof.disable()
    st = pstats.Stats(prof)
    rows = []
    for (fname, line, func), (_, ncalls, tt, ct, _) in st.stats.items():
        rows.append((ct / n, tt / n, ncalls // n,
                     f"{fname.rsplit('/', 1)[-1]}:{line}({func})"))
    rows.sort(reverse=True)
    top = [{"cum_s": round(c, 4), "self_s": round(t, 4), "calls": k,
            "fn": f} for c, t, k, f in rows[:25]]
    for r in top:
        log(f"    {r['cum_s']:8.4f} s cum {r['self_s']:8.4f} s self "
            f"x{r['calls']:<5d} {r['fn']}")
    return top


def eval_frames_from_loader():
    """One val frame through ``eval_depth.main`` and one through
    ``eval_iou.main`` (Occ3D by gather, masks, semantics) on the fabricated
    val split, each with its launch counts."""
    import numpy as np
    from selfocc_tpu_torch import eval_depth, eval_iou
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    res = {}
    wrappers = (render_weights.neus_render_fwd,
                interp.trilinear_cf_with_grad_fwd, msda.msda_fwd)
    reset_counts(wrappers)
    r = eval_depth.main(["--py-config", "nuscenes_occ_fab", "--num-samples",
                         "1", "--seed", str(SEED)])
    launches = read_counts(wrappers, "val depth frame")
    table = {k: float(np.asarray(v).mean()) for k, v in r["metric"].items()}
    if not all(np.isfinite(v) for v in table.values()):
        raise AssertionError(f"eval_depth table not finite: {table}")
    res["eval_depth"] = {"prepare_s": r["prepare_s"],
                         "render_s": r["render_s"], "rays": r["rays"],
                         "table_means": table, "launches": launches}
    wrappers = (interp.trilinear_cf_fwd, msda.msda_fwd)
    reset_counts(wrappers)
    r = eval_iou.main(["--py-config", "nuscenes_occ_fab", "--num-samples",
                       "1", "--occ3d", "--use-mask", "--sem", "--seed",
                       str(SEED)])
    launches = read_counts(wrappers, "val occupancy frame", ("plane", "rows"))
    scores = {k: r[k] for k in ("iou_miou", "iou_iou", "miou_miou",
                                "miou_iou")}
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"eval_iou scores not finite: {scores}")
    res["eval_iou"] = {"prepare_s": r["prepare_s"], "query_s": r["query_s"],
                       "scores": scores, "launches": launches}
    log(f"  val frames: depth {res['eval_depth']}; occupancy "
        f"{res['eval_iou']}")
    return res


def novel_frame(device):
    """``eval_novel_depth.main`` on the fabricated temporal_v2 split,
    ``--depth-tgt raw`` then ``max``: two frames each (frame 0 cold with one
    neighbour, frame 1 with two), launch counts; then on frame 1's first
    neighbour: depths finite and in their rays' bands, ``max_depth`` on the
    card against the CPU plain path on 4096 rays, a warm render under
    ``set_sync_debug_mode("error")``, and a profile of one 32768-ray chunk
    with and without ``max_depth``."""
    import numpy as np
    import torch
    from selfocc_tpu_torch import eval_depth, eval_novel_depth
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  enable_max_depth,
                                                  eval_ray_grid,
                                                  prep_input_imgs,
                                                  rays_for_cams)
    res = {}
    wrappers = (render_weights.neus_render_fwd,
                interp.trilinear_cf_with_grad_fwd, msda.msda_fwd)
    for tgt in ("raw", "max"):
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        r = eval_novel_depth.main(["--py-config", "nuscenes_novel_depth_fab",
                                   "--num-samples", "2", "--depth-tgt", tgt,
                                   "--seed", str(SEED)])
        launches = read_counts(wrappers, f"novel-view frames ({tgt})")
        table = {b: v for b, v in r["table"].items()}
        if not table or not all(np.isfinite(v).all()
                                for v in map(np.asarray, table.values())):
            raise AssertionError(f"novel depth table ({tgt}): {table}")
        warm = r["render_s"][1:]          # frame 1's two neighbours
        res[tgt] = {"prepare_s": r["prepare_s"], "render_s": r["render_s"],
                    "render_s_warm": warm, "rays": r["rays"],
                    "rays_per_s": r["rays"] / (sum(warm) / len(warm)),
                    "max_memory_gb": torch.cuda.max_memory_allocated()
                    / 2**30, "launches": launches, "table": table}
        log(f"  novel ({tgt}): prepare {r['prepare_s']} s, render per "
            f"neighbour {r['render_s']} s ({res[tgt]['rays_per_s']:.0f} "
            f"rays/s warm), peak {res[tgt]['max_memory_gb']:.2f} GiB, "
            f"table {table}")

    # frame 1's first neighbour, on the model the driver built
    cfg = enable_max_depth(get_config("nuscenes_novel_depth_fab"))
    model = eval_depth.build_model(cfg, SEED, device)
    input_imgs, _, metas = build_dataset(cfg, "novel_eval")[1]
    imgs = prep_input_imgs(input_imgs, cfg, device)
    l2i = torch.as_tensor(np.asarray(metas["lidar2img"]), dtype=torch.float32,
                          device=device)[None]
    renderer = ChunkedRenderer(model, chunk=CHUNK,
                               outputs=("depth", "max_depth", "acc"))
    volume = renderer.prepare(imgs, l2i)
    tem = torch.as_tensor(np.asarray(metas["temImg2lidars"][0]),
                          dtype=torch.float32, device=device)[None]
    origin, direction = rays_for_cams(tem, eval_ray_grid(cfg, device=device))
    n_rays = cfg.num_cams * cfg.eval_num_rays[0] * cfg.eval_num_rays[1]
    if origin.shape[0] != n_rays:      # 6 x 450 x 800 = 2,160,000
        raise AssertionError(f"{origin.shape[0]} rays, expected {n_rays}")
    out = renderer.render_device(volume, origin, direction)
    dn = torch.linalg.norm(direction, dim=-1)
    near, far = neus.ray_aabb_near_far(origin, direction / dn[:, None],
                                       cfg.model.head.roi_aabb)
    for k in ("depth", "max_depth"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"novel {k}: non-finite")
    lo = out["acc"] * near / dn - 1e-3
    if bool((out["depth"] < lo).any()) or \
            bool((out["depth"] > far / dn * (1 + 1e-5) + 1e-3).any()):
        raise AssertionError("novel depth outside [acc near, far]")
    hit = out["acc"] > 0
    if bool((out["max_depth"][hit] < near[hit] / dn[hit] - 1e-3).any()) or \
            bool((out["max_depth"] > far / dn * (1 + 1e-5) + 1e-3).any()):
        raise AssertionError("novel max_depth outside [near, far]")
    # max_depth on the card against the plain path on the CPU, 4096 rays:
    # each path's max_depth is its ts at the argmax of its w / deltas; the
    # two take the same sample except where the CPU's two largest w /
    # deltas lie within 1e-6 (relative) of each other, and where they take
    # the same sample its ts agree within 1e-6 of the largest ts (the
    # kernel's ts tolerance, render_fwd_error)
    idx = torch.linspace(0, origin.shape[0] - 1, SUBSET_RAYS,
                         device=device).long()
    outs = ("max_depth", "weights", "deltas", "ts")
    gpu = ChunkedRenderer(model, chunk=SUBSET_RAYS, outputs=outs).render(
        volume, origin[idx], direction[idx])
    cpu_model = copy.deepcopy(model).cpu()
    cpu = ChunkedRenderer(cpu_model, chunk=SUBSET_RAYS, outputs=outs).render(
        volume.cpu(), origin[idx].cpu(), direction[idx].cpu())
    eps = np.float32(np.finfo(np.float32).eps)

    def ratio(r):      # in fp32, as the head divides: the same argmax
        return np.where(r["deltas"] < eps, np.float32(0), r["weights"]) \
            / np.maximum(r["deltas"], eps)
    r_c, r_g = ratio(cpu), ratio(gpu)
    rows = np.arange(SUBSET_RAYS)
    ig, ic = r_g.argmax(-1), r_c.argmax(-1)
    if not (np.array_equal(gpu["ts"][rows, ig], gpu["max_depth"])
            and np.array_equal(cpu["ts"][rows, ic], cpu["max_depth"])):
        raise AssertionError("max_depth is not ts at the argmax of w/deltas")
    top = np.sort(r_c.astype(np.float64), -1)
    tie = (top[:, -1] - top[:, -2]) < 1e-6 * np.abs(top[:, -1])
    flips = ig != ic
    same = ~flips
    ts_err = float(np.abs(gpu["max_depth"][same].astype(np.float64)
                          - cpu["max_depth"][same]).max(initial=0.0))
    ts_tol = 1e-6 * float(np.abs(cpu["ts"]).max())
    res["max_depth_subset"] = {
        "rays": SUBSET_RAYS, "other_sample": int(flips.sum()),
        "other_sample_outside_ties": int((flips & ~tie).sum()),
        "near_ties": int(tie.sum()), "bit_equal": int(
            (gpu["max_depth"] == cpu["max_depth"]).sum()),
        "same_sample_max_abs_err": ts_err, "ts_tolerance": ts_tol,
        "weights_max_abs_err": float(np.abs(
            gpu["weights"].astype(np.float64) - cpu["weights"]).max())}
    if (flips & ~tie).any() or not ts_err <= ts_tol:
        raise AssertionError(f"max_depth against the CPU: "
                             f"{res['max_depth_subset']}")
    # a warm neighbour render under the sync check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = renderer.render_device(volume, origin, direction)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    res["sync_checked"] = True
    # one render chunk and one neighbour's render, with and without
    # max_depth: kernels and kernel ms (torch.profiler), events ms
    from torch.profiler import ProfilerActivity, profile
    prof = {}
    for tag, outputs in (("raw", ("depth",)), ("max", ("max_depth",))):
        rr = ChunkedRenderer(model, chunk=CHUNK, outputs=outputs)
        for part, (o, d) in (("chunk", (origin[:CHUNK], direction[:CHUNK])),
                             ("neighbour", (origin, direction))):
            fn = (lambda rr=rr, o=o, d=d: rr.render_device(volume, o, d))
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                fn()
                torch.cuda.synchronize()
            kernels = [e for e in p.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            prof[f"{tag}_{part}"] = {
                "kernels": sum(e.count for e in kernels),
                "kernel_ms": sum(e.self_device_time_total
                                 for e in kernels) / 1e3,
                "events_ms": timed(fn, 3 if part == "neighbour" else 10)}
    res["profile"] = prof
    log(f"  novel neighbour render: depths finite and in band; max_depth "
        f"subset {res['max_depth_subset']}; warm render under "
        f"set_sync_debug_mode('error'): no synchronising call; profile "
        f"{prof}")
    del model, cpu_model, volume, out
    torch.cuda.empty_cache()
    return res


def data_phase(device, train_res=None):
    """The nuScenes data path on a fabricated full-size dataset (a
    temporary directory, removed after): loader rates, training from the
    loader with a mid-epoch resume, the val frames and the novel-view
    frame. ``train_res``: the [train] phase's result (the synthetic step and
    its kernel time) when it ran in this call."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="selfocc_nusc_")
    try:
        t0 = time.time()
        paths = fabricate_nuscenes(root)
        occ_cfg, _ = fabricated_configs(paths)
        log(f"  fabricated {FAB_SAMPLES} keyframes x 6 cameras of "
            f"{FAB_IMG[0]}x{FAB_IMG[1]} JPEGs, {FAB_LIDAR_POINTS} lidar "
            f"points each, in {time.time() - t0:.1f}s")
        res = {"loader": loader_rates(occ_cfg)}
        syn = kms = None
        if train_res is not None:
            syn = train_res["median"]["step_s"]
            kms = train_res["profile"]["kernel_ms"]
        res["train"] = train_from_loader(root, syn, kms, device)
        res["eval"] = eval_frames_from_loader()
        res["novel"] = novel_frame(device)
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="a checkout of another commit: [kernels] also times "
                    "its trilinear kernels at the main paths' points, and "
                    "[frame] profiles its eval frame, in turns with this "
                    "checkout's")
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

    runs = {"kernels": lambda: dict(
                kernel_checks(device, args.baseline),
                weights_path_launches=weights_path(device)),
            "gather": lambda: gather_path(device),
            "frame": lambda: full_frame(device, args.baseline),
            "occ": lambda: occ_frame(device),
            "train-parity": lambda: train_parity(device),
            "train": lambda: full_train(device),
            "data": lambda: data_phase(device, phases.get("train"))}
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
    # weights_from_alpha's own path, as gather_rows's: no main path
    # launches neus_weights_fwd since the render is fused
    kres["neus_weights_fwd"].update(
        launches=kres.pop("weights_path_launches"), launches_main_path=0)
    fres, tres, ores = phases["frame"], phases["train"], phases["occ"]
    dres = phases["data"]
    data_launches = {
        "data_train": dres["train"]["launches"],
        "data_depth_frame": dres["eval"]["eval_depth"]["launches"],
        "data_occ_frame": dres["eval"]["eval_iou"]["launches"],
        "novel_raw": dres["novel"]["raw"]["launches"],
        "novel_max": dres["novel"]["max"]["launches"]}
    log(f"[frame] prepare {fres['prepare_s']:.3f}s render "
        f"{fres['render_s']:.3f}s ({fres['rays'] / fres['render_s']:.0f} "
        f"rays/s), peak {fres['max_memory_gb']:.2f} GiB allocated")
    sources = {
        "neus_render_fwd": ("neus_weights.cu",
                            "selfocc_tpu/ops/render_pallas.py:54"),
        "neus_render_bwd": ("neus_weights.cu",
                            "selfocc_tpu/ops/render_pallas.py:76"),
        "neus_weights_fwd": ("neus_weights.cu",
                             "selfocc_tpu/ops/render_pallas.py:54"),
        "trilinear_cf_with_grad_fwd": ("trilinear.cu",
                                       "selfocc_tpu/ops/interp.py:159"),
        "trilinear_bwd": ("trilinear.cu", "selfocc_tpu/ops/interp.py:159"),
        "trilinear_cf_fwd": ("trilinear.cu",
                             "selfocc_tpu/ops/interp.py:118"),
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
        in_step = tres["profile"]["neus_render_kernels"].get(name)
        if in_step is not None:
            entry["in_step_ms_per_call"] = in_step["ms_per_call"]
            entry["in_step_calls"] = in_step["calls"]
        if name in fres["launches"]:
            entry["launches_eval_frame"] = fres["launches"][name]
        for path, counts in data_launches.items():
            if name in counts:
                entry[f"launches_{path}"] = counts[name]
        if name == "trilinear_cf_fwd":
            # its main path is the occupancy eval: the Occ3D gather frame
            occ_l = {t: ores[t]["launches"] for t in
                     ("occ3d_gather", "occ3d_separable", "openocc")}
            entry["launches"] = occ_l["occ3d_gather"][name]
            entry.update({f"launches_{t}": v for t, v in occ_l.items()},
                         frame_checks=ores["kernel_vs_plain"])
        kernels.append(entry)
    print(json.dumps({
        "kernels": kernels,
        "frame": {"prepare_s": fres["prepare_s"],
                  "render_s": fres["render_s"], "rays": fres["rays"],
                  "rays_per_s": fres["rays"] / fres["render_s"],
                  "max_memory_gb": fres["max_memory_gb"],
                  "cold_frame": fres["cold"],
                  "subset_max_abs_err": fres["subset_err"],
                  "chunks": fres["chunks"],
                  "launches_per_chunk": fres["launches_per_chunk"],
                  "profile": fres["profile"],
                  "sync_checked": fres["sync_checked"]},
        "occ": {k: v for k, v in ores.items()
                if k != "kernel_vs_plain"},
        "train_parity": phases["train-parity"],
        "train": {k: v for k, v in tres.items() if k != "launches"},
        "data": dres}),
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
