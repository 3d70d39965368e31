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
  pair ``trilinear_cf_fwd`` / ``trilinear_cf_bwd`` at their main-path
  shapes (the dense occupancy query, the kitti_occ uniform sdf grid at
  C = 4 and the compact second derivative's one query of 6 x 1,048,576
  point-major taps; timed against ``F.grid_sample`` and its backward too)
  and at edge cases (points outside the volume and on its knots, counts no
  multiple of a tile, row strides above C, rows and cotangents off 16-byte
  alignment; the values bit-equal to the with-grad forward's), the compact
  ``second_grad``'s one query against one query per tap (forward bit for
  bit, the volume's cotangent within GRAD_RTOL, one launch each way), and
  ``gather_rows`` on an fp32 table of 28-byte rows. ``--baseline DIR`` (a
  checkout of another commit) also times that checkout's trilinear
  kernels at the main paths' points, the values-only pair included, in
  turns with this one's (and ``[frame]`` profiles that checkout's eval
  frame beside this one's).
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
  same values, without and with its channel-first copy, and a strided
  bound counts each corner row as whole 32-byte sectors); the Occ3D
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
  (``train_ray_chunk = 0``): one warm-up step and one measured step;
  then ``train.main`` itself at that width with the driver's options
  (``--gradient-accumulation 2 --profile --eval-every-epoch
  --eval-samples 1 --max-steps 6``: the run log with the per-epoch depth
  table, ``scalars.jsonl``, a profiler trace that names the port's
  kernels, the checkpoint's micro-step and update counts) and, on one
  batch, K = 2 against one step on the mean of the same two gradients
  (parameters bitwise unchanged after micro-step 1).
- ``[data]``: the nuScenes data path on a full-size nuScenes-format dataset
  fabricated in a temporary directory (one scene of 8 keyframes, 6 cameras
  of 900x1600 JPEGs, 34,000-point lidar sweeps, the sweeps and temporal_v2
  infos, Occ3D labels for keyframe 0, offline teacher maps), registered as
  the configs ``nuscenes_occ_fab`` / ``nuscenes_novel_depth_fab``: which
  image decoder the loaders run (``selfocc_tpu_torch.native`` or, where it
  did not build, cv2, with the reason), the native decode of 24 of its
  JPEGs against cv2's (within 2 LSBs on each image's mean) and both
  decodes' host seconds; the host seconds per train item of
  ``build_dataset`` (with a cProfile of two items) and
  ``BatchPrefetcher``'s items/s at depth 2, with the native decoder and
  again on the loaders' cv2 path; 4 ``nuscenes_occ``
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

- ``[kitti]``: the SemanticKITTI recipe on a full-size odometry tree
  fabricated in a temporary directory (sequences 00 and 08, 12 and 11
  frames 1.03 m apart, 1226x370 PNGs, 120,000-point scans, sequence 00's
  calibration, 256x256x32 labels every 5th val frame), registered as
  ``kitti_occ_fab`` / ``kitti_novel_depth_fab``: the loaders' image
  decoder and its PNG decode against cv2's (exact); 5 ``kitti_occ`` steps at
  full width from the loader through ``train.main`` (the five losses and
  ``grad_norm`` finite; 8 synchronised warm steps for the median and
  spread; a profiled warm step with its launches, the values-only kernels
  on the plane 6 times forward and 3 times backward; a warm step under
  ``torch.cuda.set_sync_debug_mode("error")``); a KITTI-shaped
  ``tiny`` step on the card against the CPU (losses rtol 1e-5; gradients,
  SecondGradLoss's apart); ``eval_iou_kitti.main`` on one val frame (256 x
  256 x 32 grid; the kernel path's occupancy against the plain path's,
  equal but where |sdf| < 1e-5); ``eval_depth.main`` on one val frame
  (its lidar depth: launches, times, a finite table);
  ``eval_novel_depth_kitti.main`` with
  ``raw`` and ``max`` (two frames, 14 neighbours of 176 x 608 rays) and a
  4096-ray subset on the card against the CPU.

- ``[depth]``: the depth recipes on fabricated full-size data in a
  temporary directory: a KITTI-raw tree (the day 2011_09_26 with two drives
  of 12 frames 1.0123 m apart, 1242x375 PNGs with per-frame texture,
  120,000-point scans, KITTI-like calibration, ORB-SLAM poses, eigen_zhou
  split files) registered as ``kitti_raw_depth_fab``, and the ``[data]``
  nuScenes tree registered as ``nuscenes_depth_fab``: the loaders' image
  decoder and its PNG decode against cv2's (exact); 5 ``kitti_raw_depth``
  steps at full width from the loader through ``train.main`` (the three
  losses and ``grad_norm`` finite, step times, waits, peak, host seconds
  per item, with the native decoder and on the cv2 path; on one loader
  batch, its focal ratios checked, warm steps, a
  profiled step and one under ``set_sync_debug_mode("error")``); a
  KITTI-raw-shaped ``tiny`` step from a loader batch with its focal ratios
  on the card against the CPU; ``eval_depth.main`` on 2 val frames raw,
  ``--flip``, ``--depth-metric-tgt max`` and ``--save-depth`` (then a
  4096-ray subset, ``max_depth`` and the flipped prepare's volume against
  the CPU and a warm flipped frame under the sync check); 3
  ``nuscenes_depth`` steps likewise. Every depth path must launch the
  trilinear kernels on the plane instance only, and never the rows
  instance, ``trilinear_cf_*`` or ``neus_weights_fwd``. ``[kernels]``
  also holds the plane instance at the first ``kitti_raw_depth`` training
  chunk's points.

- ``[levers]``: the encoder's recipe options at full width (the card's
  name and power limit logged first): ``msda_shared_fwd`` /
  ``msda_shared_bwd`` at the ``nuscenes_occ_fast`` calls (the TPV
  self-attention, the compacted hw and zh cross-attention) against their
  plain versions and against the per-head ``msda_fwd`` / ``msda_bwd`` on
  broadcast locations, timed (events, device ms) beside the per-head
  kernels at the compacted and the dense shapes, with the instance each
  call takes (lane group, float4s a lane, staging, registers, shared
  bytes), and the backward's device ms over the forward's beside its RED
  bytes; then at off-path widths (scalar lanes, rows no multiple of the
  group, R = 6, a two-lane group, a weights block that is no multiple of
  16 bytes, a value off 16-byte alignment, unit counts no multiple of the
  tile, fewer units than SMs, a tile too large for shared memory), each
  with its instance; with ``--baseline``, the other checkout's shared
  kernels in turns with this one's; one ``nuscenes_occ_compact`` eval frame
  against ``nuscenes_occ`` on the same seeded weights (planes bit-equal or
  within 1e-6 of their scale, every ``visible_overflow`` 0; prepare_s, MSDA
  device ms of a warm prepare, and the compaction's argsort, gathers and
  row copy in device ms per plane); one ``nuscenes_occ_fast`` eval frame
  (depths finite and in band, their deviation from ``nuscenes_occ``'s); 3
  measured steps each of ``nuscenes_occ_compact_train`` and
  ``nuscenes_occ_fast`` (step split, peak memory, launches, a profiled
  step, a warm step under ``set_sync_debug_mode("error")``); and one
  ``tiny_fast`` step on the card against the CPU, as ``[train-parity]``.
  The shared kernels' ``launches`` in the result line are those of the
  ``nuscenes_occ_fast`` steps.

- ``[bev]``: the BEV recipe ``nuscenes_occ_bev`` at full width (the card's
  name and power limit logged first): a ``tiny_bev`` step on the card
  against the CPU, as ``[train-parity]``; ``msda_fwd`` / ``msda_bwd`` at
  the BEV self-attention (66,049 queries on one 257 x 257 level, 12
  points) and cross-attention calls against their plain versions, timed;
  ``trilinear_cf_fwd`` / ``trilinear_cf_bwd`` at the step's uniform sdf
  query (640,000 jittered points, C = 25; the backward also for the
  step's cotangent, the sdf channel alone live) against their plain
  versions, timed beside ``F.grid_sample`` and its channel-first copy;
  3 measured steps (median, spread, split, peak, launches), a profiled
  step and one under ``set_sync_debug_mode("error")``; one eval frame
  through ``eval_depth``'s code path (prepare_s, render_s, launches, a
  4096-ray subset against the CPU, the device work sync-checked) and one
  Occ3D frame through ``eval_iou``'s.
- ``[density]``: the density head, ``nuscenes_occ_density`` at full width:
  ``neus_weights_fwd`` / ``neus_weights_bwd`` at 28,800 x 256 (a step's
  one render) and 32,768 x 256 (an eval chunk) against their plain
  versions, timed, the backward also against a float64 reference on rows
  with saturated alpha and alpha exactly 0, and at off-path shapes; the
  values-only pair at the step's 7,372,800-point query (C = 25), as in
  ``[bev]``; a ``tiny_nerfacc`` step on the card against the CPU; 3
  measured steps, a profiled one and one under the sync check; one eval
  frame (the subset's depth held to [near, far] where acc > 0: the head
  normalises it by the opacity) and one ``eval_iou --density --thresh
  0.5`` Occ3D frame. ``neus_weights_fwd`` / ``neus_weights_bwd``'s
  ``launches`` in the result line are those of the density steps.

- ``[head]``: the rest of the NeuS head at ``nuscenes_occ``'s full width
  and depth (seeded weights, synthetic data): the three kernels' new
  instances against their plain versions and timed (device time, events,
  plain version, bound, ``F.grid_sample``'s backward with a grid that needs
  a gradient): ``neus_weights_bwd`` above 256 samples (rows staged
  through shared memory: one pass up to 512 samples, tiles of 512 above;
  4096 and 32768 x 320, the rounds' 4096 x 255 .. 303, float64 on
  saturated rows at S = 320 and 271, off-path S up to 8192; with
  ``--baseline``, another checkout's beside it in turns), the point
  instances of ``trilinear_bwd`` (rows C
  = 25, plane) at 4096 x 320 points and of ``trilinear_cf_bwd`` (the sdf
  plane read at row stride 25) at the rounds' 4096 x 256 .. 304 points and
  the six taps of 4096 x 320; each option set's tiny step on the card
  against the CPU (``train_parity`` with its on-card baseline) and
  ``two_split``'s outputs; 3 steps (profiled, sync-checked) of the
  importance recipe (64 samples in 4 rounds, ``return_sample_sdf``,
  ``AdaptiveSparsityLoss``) and of the options recipe (numerical
  gradients, ``beta_hand_tune``, ``anneal_aabb``, the surface and uniform
  sdf with ``SparsityLoss`` and ``HardSparsityLoss``); eval frames of one
  model with uniform, importance and 64 + 64 skip samples, and the skip
  and importance frames' depth deviation from the uniform frame's
  (reported, not bounded: another function). The kernels line lists the
  new instances as ``neus_weights_bwd.tiled``, ``trilinear_bwd.points``
  and ``trilinear_cf_bwd.points``, with the importance steps' launches.

- ``[variants]``: ``nuscenes_occ`` at full width and depth with the model
  options no shipped config sets, all at once (``variant_config``:
  ``TPVPositionLifter``, ``CameraAwareSE``, ``multi_plane_ffn_norm``,
  random rays, ``NonLinearMapping`` at its defaults, a 321 x 321 x 31
  field): its tiny twin's step on the card against the CPU, 3 measured
  steps (profiled, sync-checked), an eval frame and an Occ3D frame with
  the cameras (a 4096-ray subset against the CPU); then the BEV flow head
  at ``nuscenes_occ_bev``'s width (flows and warped samples against the
  CPU; its step must launch the narrow instances of ``trilinear_cf_fwd`` /
  ``_bwd`` twice each and no walk; their in-step device ms; the head
  timed beside the route they replaced) and both narrow instances on its
  7,372,800 unclipped samples (border padding in the kernel) against
  their plain versions, ``F.grid_sample`` with border padding and the
  C = 3 walks they replaced, and the point instance at knots on every
  face. The kernels line lists them as ``trilinear_cf_fwd.narrow`` and
  ``trilinear_cf_bwd.narrow``.

- ``[unet]``: ``nuscenes_occ`` on the UNet2D backbone (EfficientNet-B7,
  ``unet_scaling`` (2.0, 3.1), the AdaBins decoder) with the identity neck
  (``unet_config``: 96 channels at strides 2..16 of the 384 x 800 input),
  seeded weights, synthetic batches: its tiny twin (``(0.25, 0.35)``) on
  the card against the CPU, as ``[train-parity]``; ``msda_fwd`` /
  ``msda_bwd`` at the image cross-attention's calls on the UNet's levels
  (192 x 400, 96 x 200, 48 x 100, 24 x 50; hw 66,049 queries, 8 points;
  zh / wz 6,425 queries, 48 points) against their plain versions, timed,
  with bounds; 3 measured steps (median, spread, forward / backward /
  optimizer split, peak, launches), a profiled step (kernels, kernel ms,
  busy share, the top kernels, MSDA ms per call) and one under
  ``set_sync_debug_mode("error")``; one eval frame (prepare_s, render_s,
  a 4096-ray subset against the CPU, the device work sync-checked).
- ``[teacher]``: the online semantic teacher of ``train.py
  --teacher-ckpt``: a random Swin-T (embed 96, depths 2/2/6/2, window 7)
  under a 512-channel UperNet with 21 classes, written in HF's keys as
  ``.pt`` and ``.safetensors`` in a temporary directory and loaded from
  both (the same weights); its logits and maps on the card against the
  CPU on one 96 x 160 image; its ms a call on 6 x 768 x 1600 (events,
  device time, peak, top kernels); ``nuscenes_occ`` steps on one synthetic
  batch with its ``sem_gt`` and with the teacher's maps in its place, in
  turns; then ``train.main --teacher-ckpt`` for 2 steps from the loader
  on a fabricated nuScenes tree whose config reads no offline maps (it
  fails unless the teacher fills ``sem_gt``: the semantic loss reads it).
- ``[vis]``: the vis tools at ``nuscenes_occ``'s full width, seeded
  weights, synthetic data (the card's name and power limit logged first):
  ``vis_pics.main`` on one frame from the pose offset by ``--novel-view
  1.0123 0.5 0.3 10`` (off voxel knots; 6 x 450 x 800 rays, depth and RGB,
  so every channel is sampled: ``msda_fwd`` 16 times, ``neus_render_fwd``
  and the C = 25 rows instance of ``trilinear_cf_with_grad_fwd`` once per
  32768-ray chunk), its prepare, render and PNG seconds, rays/s, peak and
  the share of RGB channels that JAX's 256 * 255 scale saturates; on the
  same seeded weights and frame the depths in band, a 4096-ray subset
  against the plain versions on the CPU (depth 1e-3 m, acc and rgb 1e-4),
  ``msda_fwd`` at the prepare's own calls and the C = 25 forward at the
  render's first chunk (8,388,608 points) against their plain versions,
  timed with their bounds; ``vis_3d.main --gt`` (the 200 x 200 x 16 grid
  at 0.4 m: ``trilinear_cf_fwd`` once at C = 25), its seconds and voxel
  count, then on one volume the kernel occupancy against the plain one
  (equal but where |sdf - thresh| < 1e-5) and ``trilinear_cf_fwd`` at the
  grid's 640,000 points timed beside ``F.grid_sample``, at the threshold
  that splits the grid (the seeded weights put every voxel below 0);
  ``vis_3d_scene.main --imageset`` over 2 keyframes of a fabricated
  full-size nuScenes tree (``scene.ply``'s points are the frames' voxels);
  ``generate_videos.main`` on ``vis_pics``'s PNGs (a non-empty mp4). Each
  path's launch counts (every kernel's, by instance) are set to 0 just
  before it and read just after; a count other than the path's expected
  one, or a kernel off the path, fails the run.
- ``[dp]``: data-parallel training and the sharded eval at
  ``nuscenes_occ``'s full width, synthetic data. Two gloo ranks share the
  card (NCCL refuses two ranks on one device; the phase prints the
  backend), spawned by ``parallel.mesh.spawn``; each takes one step on its
  own item (0 or 1) with its launch counts set to 0 just before and read
  after (every kernel of the step on every rank), then ``DP_STEPS`` timed
  steps. The ranks' parameters must be bit-equal after the step and
  within 1e-5 of each tensor's max of one process's optimizer step on the
  mean of the ranks' own gradients, the averaged losses the mean of the
  ranks' own (rtol 1e-5), the BatchNorm statistics the mean of their own
  updates. The one-rank step is timed beside them and run in a one-rank
  NCCL group under ``set_sync_debug_mode("error")``; ``train.main --dp``
  runs 2 steps over NCCL on every visible card (one card: the plain step,
  launches counted); one eval frame and one 512 x 512 x 40 occupancy
  query on ``[cuda:0, cuda:0]`` and on every visible card (the prepare's
  cameras split, the render's rays and the query's points) must equal the
  one-device frame within 1e-6 of its largest value. Prints step seconds
  (median, spread), all-reduce ms and bytes a step, peak GiB per rank, the
  card count, render seconds sharded and not.
- ``[mp]``: the model-parallel step (``train --mp``) at ``nuscenes_occ``'s
  full width on synthetic item 0: two gloo ranks share the card (gloo's
  CUDA route of ``gather_rows``: an all-reduce of zeroed rows), each with
  the TPV encoder's query rows of its half of each plane; one step with
  each rank's launch counts set to 0 just before and read after, held to
  one process's step on the same item and generator (losses and
  ``total`` rtol 1e-5, every gradient within 1e-4 of its max + 1e-7,
  ``grad_norm`` rtol 1e-4, the updated parameters atol 2e-5 + rtol 1e-4)
  with the ranks bit-equal; one step with each collective synchronised
  and timed (ms and bytes), ``MP_STEPS`` timed steps (step seconds, peak
  GiB a rank against one process's) and one profiled step (MSDA's
  in-step ms at the sharded shapes); ``msda_fwd`` / ``msda_bwd`` against
  their plain versions at rank 0's sharded shapes; one warm model-parallel
  step in a one-rank NCCL group under ``set_sync_debug_mode("error")``;
  ``train.main --mp`` for 2 steps over NCCL on every visible card (one
  card: the plain step, launches counted).

``--phases`` runs a subset (then no result line is printed). Each path's
launch counts are set to 0 just before it runs and read just after; a
kernel of the path that was not launched fails the run (the trilinear
wrappers' counts also by instance: C = 1 ``plane``, C > 1 ``rows``, and
where a path needs them the point and tile instances), and so does a
launch of a kernel that a path must not run (``neus_weights_fwd`` on a
NeuS path with uniform samples: that render is fused; the fused render on
the importance and skip paths, which take the alpha-input route). Prints a
``{"kernels": [...]}`` line, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 before
doing anything. Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
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
# the FPN levels of a nuScenes 384 x 800 input: the image cross-attention's
# value shapes
FPN_SHAPES = ((96, 200), (48, 100), (24, 50), (12, 25))
FP32_FLOPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
GRAD_RTOL = 1e-4                  # max|d| <= 1e-4 * max|ref| + 1e-7
# fp32 operations (an FMA counts 2) that MSDA needs per sampled location
# (pixel position, corner weights; the backward also scales the location
# gradient by the level size) and per (location, channel): forward, the
# 4-corner blend and the attention-weighted accumulate. The backward needs
# per (location, channel) the 4 corner dots with the cotangent and the 4
# scaled adds into grad_value, and per (location, head) the weight gradient
# from those dots (8), the x and y slopes from them scaled by the weight
# (12), their sum over heads (2) and the 4 corner scales a * w (4). In the
# per-head op a location has one head.
MSDA_FWD_OPS = (12, 10)
MSDA_BWD_OPS = (14, 26, 16)
# fp32 operations per sample of the fused NeuS render (a transcendental
# counts 1): forward, the cosine (5), the section estimate and its two
# sigmoids (18), alpha and its log (7), the scan and the weight (3), the
# composites and the normal (17); the backward recomputes those and adds
# G (10), the recurrence (4), the chain through the sigmoids and the
# cosine (22) and the normal's projection (17)
RENDER_FWD_OPS = 50
RENDER_BWD_OPS = 103
PHASES = ("kernels", "gather", "frame", "occ", "train-parity", "train",
          "data", "kitti", "depth", "levers", "bev", "density", "head",
          "variants", "unet", "teacher", "vis", "dp", "mp")
OPENOCC_PCR = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)   # 512 x 512 x 40 at 0.2
OCC_SLAB = 1 << 20    # dense-grid points held against the plain version
# the compact stencil's volume cotangent, card against CPU on one volume:
# the error beyond GRAD_RTOL of its max, over the voxel's sum of term
# magnitudes (see kitti_train_parity)
STENCIL_RTOL = 1e-6
WARM_STEPS = 8        # kitti_occ steps on one batch timed for the median


def log(msg):
    print(msg, flush=True)


def card_name():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


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


def batched_ms(fn, reps):
    """Milliseconds per call of ``fn()`` over ``reps`` calls enqueued back
    to back between one pair of CUDA events, after a warm-up: the launch
    gaps hide behind the card's work where a call takes longer than its
    launch, and no profiler record can be lost."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device milliseconds per call of ``fn()``: the time of the CUDA
    kernels it launches (a wrapper's fills included), summed by
    ``torch.profiler`` over ``reps`` calls after a warm-up. Unlike
    ``timed`` it leaves out the gaps in which the card waits for the
    host's next launch, which dominate calls of a few tens of µs. A
    profile that recorded no device time (seen once in a run of many), or
    in which some kernel's count is no multiple of ``reps`` (a lost
    record: one of five calls of a one-kernel function once read 0.8 of
    its time), is logged and taken again. If the third is such a profile
    too, each kernel counts at its mean time, as many times a call as the
    profile saw it per call, rounded up; None if all three were empty."""
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    last = None
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.count]
        us = sum(e.self_device_time_total for e in kernels)
        odd = [f"{e.key[:60]} x{e.count}" for e in kernels
               if e.count % reps]
        if us > 0 and not odd:
            return us / reps / 1e3
        log(f"    device_ms: profile {attempt + 1} of {reps} calls "
            + (f"has counts no multiple of the calls: {'; '.join(odd)}"
               if us > 0 else "recorded no device time"))
        if us > 0:
            last = sum(e.self_device_time_total / e.count
                       * math.ceil(e.count / reps) for e in kernels)
    return None if last is None else last / 1e3


def cold_device_ms(fn, reps, key):
    """Device milliseconds per call of the kernels named ``key`` in
    ``fn()``, with the L2 cache flushed before every call (a 256 MB fill in
    between, left out of the sum): what the call takes when none of its
    inputs lies in L2 from the call before."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    junk = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            junk.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and key in e.key)
    del junk
    return us / reps / 1e3 if us > 0 else None


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


def float64_check(name, got, plain, ref64):
    """Each cotangent of a kernel (``got``) and of its plain version in
    fp32 (``plain``) against the plain version run in float64 on the same
    inputs (``ref64``): the kernel may sit no farther from float64 than
    twice the fp32 plain version's distance plus 1e-7 of the float64
    result's scale. Returns the distances by cotangent."""
    out, far = {}, []
    for which, k, pl, r in zip(("volume", "points"), got, plain, ref64):
        d_k, d_p = max_err(k, r), max_err(pl, r)
        scale = float(r.abs().max())
        tol = 2.0 * d_p + 1e-7 * scale
        log(f"  {name} {which} cotangent against float64: kernel "
            f"{d_k:.3e}, fp32 plain {d_p:.3e} (bound {tol:.3e}, scale "
            f"{scale:.3e})")
        if not d_k <= tol:
            far.append(f"{which} {d_k:.3e} > {tol:.3e}")
        out[which] = {"kernel": d_k, "plain_fp32": d_p, "scale": scale}
    if far:
        raise AssertionError(f"{name}: the kernel sits farther from float64 "
                             "than twice the fp32 plain version: "
                             + "; ".join(far))
    return out


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


def raw_depth_points(device):
    """The trilinear kernels' points on the kitti_raw_depth training path:
    the first 4096-ray chunk of its 44 x 152 ray grid (a synthetic batch,
    the cellular sampler and the jitter from a seeded generator; 1,048,576
    points) as fractional indices of its (1, 257, 257, 33) volume. Returns
    (grid shape, points)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.geometry.projection import rays_from_img2lidar
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("kitti_raw_depth")
    h = cfg.model.head
    head = TPVSegmentor(cfg.model).head
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    origin, direction = rays_from_img2lidar(batch[h.trans_kw],
                                            head.ray_sampler(device, gen))
    origin = origin[:, :, None, :].expand(direction.shape).reshape(-1, 3)
    direction = direction.reshape(-1, 3)
    n = h.train_ray_chunk
    t_rand = torch.rand((n, head.num_samples + 1), generator=gen,
                        device=device)
    return tuple(head.field.grid_shape), render_grid_points(
        head, origin[:n], direction[:n], t_rand)


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
    # the plane instance on the kitti_raw_depth step's one-channel volume
    # (its sdf query with both cotangents live)
    raw_shape, pts["kitti_raw"] = raw_depth_points(device)
    voxels["kitti_raw"] = corner_voxels(pts["kitti_raw"], raw_shape)
    vol_raw = torch.randn((1,) + raw_shape, generator=g, device=device)
    case("c1_kitti_raw", "fwd", vol_raw, "kitti_raw", 20)
    case("c1_kitti_raw", "bwd", vol_raw, "kitti_raw", 20)
    del vol_raw
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
    points, in turns: baseline, this, this, baseline (the backward's rows
    point instance at the importance recipe's 4096 x 320 points). Each
    gets the volume in the layout its own decode produces (the baseline's
    kernels read channel-first, ``kernel_volume`` marks this one's)."""
    import torch
    n = train_pts.shape[0]
    gv25 = torch.randn((n, 25), generator=g, device=train_pts.device)
    gv1 = torch.randn((n, 1), generator=g, device=train_pts.device)
    gg = torch.randn((n, 3), generator=g, device=train_pts.device)
    head = head_points(train_pts.device, (HEAD_SAMPLES,))[HEAD_SAMPLES]
    gv_h = torch.randn((head.shape[0], 25), generator=g,
                       device=train_pts.device)
    gg_h = torch.randn((head.shape[0], 3), generator=g,
                       device=train_pts.device)

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
                                                      gg),
            "bwd_points_c25_head": lambda: mod.trilinear_bwd(
                v25, head, gv_h, gg_h, points=True)}

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


def values_ab(base, this, g, device):
    """Median ms (events, device) of the two checkouts' values-only kernels
    at their main-path shapes, in turns: baseline, this, this, baseline.
    Each gets the same inputs: the dense occupancy query (C = 25), the
    kitti_occ uniform grid (C = 4) and the compact taps' one query on the
    plane, forward and backward; the backward also at C = 25 on the
    density step's 7,372,800 ray samples, the first training chunk's
    1,048,576 (the options step's query) and the BEV step's 640,000
    jittered uniform sdf points (there also with the step's cotangent, the
    sdf channel alone live)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    dense = dense_grid_points(get_config("nuscenes_occ"), device)
    c25 = {"density": density_step_points(
               get_config("nuscenes_occ_density"), device,
               torch.Generator(device=device).manual_seed(SEED)),
           "options": step_points(device)[0],
           "bev": uniform_sdf_points(
               get_config("nuscenes_occ_bev"), device,
               torch.Generator(device=device).manual_seed(SEED))}
    gv25 = {k: torch.randn((p.shape[0], 25), generator=g, device=device)
            for k, p in c25.items()}
    # the BEV step's own cotangent: the sdf channel alone is live
    sdf_only = torch.cat([gv25["bev"][:, :1],
                          torch.zeros_like(gv25["bev"][:, 1:])], 1)
    vol25 = torch.randn((257, 257, 25, 25), generator=g,
                        device=device).permute(3, 0, 1, 2)
    shape, uniform, taps = kitti_points(device)[:3]
    vol4 = torch.randn(tuple(shape) + (4,), generator=g,
                       device=device).permute(3, 0, 1, 2)
    plane = torch.randn((1,) + tuple(shape), generator=g, device=device)
    gv4 = torch.randn((uniform.shape[0], 4), generator=g, device=device)
    gv1 = torch.randn((taps.shape[0], 1), generator=g, device=device)

    def calls(mod):
        return {
            "fwd_dense_c25": lambda: mod.trilinear_cf_fwd(vol25, dense),
            "fwd_uniform_c4": lambda: mod.trilinear_cf_fwd(vol4, uniform),
            "fwd_taps_c1": lambda: mod.trilinear_cf_fwd(plane, taps),
            "bwd_uniform_c4": lambda: mod.trilinear_cf_bwd(
                vol4.shape, uniform, gv4),
            "bwd_taps_c1": lambda: mod.trilinear_cf_bwd(plane.shape, taps,
                                                        gv1),
            **{f"bwd_{k}_c25": (lambda k=k: mod.trilinear_cf_bwd(
                vol25.shape, c25[k], gv25[k])) for k in c25},
            "bwd_bev_c25_sdf_only": lambda: mod.trilinear_cf_bwd(
                vol25.shape, c25["bev"], sdf_only)}

    runs = {"baseline": [], "this": []}
    for side in ("baseline", "this", "this", "baseline"):
        fns = calls(base if side == "baseline" else this)
        runs[side].append({k: (timed(f, 10), device_ms(f, 10))
                           for k, f in fns.items()})
        torch.cuda.empty_cache()
    out = {side: {k: sorted(r[k] for r in rs) for k in rs[0]}
           for side, rs in runs.items()}
    for k in out["this"]:
        log(f"  A/B {k} (event ms, device ms): baseline {out['baseline'][k]}"
            f", this {out['this'][k]}")
    del vol25, vol4, plane, dense, uniform, taps, gv4, gv1, c25, gv25, sdf_only
    torch.cuda.empty_cache()
    return out


def channel_close(got, ref):
    """The largest error of each channel of (N, C) values over 1e-5 of that
    channel's largest reference magnitude (<= 1 passes), and the largest
    absolute error."""
    d = (got.double() - ref.double()).abs().amax(0)
    scale = ref.double().abs().amax(0).clamp_min(1e-30)
    return float((d / (1e-5 * scale)).max()), float(d.max())


def grid_sample_of(vol_cf, pts, padding="zeros"):
    """``F.grid_sample`` computing trilinear values of a (C, H, W, D)
    volume at (N, 3) fractional (h, w, d) indices: a 5-D channel-first
    input (its own contiguous copy), align_corners=True, ``padding``; x
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
        return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding,
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


def clip_in_torch(pts, shape):
    """(..., 3) fractional indices clipped to a (H, W, D) volume, as
    ``"border"`` padding clips them before it reads their corners, in
    torch: a maximum and a minimum per axis, then a stack (the flow
    lookup's route before the narrow instances)."""
    import torch
    return torch.stack([
        torch.minimum(torch.maximum(pts[..., i], pts.new_zeros(())),
                      pts.new_full((), n - 1.0))
        for i, n in enumerate(shape)], -1)


def values_fwd_record(interp, vol, pts, shape, reps, padding="zeros"):
    """``trilinear_cf_fwd`` on one input with ``padding``: against its plain
    version (each channel within 1e-5 of its max) and ``F.grid_sample``
    with the same padding; timed by events and device time beside its
    plain version and ``F.grid_sample`` (the channel-first copy that it
    needs timed apart). Bound: the distinct corner rows its points touch
    (``"border"``: after the clip) read once, the points read once, the
    values written once; 20 + 16 C operations per point."""
    import torch
    n, C = pts.shape[0], vol.shape[0]
    got = interp.trilinear_cf_fwd(vol, pts, padding)
    ref = interp.trilinear_sample_cf_plain(vol, pts, padding)
    rel, err = channel_close(got, ref)
    check(f"trilinear_cf_fwd ({shape}) / channel tolerance", rel, 1.0)
    lib, copy = grid_sample_of(vol, pts, padding)
    lib_rel, lib_err = channel_close(lib(), ref)
    del got, ref
    torch.cuda.empty_cache()
    voxels = corner_voxels(clip_in_torch(pts, vol.shape[1:])
                           if padding == "border" else pts,
                           tuple(vol.shape[1:]))

    def kern():
        return interp.trilinear_cf_fwd(vol, pts, padding)
    rec = kernel_record(
        err, timed(kern, reps),
        timed(lambda: interp.trilinear_sample_cf_plain(vol, pts, padding),
              3),
        (voxels * C * 4 + nbytes(pts) + n * C * 4, n * (20 + 16 * C)),
        library_ms=timed(lib, reps), library="F.grid_sample",
        library_copy_ms=timed(copy, reps),
        library_device_ms=device_ms(lib, reps), library_max_abs_err=lib_err,
        library_channel_rel_err=lib_rel, device_ms=device_ms(kern, reps),
        batched_ms=batched_ms(kern, reps),
        library_batched_ms=batched_ms(lib, reps),
        shape=shape, points=n, C=C, corner_voxels=voxels,
        channel_rel_err=rel)
    log(f"  trilinear_cf_fwd {shape}: ms {rec['ms']:.4g}, device_ms "
        f"{rec['device_ms']}, plain_ms {rec['plain_ms']:.4g}, grid_sample "
        f"{rec['library_ms']:.4g} (device {rec['library_device_ms']}, + "
        f"copy {rec['library_copy_ms']:.4g}), bound_ms "
        f"{rec['bound_ms']:.4g} ({rec['bound_by']})")
    del lib, copy
    torch.cuda.empty_cache()
    return rec


def edge_points(g, device, small):
    """Off-path points on a small volume: rays through it and out of it,
    the compact stencil's six point-major taps of their samples 0.05 cells
    apart, uniform points with a margin outside and 1/8 of them on
    integer knots, a ray whose samples all lie in one cell (every lane of a
    warp shares every corner), points far outside and on the last knots,
    and the rays shuffled; no count a multiple of 128."""
    import torch
    sh = torch.tensor(small, dtype=torch.float32, device=device)
    o = torch.rand((40, 3), generator=g, device=device) * sh * 0.5 + sh / 4
    d = torch.randn((40, 3), generator=g, device=device)
    t = torch.sort(torch.rand((40, 97), generator=g, device=device), -1)[0]
    rays = (o[:, None] + d[:, None] / d.norm(dim=-1, keepdim=True)[
        :, None] * t[..., None] * 1.3 * float(sh.max())).reshape(-1, 3)
    eye = torch.eye(3, device=device) * 0.05
    taps = (rays[:, None, :] + torch.stack([eye, -eye], 1).reshape(6, 3)
            ).reshape(-1, 3)
    uni = torch.rand((5003, 3), generator=g, device=device) * (sh + 3) - 1.5
    uni[::8] = torch.round(uni[::8])
    cell = torch.tensor([4.3, 5.1, 2.3], device=device) + 0.5 * torch.rand(
        (4099, 3), generator=g, device=device)
    far = torch.tensor([[1e9, 2.0, 2.0], [-1e9, 3.0, 1.0],
                        [small[0] - 1.0, small[1] - 1.0, small[2] - 1.0],
                        [-1.0, -1.0, -1.0], [-0.5, 0.5, 0.5]],
                       device=device).repeat(41, 1)
    perm = torch.randperm(rays.shape[0], generator=g, device=device)
    return {"rays": rays, "taps": taps, "uniform + knots": uni,
            "one cell": cell, "far and last knots": far,
            "rays shuffled": rays[perm]}


def values_kernel_checks(g, device):
    """``trilinear_cf_fwd`` (the values-only forward) at its main-path
    shapes, each against its plain version and ``F.grid_sample``, timed
    (``values_fwd_record``): the dense occupancy query (the 512 x 512 x 40
    grid, 10,485,760 points, on a random (25, 257, 257, 25) channel-last
    volume), the kitti_occ uniform sdf grid (262,144 points, C = 4, 16-byte
    rows) and the compact second derivative's one query (6,291,456
    point-major taps on the (257, 257, 33) sdf plane). Then off-path
    inputs, checked only: C = 1, 2, 3, 4, 5, 8, 21, 25, 33, volumes that are
    channel slices of wider rows (row stride > C, 16-byte aligned or 4
    bytes off), the points of ``edge_points``; and the values agree bit
    for bit with the with-grad forward's (the same value arithmetic).
    ``"border"`` padding at C = 1, 2, 3 (the narrow instances) on the same
    points."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import interp
    cfg = get_config("nuscenes_occ")
    vol = torch.randn((257, 257, 25, 25), generator=g,
                      device=device).permute(3, 0, 1, 2)
    rec = values_fwd_record(interp, vol, dense_grid_points(cfg, device),
                            "dense query, C=25, 10485760 points", 10)
    del vol
    torch.cuda.empty_cache()
    kshape, uniform, taps = kitti_points(device)[:3]
    vol4 = torch.randn(tuple(kshape) + (4,), generator=g,
                       device=device).permute(3, 0, 1, 2)
    plane = torch.randn((1,) + tuple(kshape), generator=g, device=device)
    for tag, v, p in (("uniform", vol4, uniform), ("taps", plane, taps)):
        r = values_fwd_record(interp, v, p, f"kitti_occ {tag}, C="
                              f"{v.shape[0]}, {p.shape[0]} points", 20)
        for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                  "library_device_ms", "library_copy_ms", "max_abs_err",
                  "points"):
            rec[f"{tag}_{k}"] = r[k]
    rec["max_abs_err"] = max(rec[k] for k in ("max_abs_err",
                                              "uniform_max_abs_err",
                                              "taps_max_abs_err"))
    del vol4, plane, uniform, taps
    torch.cuda.empty_cache()

    small = (13, 17, 9)
    sets = edge_points(g, device, small)
    same = total = 0
    for C in (1, 2, 3, 4, 5, 8, 21, 25, 33):
        full = torch.randn(small + (C + 4,), generator=g, device=device)
        for tag, v in (("contiguous", full[..., :C].contiguous()),
                       ("row stride", full[..., 4:]),
                       ("row stride, 4 bytes off", full[..., 1:C + 1])):
            v = v.permute(3, 0, 1, 2)
            for ptag, p in sets.items():
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
    if same != total:
        raise AssertionError("trilinear_cf_fwd: values differ from the "
                             f"with-grad forward's in {total - same} cases")
    # "border" padding: the narrow instances, C <= 3
    for C in (1, 2, 3):
        full = torch.randn(small + (C + 4,), generator=g, device=device)
        for tag, v in (("contiguous", full[..., :C].contiguous()),
                       ("row stride", full[..., 4:])):
            v = v.permute(3, 0, 1, 2)
            for ptag, p in sets.items():
                check(f"trilinear_cf_fwd (border, C={C}, {tag}, {ptag}, "
                      f"N={p.shape[0]})",
                      max_err(interp.trilinear_cf_fwd(v, p, "border"),
                              interp.trilinear_sample_cf_plain(v, p,
                                                               "border")),
                      1e-5)
    torch.cuda.synchronize()
    return {"trilinear_cf_fwd": dict(rec, bit_equal_to_with_grad=[same,
                                                                  total])}


def kitti_points(device):
    """The values-only query's points on the kitti_occ training path, as
    fractional indices of its (4, 257, 257, 33) volume: the uniform sdf
    grid (128 x 128 x 16 points 0.4 m apart over the box, each jittered by
    up to one step, seeded) and the compact second derivative's six taps
    (+-0.01 m along x, y, z) of the first 4096-ray training chunk's
    1,048,576 samples (a synthetic batch, the cellular ray grid and the
    jitter from a seeded generator), 6,291,456 points in the one query's
    point-major order. Returns (grid shape, uniform, taps, the field, the
    samples' metric positions)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.geometry.projection import rays_from_img2lidar
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.models.heads import uniform_axes_on, uniform_grid
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("kitti_occ")
    h = cfg.model.head
    head = TPVSegmentor(cfg.model).head
    m = head.field.mapping
    gen = torch.Generator(device=device).manual_seed(SEED)
    xyz = uniform_grid(*uniform_axes_on(tuple(h.roi_aabb), h.resolution,
                                        device))
    xyz = xyz + torch.rand(xyz.shape, generator=gen,
                           device=device) * h.resolution
    uniform = m.meter2grid(xyz.reshape(-1, 3)).contiguous()
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    origin, direction = rays_from_img2lidar(batch[h.trans_kw],
                                            head.ray_sampler(device, gen))
    origin = origin[:, :, None, :].expand(direction.shape).reshape(-1, 3)
    direction = direction.reshape(-1, 3)
    n = h.train_ray_chunk
    unit = direction[:n] / torch.linalg.norm(direction[:n], dim=-1,
                                             keepdim=True)
    near, far = neus.ray_aabb_near_far(origin[:n], unit, head.roi_aabb,
                                       head.near_plane, head.far_plane)
    t_rand = torch.rand((n, head.num_samples + 1), generator=gen,
                        device=device)
    mids = neus.sample_uniform(near, far, head.num_samples, t_rand).mids
    pos = (origin[:n, None, :] + unit[:, None, :] * mids[..., None]
           ).reshape(-1, 3)
    # as field.second_grad lays them out: point-major, x+d, x-d along x,
    # then y, then z
    steps = torch.eye(3, device=device) * h.numerical_gradients_delta
    taps = m.meter2grid(pos[:, None, :] + torch.stack(
        [steps, -steps], 1).reshape(6, 3)).reshape(-1, 3).contiguous()
    return head.field.grid_shape, uniform, taps, head.field, pos


def grid_sample_bwd_of(shape, pts, grad_vals, padding="zeros"):
    """``F.grid_sample``'s backward computing the same volume cotangent as
    ``trilinear_cf_bwd`` (align_corners=True, ``padding``; see
    ``grid_sample_of``): ``call()`` runs the backward alone on a
    channel-first (1, C, H, W, D) input; ``with_copy()`` also makes that
    channel-first copy of the channel-last volume and copies the gradient
    back into the port's channel-last layout."""
    import torch
    C, H, W, D = shape
    vol_cl = torch.zeros((H, W, D, C), device=pts.device)
    x = vol_cl.permute(3, 0, 1, 2).contiguous()[None]
    grid = torch.stack([2 * pts[:, 2] / (D - 1) - 1,
                        2 * pts[:, 1] / (W - 1) - 1,
                        2 * pts[:, 0] / (H - 1) - 1], -1).view(1, 1, 1, -1, 3)
    gout = grad_vals.T.contiguous().view(1, C, 1, 1, -1)

    def call(inp=x):
        return torch.ops.aten.grid_sampler_3d_backward(
            gout, inp, grid, 0, {"zeros": 0, "border": 1}[padding], True,
            [True, False])[0]

    def with_copy():
        g = call(vol_cl.permute(3, 0, 1, 2).contiguous()[None])
        return g[0].permute(1, 2, 3, 0).contiguous()

    return call, with_copy


def values_bwd_record(interp, vol_shape, pts, gv, tag, reps,
                      padding="zeros"):
    """``trilinear_cf_bwd`` for the cotangent ``gv`` (N, C) at (N, 3)
    points of a ``vol_shape`` (C, H, W, D) volume with ``padding``: against
    its plain version (GRAD_RTOL), timed by events and device time beside
    its plain version and ``F.grid_sample``'s backward with the same
    padding (alone, and with the channel-first copy it needs and the
    gradient copied back). Bound: the cotangent and the points read once,
    the dense gradient written once; 20 + 16 C operations per point."""
    import torch
    C = vol_shape[0]
    shape = tuple(vol_shape[1:])
    vol = torch.zeros(vol_shape, device=pts.device)
    got = interp.trilinear_cf_bwd(vol_shape, pts, gv, padding=padding)
    ref = interp.trilinear_cf_bwd_plain(vol, pts, gv, padding=padding)
    err = max_err(got, ref)
    check(f"trilinear_cf_bwd ({tag}, C={C}, {pts.shape[0]} points)",
          err, GRAD_RTOL * float(ref.abs().max()) + 1e-7)
    del got, ref
    torch.cuda.empty_cache()
    lib, lib_copy = grid_sample_bwd_of(vol_shape, pts, gv, padding)
    # the locality the segments use: runs of one cell in a warp's 32
    # consecutive points, and the voxels touched
    seen = clip_in_torch(pts, shape) if padding == "border" else pts
    cells = torch.floor(seen[: pts.shape[0] // 32 * 32]).long()
    cells = cells.view(-1, 32, 3)
    runs = float(((cells[:, 1:] != cells[:, :-1]).any(-1).sum(1) + 1)
                 .float().mean())
    del cells
    lib_err = max_err(lib()[0].permute(1, 2, 3, 0),
                      interp.trilinear_cf_bwd(vol_shape, pts, gv,
                                              padding=padding)
                      .permute(1, 2, 3, 0))
    n = pts.shape[0]
    out_bytes = shape[0] * shape[1] * shape[2] * C * 4

    def kern():
        return interp.trilinear_cf_bwd(vol_shape, pts, gv, padding=padding)
    rec = kernel_record(
        err, timed(kern, reps),
        timed(lambda: interp.trilinear_cf_bwd_plain(vol, pts, gv,
                                                    padding=padding), 3),
        (nbytes(pts, gv) + out_bytes, n * (20 + 16 * C)),
        library_ms=timed(lib, 10), library="F.grid_sample backward",
        library_device_ms=device_ms(lib, 10),
        library_with_copy_ms=timed(lib_copy, 10),
        library_with_copy_device_ms=device_ms(lib_copy, 10),
        library_max_abs_err=lib_err, device_ms=device_ms(kern, reps),
        batched_ms=batched_ms(kern, reps),
        library_batched_ms=batched_ms(lib, 10),
        shape=f"{tag}, C={C}, {n} points", points=n, C=C,
        cell_runs_per_warp=runs, corner_voxels=corner_voxels(seen, shape))
    log(f"  trilinear_cf_bwd {tag}: {rec}")
    del vol, lib, lib_copy
    torch.cuda.empty_cache()
    return rec


def values_bwd_checks(g, device):
    """``trilinear_cf_bwd`` (the values-only backward) at its kitti_occ
    training points (``kitti_points``): the compact second derivative's
    one query, 6,291,456 point-major taps on the sdf plane (C = 1, the
    plane kernel; 3 calls a step), and the uniform grid's 262,144 jittered
    points on the 4-channel volume (C = 4, float4 atomics; once a step).
    Against its plain version (autograd through
    ``trilinear_sample_cf_plain``; GRAD_RTOL); timed by events and device
    time, with ``F.grid_sample``'s backward on the same values (the
    backward alone, and with the channel-first copy it needs and the
    gradient copied back). Bound: the cotangent and the points read once,
    the dense gradient written once; 20 + 16 C operations per point. Also
    at C = 25 the first training chunk's 1,048,576 ray samples
    (``step_points``: the numerical-gradient options step queries the
    decoded volume there, the walk instance), with the channel-0-only
    cotangent too. Then off-path inputs, checked only: C = 1, 2, 3, 4, 5,
    8, 25 at the points of ``edge_points``, and at C = 4 and 25 a
    cotangent 4 bytes off 16-byte alignment (the walk); the narrow
    instances (C <= 3, either padding, with the points' cotangent too) on
    a row-strided volume."""
    import torch
    from selfocc_tpu_torch.ops import interp
    shape, uniform, taps = kitti_points(device)[:3]
    recs = {}
    for tag, C, pts in (("taps", 1, taps), ("uniform", 4, uniform)):
        gv = torch.randn((pts.shape[0], C), generator=g, device=device)
        recs[tag] = values_bwd_record(interp, (C,) + tuple(shape), pts, gv,
                                      tag, 20)
        del gv
        torch.cuda.empty_cache()
    rec = dict(recs["taps"])
    for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
              "library_device_ms", "library_with_copy_ms",
              "library_with_copy_device_ms", "max_abs_err", "points",
              "cell_runs_per_warp", "corner_voxels"):
        rec[f"uniform_{k}"] = recs["uniform"][k]
    del uniform, taps
    torch.cuda.empty_cache()
    rec["options_chunk"] = values_bwd_c25_record(
        g, device, (257, 257, 25), step_points(device)[0],
        "options chunk", 20)

    small = (13, 17, 9)
    sets = edge_points(g, device, small)
    for C in (1, 2, 3, 4, 5, 8, 25):
        vol = torch.zeros((C,) + small, device=device)
        for ptag, p in sets.items():
            gv = torch.randn((p.shape[0], C), generator=g, device=device)
            ref = interp.trilinear_cf_bwd_plain(vol, p, gv)
            check(f"trilinear_cf_bwd (C={C}, {ptag}, N={p.shape[0]})",
                  max_err(interp.trilinear_cf_bwd(vol.shape, p, gv), ref),
                  GRAD_RTOL * float(ref.abs().max()) + 1e-7)
    # the narrow instances (C <= 3) with either padding, point-free and
    # with the points' cotangent, on a volume read at row stride C + 4
    for C in (1, 2, 3):
        full = torch.randn(small + (C + 4,), generator=g, device=device)
        vol = full[..., 4:].permute(3, 0, 1, 2)
        for padding in ("zeros", "border"):
            for ptag, p in sets.items():
                gv = torch.randn((p.shape[0], C), generator=g, device=device)
                what = f"{padding}, C={C}, {ptag}, N={p.shape[0]}"
                ref = interp.trilinear_cf_bwd_plain(vol, p, gv,
                                                    padding=padding)
                check(f"trilinear_cf_bwd ({what})",
                      max_err(interp.trilinear_cf_bwd(
                          tuple(vol.shape), p, gv, padding=padding), ref),
                      GRAD_RTOL * float(ref.abs().max()) + 1e-7)
                check_grads(f"trilinear_cf_bwd points ({what})",
                            interp.trilinear_cf_bwd(tuple(vol.shape), p, gv,
                                                    vol, padding),
                            interp.trilinear_cf_bwd_plain(
                                vol, p, gv, points=True, padding=padding))
    p = sets["rays"]
    for C in (4, 25):
        buf = torch.randn(p.shape[0] * C + 1, generator=g, device=device)
        gv = buf[1:].view(-1, C)
        ref = interp.trilinear_cf_bwd_plain(torch.zeros((C,) + small,
                                                        device=device), p, gv)
        check(f"trilinear_cf_bwd (C={C}, rays, grad_vals 4 bytes off)",
              max_err(interp.trilinear_cf_bwd((C,) + small, p, gv), ref),
              GRAD_RTOL * float(ref.abs().max()) + 1e-7)
    return {"trilinear_cf_bwd": rec}


def second_grad_checks(g, device):
    """The compact second derivative (``TPVSDFField.second_grad``) of the
    kitti_occ field on a random (4, 257, 257, 33) channel-last volume at the
    first training chunk's 1,048,576 samples, its centre given as the head
    gives it: one values-only query of the six taps, one forward and one
    backward launch on the plane; against the composition of one query per
    tap it replaces, run through the same kernels: the forward bit for bit,
    the volume's cotangent within GRAD_RTOL (the six taps' sums are taken
    in another order). Both timed, forward and backward (CUDA events)."""
    import torch
    from selfocc_tpu_torch.ops import interp
    shape, _, _, field, pos = kitti_points(device)
    delta = 0.01
    leaf = torch.randn(tuple(shape) + (4,), generator=g,
                       device=device).requires_grad_()
    vol = leaf.permute(3, 0, 1, 2)
    cot = torch.randn((pos.shape[0], 3), generator=g, device=device)
    with torch.no_grad():
        center = field.sdf(interp.first_channel(vol), pos)

    def per_tap():
        sdf_vol = interp.first_channel(vol)
        comps = []
        for axis in range(3):
            e = torch.eye(3, device=device)[axis] * delta
            comps.append((field.sdf(sdf_vol, pos + e)
                          + field.sdf(sdf_vol, pos - e) - 2 * center)
                         / (delta * delta))
        return torch.stack(comps, dim=-1)

    def merged():
        return field.second_grad(vol, pos, delta, center=center)

    counts = (interp.trilinear_cf_fwd, interp.trilinear_cf_bwd)
    reset_counts(counts)
    got = merged()
    (g_got,) = torch.autograd.grad((got * cot).sum(), leaf)
    torch.cuda.synchronize()
    launches = {f"{fn.__name__}.plane": fn.plane_launches for fn in counts}
    if launches != {"trilinear_cf_fwd.plane": 1,
                    "trilinear_cf_bwd.plane": 1}:
        raise AssertionError(f"second_grad: {launches} launches on the "
                             "plane, one forward and one backward wanted")
    ref = per_tap()
    (g_ref,) = torch.autograd.grad((ref * cot).sum(), leaf)
    bit_equal = bool(torch.equal(got, ref))
    log(f"  second_grad (one query) against the per-tap composition: "
        f"forward bit-equal {bit_equal} (max |d| {max_err(got, ref):.3e})")
    if not bit_equal:
        raise AssertionError("second_grad: the one query's forward differs "
                             "from the per-tap composition's")
    err = max_err(g_got, g_ref)
    check("second_grad volume cotangent, one query against per tap", err,
          GRAD_RTOL * float(g_ref.abs().max()) + 1e-7)

    def fwd_bwd(fn):
        def run():
            out = fn()
            torch.autograd.grad((out * cot).sum(), leaf)
        return run
    res = {"forward_bit_equal": bit_equal, "cotangent_max_abs_err": err,
           "launches": launches,
           "merged_fwd_ms": timed(merged, 10),
           "per_tap_fwd_ms": timed(per_tap, 10),
           "merged_fwd_bwd_ms": timed(fwd_bwd(merged), 10),
           "per_tap_fwd_bwd_ms": timed(fwd_bwd(per_tap), 10)}
    log(f"  second_grad: {res}")
    del leaf, vol, got, ref, g_got, g_ref
    torch.cuda.empty_cache()
    return res


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
    alpha-input entry neus_weights_fwd, which the density head's render
    launches (``[density]``), against its plain version at an eval
    chunk."""
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
    """weights_from_alpha's own entry: one call on an eval chunk's alpha,
    its launches counted, held against the plain version (its main path,
    the density head, runs in ``[density]``)."""
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


def msda_records(g, device, tag, args):
    """``msda_fwd`` and ``msda_bwd`` on random inputs of the call ``args``
    (``msda_case``'s B, Q, shapes, P) against their plain versions, timed
    (events and device time): the two kernel records."""
    import torch
    from selfocc_tpu_torch.ops import msda
    case = msda_case(g, device, *args)
    value, shapes, loc, att = case
    pts_n, D = msda_points(case)
    o_k = msda.msda_fwd(*case)
    err = max_err(o_k, msda.ms_deform_attn_plain(*case))
    check(f"msda_fwd ({tag})", err, 1e-5)
    fwd = kernel_record(
        err, timed(lambda: msda.msda_fwd(*case), 5),
        timed(lambda: msda.ms_deform_attn_plain(*case), 3),
        (nbytes(value, loc, att, o_k),
         pts_n * (MSDA_FWD_OPS[0] + D * MSDA_FWD_OPS[1])),
        device_ms=device_ms(lambda: msda.msda_fwd(*case), 5))
    grad_out = torch.randn(o_k.shape, generator=g, device=device)
    del o_k
    torch.cuda.empty_cache()
    got = msda.msda_bwd(*case, grad_out)
    ref = msda.msda_bwd_plain(*case, grad_out)
    err = check_grads(f"msda_bwd ({tag})", got, ref)
    del got, ref
    torch.cuda.empty_cache()
    bwd = kernel_record(
        err, timed(lambda: msda.msda_bwd(*case, grad_out), 5),
        timed(lambda: msda.msda_bwd_plain(*case, grad_out), 2),
        (2 * nbytes(value, loc, att) + nbytes(grad_out),
         pts_n * (MSDA_BWD_OPS[0] + MSDA_BWD_OPS[1]
                  + D * MSDA_BWD_OPS[2])),
        device_ms=device_ms(lambda: msda.msda_bwd(*case, grad_out), 5))
    del case, value, loc, att, grad_out
    torch.cuda.empty_cache()
    return fwd, bwd


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

    res.update(values_bwd_checks(g, device))
    res["trilinear_cf_bwd"]["second_grad"] = second_grad_checks(g, device)
    if baseline is not None:
        import importlib
        from selfocc_tpu_torch.ops import interp
        res["trilinear_cf_fwd"]["values_ab"] = values_ab(
            importlib.import_module(f"{load_baseline(baseline)}.ops.interp"),
            interp, g, device)

    # MSDA at its three main-path call shapes: the hw-plane image
    # cross-attention (6 cams, 4 FPN levels of a 384x800 input, 66049
    # queries, 8 points), the zh- and wz-plane ones (6425 queries, 48
    # points) and the TPV self-attention (78899 queries over the 3 planes,
    # 12 points); forward and backward
    fwd, bwd = {}, {}
    for tag, args in (
            ("cross", (6, 66049, FPN_SHAPES, 8)),
            ("zh", (6, 6425, FPN_SHAPES, 48)),
            ("self", (1, 78899, ((257, 257), (25, 257), (257, 25)), 12))):
        fwd[tag], bwd[tag] = msda_records(g, device, tag, args)
    for name, rec in (("msda_fwd", fwd), ("msda_bwd", bwd)):
        res[name] = dict(rec["cross"], shape="cross hw plane")
        for tag, key in (("zh", "zh"), ("self", "self_attn")):
            for k in ("ms", "device_ms", "plain_ms", "bound_ms"):
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


INSTANCE_COUNTS = ("plane", "points", "tiled", "walk", "points_walk",
                   "narrow")


def reset_counts(wrappers):
    for fn in wrappers:
        fn.launches = 0
        for kind in INSTANCE_COUNTS:
            if hasattr(fn, f"{kind}_launches"):
                setattr(fn, f"{kind}_launches", 0)


def instance_counts(fn):
    """A wrapper's launches by kernel instance: the trilinear wrappers'
    ``plane`` (C = 1) and ``rows`` (the rest) and, for the backwards,
    ``points`` (the point-cotangent instances); the values-only pair's
    ``narrow`` (C <= 3 but for the plane, every ``"border"`` query: the
    flow head's lookup), which ``rows`` leaves out; ``trilinear_cf_bwd``'s
    ``walk`` (C > 3 but for the float4 rows) and ``trilinear_bwd``'s
    ``points_walk`` (its point instance at C > 1); ``neus_weights_bwd``'s
    ``tiled`` (more than 256 samples a ray)."""
    kinds = {}
    if hasattr(fn, "plane_launches"):
        kinds.update(plane=fn.plane_launches,
                     rows=fn.launches - fn.plane_launches
                     - getattr(fn, "narrow_launches", 0))
    for kind in INSTANCE_COUNTS[1:]:
        if hasattr(fn, f"{kind}_launches"):
            kinds[kind] = getattr(fn, f"{kind}_launches")
    return kinds


def read_counts(wrappers, path, instances=("plane",), required=()):
    """Each wrapper's launches in the path; the trilinear wrappers' also by
    kernel instance (``plane``: C = 1, ``rows``: C > 1), and each
    ``name.instance`` of ``required`` (``instance_counts``). Fails if a
    wrapper, one of ``instances`` of the trilinear kernels or one of
    ``required`` was not launched."""
    counts = {fn.__name__: fn.launches for fn in wrappers}
    for fn in wrappers:
        kinds = instance_counts(fn)
        if hasattr(fn, "plane_launches"):
            counts.update({f"{fn.__name__}.{k}": kinds[k] for k in instances})
        counts.update({key: kinds[key.split(".")[1]] for key in required
                       if key.split(".")[0] == fn.__name__})
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
    from selfocc_tpu_torch.ops import interp, msda, render_weights
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
    origin, direction, dn, near, far = depth_in_band(
        cfg, batch, res["last_depth"], device)
    if origin.shape[0] != 2_160_000:
        raise AssertionError(f"{origin.shape[0]} rays, expected 2160000")
    depth = res["last_depth"]
    log(f"  depth finite, in [0, far]; range {float(depth.min()):.3f} .. "
        f"{float(depth.max()):.3f} m")

    res["subset_err"] = frame_subset(model, batch, origin, direction, dn,
                                     near, far, device)
    res["launches"] = launches
    del model
    torch.cuda.empty_cache()
    return res


SUBSET_TOLS = {"depth": 1e-3, "acc": 1e-4, "rgb": 1e-4}


def frame_subset(model, batch, origin, direction, dn, near, far, device,
                 opacity_normalized=False, outputs=("depth", "acc")):
    """A 4096-ray subset of a frame's rays: the kernels on the card against
    the plain versions on the CPU (``outputs``: depth within 1e-3 m, acc
    and rgb within 1e-4) on one prepared volume, and each depth in its
    band: [acc near, acc far] per |d| for the NeuS head, [near, far] per
    |d| where acc > 0 for the density head's opacity-normalised depth.
    Returns the errors."""
    import torch
    from selfocc_tpu_torch.utils.eval_lib import ChunkedRenderer
    idx = torch.linspace(0, origin.shape[0] - 1, SUBSET_RAYS,
                         device=device).long()
    o_s, d_s = origin[idx], direction[idx]
    volume = ChunkedRenderer(model).prepare(batch["imgs"], batch["lidar2img"],
                                            **cameras_of(model, batch))
    gpu = ChunkedRenderer(model, chunk=SUBSET_RAYS,
                          outputs=outputs).render(volume, o_s, d_s)
    cpu_model = copy.deepcopy(model).cpu()
    cpu = ChunkedRenderer(cpu_model, chunk=SUBSET_RAYS, outputs=outputs) \
        .render(volume.cpu(), o_s.cpu(), d_s.cpu())
    sub_err = {k: float(abs(gpu[k].astype("float64") - cpu[k]).max())
               for k in outputs}
    log(f"  4096-ray subset, kernels vs plain (CPU): {sub_err}")
    if not all(sub_err[k] <= SUBSET_TOLS[k] for k in outputs):
        raise AssertionError(f"subset render disagrees: {sub_err}")
    acc = torch.from_numpy(gpu["acc"]).to(device)
    d_sub = torch.from_numpy(gpu["depth"]).to(device)
    if opacity_normalized:
        hit = acc > 0
        lo, hi = near[idx] / dn[idx], far[idx] / dn[idx]
        if bool(((d_sub < lo - 1e-3) & hit).any()) or \
                bool(((d_sub > hi + 1e-3) & hit).any()):
            raise AssertionError("subset depth outside [near, far]")
    else:
        lo, hi = (acc * near[idx] / dn[idx]), (acc * far[idx] / dn[idx])
        if bool((d_sub < lo - 1e-3).any()) or \
                bool((d_sub > hi + 1e-3).any()):
            raise AssertionError("subset depth outside [acc*near, acc*far]")
    del cpu_model, volume
    torch.cuda.empty_cache()
    return sub_err


def cameras_of(model, batch):
    """The ``intrinsic`` / ``cam2ego`` of ``batch`` where ``model``'s
    encoder is camera-aware (``utils/eval_lib.camera_kwargs``), else {}."""
    if not model.cfg.encoder.camera_aware:
        return {}
    return {k: batch[k] for k in ("intrinsic", "cam2ego")}


def depth_in_band(cfg, batch, depth, device, novel_view=None):
    """Fails unless the eval frame's depths are finite and 0 <= depth <=
    far in z-depth units per ray; returns the frame's rays (origin,
    direction; from the pose offset by ``novel_view``, ``vis_pics
    --novel-view``, where given), their direction norms and near / far."""
    import torch
    from selfocc_tpu_torch.geometry.projection import apply_novel_view
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.utils.eval_lib import (eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    rays = eval_ray_grid(cfg, device=device)
    mats = eval_trans_mats(batch, cfg)
    if novel_view is not None:
        mats = apply_novel_view(mats, novel_view)
    origin, direction = rays_for_cams(mats, rays)
    dn = torch.linalg.norm(direction, dim=-1)
    near, far = neus.ray_aabb_near_far(origin, direction / dn[:, None],
                                       cfg.model.head.roi_aabb)
    depth = depth.reshape(-1).to(device)
    if not bool(torch.isfinite(depth).all()):
        raise AssertionError("non-finite depth")
    if bool((depth < 0).any()) or bool((depth > far / dn * (1 + 1e-5)).any()):
        raise AssertionError("depth outside [0, far]")
    return origin, direction, dn, near, far


def check_finite_metrics(m, what="train metrics"):
    """Fails if a loss, ``total`` or ``grad_norm`` of a step is not
    finite."""
    import torch
    bad = [k for k, v in m.items()
           if k != "times" and not torch.isfinite(torch.as_tensor(v))]
    if bad:
        raise AssertionError(f"non-finite {what}: {bad}")


def frame_device_path(cfg, model, batch):
    """The frame's device work (prepare, rays, the chunked render) on a
    batch already on the card: once under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising call
    raises; the host copy of the depths, which ``render`` makes, is left
    out)."""
    import torch
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  camera_kwargs,
                                                  eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    renderer = ChunkedRenderer(model, chunk=CHUNK, outputs=("depth",))
    rays = eval_ray_grid(cfg, device=batch["imgs"].device)

    def frame():
        volume = renderer.prepare(batch["imgs"], batch["lidar2img"],
                                  **camera_kwargs(cfg, batch))
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
                if "values_fwd_" in e.key) / 1e3,
            "trilinear_cf_fwd_calls": sum(
                e.count for e in kernels if "values_fwd_" in e.key)}


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
        voxels = corner_voxels(p, tuple(vol.shape[1:]))
        b_ms, by = bound(voxels * C * 4 + nbytes(p) + n * C * 4,
                         n * (20 + 16 * C))
        # a row of C floats inside a wider one is read as whole 32-byte
        # sectors: the strided bound
        sectors = -(-C * 4 // 32)
        kern[tag] = {"max_abs_err": err, "channel_rel_err": rel,
                     "points": int(n), "C": int(C), "row": row,
                     "bound_ms": b_ms, "bound_by": by,
                     "strided_bound_ms": bound(
                         voxels * sectors * 32 + nbytes(p) + n * C * 4,
                         n * (20 + 16 * C))[0] if row and row > C else None,
                     "corner_voxels": voxels,
                     "ms": timed(lambda: interp.trilinear_cf_fwd(kv, p), 10),
                     "device_ms": device_ms(
                         lambda: interp.trilinear_cf_fwd(kv, p), 10),
                     # the same with L2 flushed before each call: whether
                     # the back-to-back calls' reads hit L2
                     "cold_device_ms": cold_device_ms(
                         lambda: interp.trilinear_cf_fwd(kv, p), 10,
                         "values_fwd"),
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


class plain_versions:
    """Within it, the model code calls the plain PyTorch versions of the
    port's kernels on any device: the trilinear queries, the taps, the
    fused NeuS render, the alpha-input weights and MSDA (a check's
    baseline on the card; no production path runs them there)."""

    def __enter__(self):
        from selfocc_tpu_torch.models import encoder, field, heads
        from selfocc_tpu_torch.ops import interp, msda
        from selfocc_tpu_torch.ops import render_weights as rw
        def plain_w(alpha):
            return rw._WeightsFromAlpha.apply(alpha, True)
        self.saved = [
            (field, "trilinear_sample_cf", interp.trilinear_sample_cf_plain),
            (field, "trilinear_sample_cf_with_grad",
             interp.trilinear_sample_cf_with_grad_plain),
            (field, "trilinear_sample_taps", interp.trilinear_sample_cf_plain),
            (heads, "neus_composite",
             lambda sdf, grad, u, e, dn, s, **kw: rw.neus_composite_plain(
                 sdf, grad, u, e, dn.reshape(-1), s)),
            (heads, "weights_from_alpha", plain_w),
            (rw, "weights_from_alpha", plain_w),
            (encoder, "ms_deform_attn",
             lambda v, s, loc, a, shared=False: msda.ms_deform_attn_plain(
                 v, s, loc, a))]
        self.saved = [(m, k, getattr(m, k), f) for m, k, f in self.saved]
        for m, k, _, f in self.saved:
            setattr(m, k, f)
        return self

    def __exit__(self, *exc):
        for m, k, orig, _ in self.saved:
            setattr(m, k, orig)


def train_parity(device, name="tiny", cfg=None, global_iter=None,
                 baseline=False):
    """One ``name`` step (a tiny-width config; or ``cfg``): kernels on the
    card vs plain versions on the CPU, same weights and draws, dropout 0,
    the model given ``global_iter``. ``baseline``: the step is also taken
    on the card with the plain versions (``plain_versions``) at the kernel
    run's chunking (``PARITY_RAY_CHUNK``), and a gradient whose
    card-against-CPU error exceeds GRAD_RTOL of its max passes if it is
    within twice that baseline's error: the kernels add no more than the
    card's own PyTorch ops (cuDNN, cuBLAS, CUDA reductions and scans)
    already move an ill-conditioned step. Logged beside it: the kernel run
    against that plain run (one device, one chunking: what the kernels
    alone add) and the plain run without chunks against the CPU."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.losses import MultiLoss
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    from selfocc_tpu_torch.utils.train_lib import aug_kwargs, build_loss_inputs

    cfg = get_config(name) if cfg is None else cfg
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
    if h.ray_sample_mode == "random":
        draws["random"] = torch.rand((R // cfg.num_cams, 2), generator=g)
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(SEED))
    results = []
    runs = [(device, PARITY_RAY_CHUNK, False), (torch.device("cpu"), 0, False)]
    if baseline:
        runs += [(device, PARITY_RAY_CHUNK, True), (device, 0, True)]
    for dev, chunk, plain in runs:
        m = copy.deepcopy(model).to(dev).train()
        m.head.train_ray_chunk = chunk
        batch = to_device(item, dev)
        with plain_versions() if plain else contextlib.nullcontext():
            out = m(batch["imgs"], batch["lidar2img"], batch[h.trans_kw],
                    train=True, draws=draws, global_iter=global_iter,
                    **aug_kwargs(batch, cfg.model.encoder.camera_aware))
            tot, ldict = MultiLoss(cfg.loss_cfgs)(
                build_loss_inputs(cfg, out, batch))
            tot.backward()
        results.append((
            {k: float(v.detach()) for k, v in ldict.items()},
            {n: p.grad.detach().cpu() for n, p in m.named_parameters()}))
    (l_k, g_k), (l_p, g_p) = results[:2]
    for k in l_p:
        err = abs(l_k[k] - l_p[k])
        check(f"tiny loss {k}", err, 1e-5 * abs(l_p[k]) + 1e-7)
    tols = {n: GRAD_RTOL * float(g_p[n].abs().max()) + 1e-7 for n in g_p}
    ratios = sorted(((max_err(g_k[n], g_p[n]) / tols[n], n) for n in g_p),
                    reverse=True)
    log("  worst gradients over their tolerance: " + ", ".join(
        f"{n} {r:.3f}" for r, n in ratios[:6]))
    res = {}
    if baseline:
        (g_b, g_d) = (results[2][1], results[3][1])
        base = {n: max_err(g_b[n], g_p[n]) / tols[n] for n in g_p}
        for key, what, r in (
                ("plain_on_card", "the card's plain versions in chunks of "
                 f"{PARITY_RAY_CHUNK} rays against the CPU", base),
                ("plain_on_card_unchunked", "the card's plain versions "
                 "without chunks against the CPU",
                 {n: max_err(g_d[n], g_p[n]) / tols[n] for n in g_p}),
                ("kernels_vs_plain_on_card", "the kernels against the card's "
                 "plain versions, both in chunks",
                 {n: max_err(g_k[n], g_b[n]) / tols[n] for n in g_p})):
            log(f"  {what}, worst: " + ", ".join(
                f"{n} {x:.3f}" for x, n in sorted(
                    ((x, n) for n, x in r.items()), reverse=True)[:6]))
            res[f"{key}_worst_grad_err_over_tol"] = max(r.values())
        res["losses_plain_on_card"] = results[2][0]
    for r, n in ratios:
        bound = max(1.0, 2.0 * base[n]) if baseline else 1.0
        if not r <= bound:
            raise AssertionError(f"tiny grad {n}: {r:.3f} of its tolerance "
                                 f"(bound {bound:.3f})")
    worst = ratios[0][0]
    log(f"  chunks of {PARITY_RAY_CHUNK} rays on the card vs dense on the "
        f"CPU: {len(g_p)} parameter gradients within tolerance (worst "
        f"{worst:.2f} of its tolerance); losses {l_k}")
    return dict(res, losses_cuda=l_k, losses_cpu=l_p,
                worst_grad_err_over_tol=worst)


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
    finite = check_finite_metrics

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


def profile_step(trainer, batch, gen, step_s,
                 render_kernels=("neus_render_fwd", "neus_render_bwd")):
    """torch.profiler over one warm step: device time by kernel (CUDA-side
    events only, so an op and the kernel it launched count once), the share
    of the backward kernels, kernel time over the unprofiled step time.
    ``render_kernels``: the kernels of ``csrc/neus_weights.cu`` the step
    must run (the density head's: ``neus_weights_fwd``, which is the
    alpha-input instance of ``neus_render_fwd_kernel``, and
    ``neus_weights_bwd``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        # a profile that recorded no device time (seen in runs of many
        # profiles) is taken again on the next step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.step(batch, gen, sync=torch.cuda.synchronize)
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = sorted(
            (e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: -e.self_device_time_total)
        total_us = sum(e.self_device_time_total for e in kernels)
        if total_us > 0:
            break
        log(f"  profiled step {attempt + 1}: no device time recorded")

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
           "msda_shared_fwd_share": share("msda_shared_fwd_kernel"),
           "msda_shared_bwd_share": share("msda_shared_bwd_kernel"),
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
        m = re.search(r"((?:trilinear|values)_\w+)_kernel(<true>)?", e.key)
        if m:
            # the point-cotangent instances are the <true> ones
            key = m.group(1) + ("_points" if m.group(2) else "") + "_kernel"
            t = tri.setdefault(key, {"calls": 0, "device_ms": 0.0})
            t["calls"] += e.count
            t["device_ms"] += e.self_device_time_total / 1e3
    for name, t in sorted(tri.items()):
        t["ms_per_call"] = t["device_ms"] / max(t["calls"], 1)
        log(f"    trilinear by instance: {name} x{t['calls']} "
            f"{t['device_ms']:.2f} ms ({t['ms_per_call']:.4f} ms per call)")
    res["trilinear_kernels"] = tri
    res["trilinear_ms"] = sum(t["device_ms"] for t in tri.values())
    log(f"    trilinear in the step: {res['trilinear_ms']:.2f} ms")
    # the kernels of csrc/neus_weights.cu: in-step ms per call and calls
    neus = {}
    for e in kernels:
        m = re.search(r"neus_(render|weights)_(fwd|bwd)(?:_staged)?"
                      r"(?:_tiles)?_kernel", e.key)
        if m:
            name = f"neus_{m.group(1)}_{m.group(2)}"
            if name == "neus_render_fwd" and (
                    "false>" in e.key or "neus_render_fwd"
                    not in render_kernels):
                name = "neus_weights_fwd"      # the alpha-input instance
            t = neus.setdefault(name, {"calls": 0, "device_ms": 0.0})
            t["calls"] += e.count
            t["device_ms"] += e.self_device_time_total / 1e3
    for name, t in sorted(neus.items()):
        t["ms_per_call"] = t["device_ms"] / max(t["calls"], 1)
        log(f"    {name} in the step: x{t['calls']} {t['device_ms']:.3f} ms "
            f"({t['ms_per_call']:.4f} ms per call)")
    if set(neus) != set(render_kernels):
        raise AssertionError(f"profiled step: neus kernels {neus}, "
                             f"expected {render_kernels}")
    res["neus_render_kernels"] = neus
    # the MSDA kernels (per-head and head-shared): in-step ms per call
    res["msda_kernels"] = {}
    for e in kernels:
        m = re.search(r"(msda_\w+)_kernel", e.key)
        if m:
            t = res["msda_kernels"].setdefault(
                m.group(1), {"calls": 0, "device_ms": 0.0})
            t["calls"] += e.count
            t["device_ms"] += e.self_device_time_total / 1e3
    for name, t in sorted(res["msda_kernels"].items()):
        t["ms_per_call"] = t["device_ms"] / max(t["calls"], 1)
        log(f"    {name} in the step: x{t['calls']} {t['device_ms']:.3f} ms "
            f"({t['ms_per_call']:.4f} ms per call)")
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


def fabricate_nuscenes(root, samples=FAB_SAMPLES):
    """A full-size nuScenes-format mini dataset under ``root``, in the
    layouts of the JAX tests' fixtures (``tests/test_nuscenes_dataset.py::
    _make_mini_nuscenes``, ``tests/test_novel_eval_datasets.py::
    make_nuscenes_eval_fixture``; copied here, since the card has no JAX
    tests): one scene of ``samples`` keyframes (8) 1.5 m apart, 6 cameras
    of 900 x 1600 JPEGs (the procedural ground scene, smooth), a lidar
    sweep of 34,000 points (x, y, z, intensity, ring) per keyframe on the
    ground and on walls around the ego, the train / val sweeps infos, the
    temporal_v2 infos, Occ3D ``labels.npz`` for keyframe 0 and offline
    teacher maps (768 x 1600, 21 classes) for every image. Returns the
    paths."""
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
        list(pool.map(write_view, [(i, c) for i in range(samples)
                                   for c in range(6)]))
    scene, temporal = [], []
    for i in range(samples):
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
            "nice_neighbor_next": [i + 1] if i < samples - 1 else [],
            "prev_dists": [FAB_STEP] if i > 0 else [],
            "next_dists": [FAB_STEP] if i < samples - 1 else []})
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
                     "metadata": [("scene0", i) for i in range(samples)]},
                    f)
    with open(paths["temporal"], "wb") as f:
        pickle.dump({"infos": temporal,
                     "scene_info": {"scene-0001": (0, samples - 1)}}, f)
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


class cv2_decode:
    """The port's training loaders on their cv2 path inside the block:
    ``selfocc_tpu_torch.native.get_shared_loader`` returns None there, as
    it does where the native decoder did not build (the decoder itself is
    untouched)."""

    def __enter__(self):
        from selfocc_tpu_torch import native
        self.native, self.saved = native, native.get_shared_loader
        native.get_shared_loader = lambda: None
        return self

    def __exit__(self, *exc):
        self.native.get_shared_loader = self.saved


def host_cores():
    import os
    return len(os.sched_getaffinity(0))


def decoder_check(tag, paths, crop_hw, rounds=3):
    """Which decoder the port's loaders run (one line, with the reason when
    it is cv2) and, where the native decoder built, its decode of ``paths``
    (one phase's fabricated images, cropped to ``crop_hw`` as the loaders
    crop) against the loaders' cv2 path: PNG exact, JPEG within 2 LSBs on
    each image's mean (``tests/test_native_loader.py``'s bound); and the
    host seconds of decoding the set both ways, in turns (native, cv2, cv2,
    native, ... over ``rounds`` pairs): the native pool's batch against the
    loaders' ``cv2.imread(...).astype(np.float32)`` loop; and once a round
    on a pool of one thread, the decoder's own cost an image."""
    import cv2
    import numpy as np
    from selfocc_tpu_torch import native
    st = native.native_status()
    log(f"  [{tag}] image decoder of the loaders: {st['decoder']}"
        + (f" (cv2 because: {st['reason']})" if st["reason"] else
           f" ({st['library']})") + f"; host cores {host_cores()}")
    res = {"decoder": st["decoder"], "reason": st["reason"],
           "host_cores": host_cores()}
    if not native.native_available():
        return res
    loader = native.get_shared_loader()
    h, w = crop_hw

    def nat():
        return loader.decode_batch(paths, crop_hw=crop_hw)

    def cv():
        return [cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32)[:h, :w]
                for p in paths]
    worst_mean = worst_max = 0.0
    for p, got, ref in zip(paths, nat(), cv()):
        d = np.abs(got - ref)
        worst_mean, worst_max = max(worst_mean, float(d.mean())), max(
            worst_max, float(d.max()))
        if p.endswith(".png") and d.max() != 0:
            raise AssertionError(f"native PNG decode of {p} differs from "
                                 f"cv2's by up to {d.max()}")
        if not d.mean() < 2.0:
            raise AssertionError(f"native decode of {p} differs from cv2's "
                                 f"by {d.mean():.3f} on the mean")
    one = native.NativeImageLoader(num_threads=1)
    secs = {"native": [], "cv2": [], "native_1_thread": []}
    for _ in range(rounds):
        for which, fn in (("native", nat), ("cv2", cv), ("cv2", cv),
                          ("native", nat), ("native_1_thread", lambda: (
                              one.decode_batch(paths, crop_hw=crop_hw)))):
            t0 = time.perf_counter()
            fn()
            secs[which].append(time.perf_counter() - t0)
    res.update(images=len(paths), crop_hw=list(crop_hw),
               mean_abs_lsb_max=worst_mean, max_abs_lsb=worst_max,
               decode_s=secs)
    med = {k: sorted(v)[len(v) // 2] for k, v in secs.items()}
    log(f"  [{tag}] native decode against cv2 on {len(paths)} "
        f"{paths[0].rsplit('.', 1)[-1].upper()}s of {h}x{w}: mean |d| <= "
        f"{worst_mean:.4f}, max |d| {worst_max:g}; the set in "
        f"{med['native']:.4f} s native, {med['cv2']:.4f} s cv2 (medians of "
        f"{len(secs['cv2'])}; {min(secs['native']):.4f}-"
        f"{max(secs['native']):.4f} / {min(secs['cv2']):.4f}-"
        f"{max(secs['cv2']):.4f}); a pool of one thread "
        f"{med['native_1_thread']:.4f} s")
    return res


def loader_rates(cfg):
    """Host seconds per train item of ``build_dataset(cfg, "train")`` (as
    ``train.py`` builds it: seeded, labels dropped), the items per second
    of ``BatchPrefetcher`` at depth 2 over the epoch and a cProfile of two
    items, with the decoder the loaders run; where that is the native
    decoder, the same on the loaders' cv2 path too (``cv2_decode``), under
    ``"cv2"``: each item built both ways in turn (the order swapped from
    one item to the next), then each decoder's prefetch pass and
    profile."""
    from selfocc_tpu_torch import native, train
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.data.prefetch import BatchPrefetcher
    ds = build_dataset(cfg, "train")
    decoders = [native.native_status()["decoder"]]
    if native.native_available():
        decoders.append("cv2")

    def path(decoder):
        return cv2_decode() if decoder == "cv2" and len(decoders) > 1 \
            else contextlib.nullcontext()
    secs = {d: [] for d in decoders}
    for pos in range(len(ds)):
        for d in decoders if pos % 2 == 0 else decoders[::-1]:
            with path(d):
                t0 = time.perf_counter()
                item = train.host_batch(ds, pos, SEED, 0, pos)
                secs[d].append(time.perf_counter() - t0)
    shapes = {k: tuple(v.shape) for k, v in item.items()}
    out = {}
    for d in decoders:
        with path(d):
            t0 = time.perf_counter()
            n = sum(1 for _ in BatchPrefetcher(
                lambda pos: train.host_batch(ds, pos, SEED, 1, pos),
                range(len(ds)), depth=2))
            rate = n / (time.perf_counter() - t0)
            log(f"  loader profile, per item (cProfile, 2 items, {d} "
                "decoder):")
            top = loader_profile(ds)
        med = sorted(secs[d])[len(secs[d]) // 2]
        log(f"  loader ({d} decoder, {host_cores()} host cores): "
            f"{len(ds)} train items, {med:.3f} s per item (median; "
            f"{min(secs[d]):.3f}-{max(secs[d]):.3f}), prefetch depth 2: "
            f"{rate:.2f} items/s; imgs {shapes['imgs']}, curr_imgs "
            f"{shapes['curr_imgs']}, sem_gt {shapes['sem_gt']}")
        out[d] = {"decoder": d, "items": len(ds), "item_s": secs[d],
                  "item_s_median": med, "prefetch_items_per_s": rate,
                  "shapes": shapes, "profile": top}
    res = out[decoders[0]]
    if len(decoders) > 1:
        res["cv2"] = out["cv2"]
    return res


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
    res["max_depth_subset"] = max_depth_subset(model, volume, origin,
                                               direction)
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
    del model, volume, out
    torch.cuda.empty_cache()
    return res


def max_depth_subset(model, volume, origin, direction):
    """``max_depth`` on the card against the plain path on the CPU, at 4096
    rays spread over ``origin`` / ``direction``: each path's max_depth is
    its ts at the argmax of its w / deltas; the two take the same sample
    except where the CPU's two largest w / deltas lie within 1e-6
    (relative) of each other, and where they take the same sample its ts
    agree within 1e-6 of the largest ts (the kernel's ts tolerance,
    render_fwd_error). Returns the counts; raises outside the tie band."""
    import numpy as np
    import torch
    from selfocc_tpu_torch.utils.eval_lib import ChunkedRenderer
    idx = torch.linspace(0, origin.shape[0] - 1, SUBSET_RAYS,
                         device=origin.device).long()
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
    res = {"rays": SUBSET_RAYS, "other_sample": int(flips.sum()),
           "other_sample_outside_ties": int((flips & ~tie).sum()),
           "near_ties": int(tie.sum()), "bit_equal": int(
               (gpu["max_depth"] == cpu["max_depth"]).sum()),
           "same_sample_max_abs_err": ts_err, "ts_tolerance": ts_tol,
           "weights_max_abs_err": float(np.abs(
               gpu["weights"].astype(np.float64) - cpu["weights"]).max())}
    if (flips & ~tie).any() or not ts_err <= ts_tol:
        raise AssertionError(f"max_depth against the CPU: {res}")
    return res


def data_phase(device, train_res=None):
    """The nuScenes data path on a fabricated full-size dataset (a
    temporary directory, removed after): loader rates, training from the
    loader with a mid-epoch resume, the val frames and the novel-view
    frame. ``train_res``: the [train] phase's result (the synthetic step and
    its kernel time) when it ran in this call."""
    import glob
    import os
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
        res = {"decoder": decoder_check(
            "data", sorted(glob.glob(os.path.join(root, "samples",
                                                  "*.jpg")))[:24], FAB_IMG)}
        res["loader"] = loader_rates(occ_cfg)
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


KITTI_IMG = (370, 1226)            # SemanticKITTI image_2 PNGs
KITTI_TRAIN_FRAMES = 12            # sequence 00
KITTI_VAL_FRAMES = 11              # sequence 08: voxels at 0, 5, 10
KITTI_STEP = 1.03                  # metres of forward motion per frame
KITTI_LIDAR_POINTS = 120_000       # points per scan, 4 float32 each
# the public calibration of SemanticKITTI odometry sequence 00
KITTI_CALIB = (
    "P0: 7.188560e+02 0 6.071928e+02 0 0 7.188560e+02 1.852157e+02 0 0 0 1 0",
    "P1: 7.188560e+02 0 6.071928e+02 -3.861448e+02 0 7.188560e+02 "
    "1.852157e+02 0 0 0 1 0",
    "P2: 7.188560e+02 0 6.071928e+02 4.538225e+01 0 7.188560e+02 "
    "1.852157e+02 -1.130887e-01 0 0 1 3.779761e-03",
    "P3: 7.188560e+02 0 6.071928e+02 -3.372877e+02 0 7.188560e+02 "
    "1.852157e+02 2.369057e+00 0 0 1 4.915215e-03",
    "Tr: 4.276802385584e-04 -9.999672484946e-01 -8.084491683471e-03 "
    "-1.198459927713e-02 -7.210626507497e-03 8.081198471645e-03 "
    "-9.999413164504e-01 -5.403984729748e-02 9.999738645903e-01 "
    "4.859485810390e-04 -7.206933692422e-03 -2.921968648686e-01")


def fabricate_kitti(root):
    """A SemanticKITTI-odometry tree under ``root`` in the layout of the
    JAX tests' fixture (``tests/test_kitti_dataset.py::_make_mini_kitti``),
    at the real sizes: sequence 00 (train, 12 frames) and 08 (val, 11
    frames), frames 1.03 m apart along the camera's z, smooth 1226 x 370
    PNGs, velodyne scans of 120,000 points (x, y, z, reflectance) on the
    ground and on walls around the car, sequence 00's calibration, and for
    every 5th val frame the 256 x 256 x 32 completion labels (``.bin``
    occupancy bits, ``.label`` raw semantic-kitti ids, ``.invalid`` bits):
    a road layer with scattered cars and buildings."""
    import math
    import os
    from concurrent.futures import ThreadPoolExecutor
    import cv2
    import numpy as np
    rng = np.random.RandomState(SEED)
    y = np.linspace(0, 1, KITTI_IMG[0])[:, None]
    x = np.linspace(0, 1, KITTI_IMG[1])[None]

    def write_frame(job):
        seq, i = job
        d = os.path.join(root, "dataset", "sequences", seq)
        r = 120 + 80 * np.sin(6 * x + 0.3 * i) * y
        gg = 140 + 60 * np.cos(4 * y + 2 * x + 0.1 * i)
        b = 160 - 100 * y + 30 * np.sin(9 * x * y + 0.2 * i)
        img = np.stack(np.broadcast_arrays(b, gg, r), -1)
        cv2.imwrite(os.path.join(d, "image_2", f"{i:06d}.png"),
                    img.clip(0, 255).astype(np.uint8))
        lr = np.random.RandomState(1000 * int(seq) + i)
        n_g = KITTI_LIDAR_POINTS * 3 // 4
        n_w = KITTI_LIDAR_POINTS - n_g
        ang = lr.uniform(0, 2 * math.pi, KITTI_LIDAR_POINTS)
        rad = np.concatenate([lr.uniform(3, 70, n_g), lr.uniform(8, 40, n_w)])
        z = np.concatenate([np.full(n_g, -1.73), lr.uniform(-1.73, 3, n_w)])
        pts = np.stack([rad * np.cos(ang), rad * np.sin(ang), z,
                        lr.uniform(0, 1, KITTI_LIDAR_POINTS)], 1)
        pts.astype(np.float32).tofile(os.path.join(d, "velodyne",
                                                   f"{i:06d}.bin"))

    jobs = []
    for seq, n in (("00", KITTI_TRAIN_FRAMES), ("08", KITTI_VAL_FRAMES)):
        d = os.path.join(root, "dataset", "sequences", seq)
        for sub in ("image_2", "velodyne", "voxels"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        os.makedirs(os.path.join(root, "dataset", "poses"), exist_ok=True)
        with open(os.path.join(d, "calib.txt"), "w") as f:
            f.write("\n".join(KITTI_CALIB) + "\n")
        with open(os.path.join(root, "dataset", "poses", f"{seq}.txt"),
                  "w") as f:
            for i in range(n):
                T = np.eye(4)
                T[2, 3] = KITTI_STEP * i
                f.write(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1))
                        + "\n")
        jobs += [(seq, i) for i in range(n)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_frame, jobs))
    vox = os.path.join(root, "dataset", "sequences", "08", "voxels")
    for i in range(0, KITTI_VAL_FRAMES, 5):
        label = np.zeros((256, 256, 32), np.uint16)
        label[:, :, 7] = 40                                     # road
        cars = rng.rand(256, 256, 32) < 0.004
        label[cars & (np.arange(32) >= 8) & (np.arange(32) < 12)] = 10
        walls = rng.rand(256, 256) < 0.01
        label[walls[..., None] & (np.arange(32) >= 8)] = 50    # building
        occ = (label > 0).astype(np.uint8)
        np.packbits(occ.reshape(-1)).tofile(os.path.join(vox,
                                                         f"{i:06d}.bin"))
        label.reshape(-1).tofile(os.path.join(vox, f"{i:06d}.label"))
        invalid = (rng.rand(256 * 256 * 32) < 0.1).astype(np.uint8)
        np.packbits(invalid).tofile(os.path.join(vox, f"{i:06d}.invalid"))
    return root


def kitti_fab_configs(root):
    """``kitti_occ`` and ``kitti_novel_depth`` on the fabricated tree,
    registered as ``kitti_occ_fab`` / ``kitti_novel_depth_fab``: the
    recipes' own values, the data path, and the train split cut to
    sequence 00 (the val split is 08, as in the recipe)."""
    from selfocc_tpu_torch.configs import experiments as ex

    def occ():
        cfg = ex.kitti_occ()
        return dataclasses.replace(
            cfg, name="kitti_occ_fab",
            train_dataset_args=dict(cfg.train_dataset_args, data_path=root,
                                    sequences=["00"]),
            val_dataset_args=dict(cfg.val_dataset_args, data_path=root))

    def novel():
        cfg = ex.kitti_novel_depth()
        return dataclasses.replace(
            cfg, name="kitti_novel_depth_fab",
            val_dataset_args=dict(cfg.val_dataset_args, data_path=root))

    ex.register_config("kitti_occ_fab", occ)
    ex.register_config("kitti_novel_depth_fab", novel)
    return occ(), novel()


def kitti_wrappers():
    """The kernels of the kitti_occ training step, grouped by the kernel
    instances each must launch: the render's trilinear forward and its
    backward on the 4-channel volume (rows), the values-only query forward
    and backward on the uniform grid (rows) and at the compact taps on the
    sdf plane (plane), the fused render and MSDA."""
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    return (((render_weights.neus_render_fwd, render_weights.neus_render_bwd,
              msda.msda_fwd, msda.msda_bwd), ()),
            ((interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd),
             ("rows",)),
            ((interp.trilinear_cf_fwd, interp.trilinear_cf_bwd),
             ("plane", "rows")))


def read_kitti_counts(path):
    """``read_counts`` over ``kitti_wrappers``, each group with its
    instances."""
    counts = {}
    for fns, instances in kitti_wrappers():
        counts.update(read_counts(fns, path, instances))
    return counts


def kitti_train(device, work):
    """kitti_occ at full width from the fabricated loader through
    ``train.main``: a cold step and 4 measured steps (losses and
    ``grad_norm`` finite and logged every step, so each step's time ends
    with its losses read), launch counts and peak memory; then on a
    trainer of its own and one loader batch: a warm step, WARM_STEPS
    synchronised warm steps (median and spread), a profiled warm step with
    its launches (the values-only kernels on the plane: forward 6, backward
    3, one query of the six compact taps per chunk), and a warm step under
    ``set_sync_debug_mode("error")``."""
    import os
    import torch
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.utils.runtime import to_device
    for fns, _ in kitti_wrappers():
        reset_counts(fns)
    torch.cuda.reset_peak_memory_stats()
    r = train.main(["--py-config", "kitti_occ_fab", "--seed", str(SEED),
                    "--print-freq", "1", "--prefetch", "2", "--max-steps",
                    "5", "--work-dir", os.path.join(work, "train")])
    launches = read_kitti_counts("kitti_occ training steps from the loader")
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = ("ReprojLossMonoMultiNew", "RGBLossMS", "EikonalLoss",
            "SecondGradLoss", "SoftSparsityLoss", "grad_norm")
    for step, vals in r["logged"].items():
        if not all(k in vals and math.isfinite(vals[k]) for k in want):
            raise AssertionError(f"kitti step {step}: {vals}")
    measured = sorted(r["step_s"][1:])
    med = (measured[1] + measured[2]) / 2
    cfg = get_config("kitti_occ_fab")
    trainer = train.build_trainer(cfg, SEED, device)
    batch = to_device(train.host_batch(build_dataset(cfg, "train"), 1, SEED,
                                       0, 0), device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer.step(batch, gen, sync=torch.cuda.synchronize)
    warm = []
    for _ in range(WARM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch, gen, sync=torch.cuda.synchronize)
        warm.append(time.perf_counter() - t0)
    warm_sorted = sorted(warm)
    warm_med = (warm_sorted[WARM_STEPS // 2 - 1]
                + warm_sorted[WARM_STEPS // 2]) / 2
    for fns, _ in kitti_wrappers():
        reset_counts(fns)
    # busy share over the loader-fed median, as in earlier runs; the warm
    # median's beside it
    prof = profile_step(trainer, batch, gen, med)
    prof["device_busy_share_warm"] = prof["kernel_ms"] / 1e3 / warm_med
    per_step = read_kitti_counts("profiled kitti_occ step")
    # one values-only query of the six compact taps per chunk: 3 chunks,
    # the forward run again by the chunk's checkpoint
    plane = {k: per_step[f"{k}.plane"]
             for k in ("trilinear_cf_fwd", "trilinear_cf_bwd")}
    if plane != {"trilinear_cf_fwd": 6, "trilinear_cf_bwd": 3}:
        raise AssertionError(f"kitti_occ step: values-only launches on the "
                             f"plane {plane}, want forward 6, backward 3")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = trainer.step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not all(math.isfinite(float(v)) for k, v in m.items()
               if k != "times"):
        raise AssertionError(f"sync-checked kitti step: {m}")
    res = {"items": r["items"], "step_s": r["step_s"],
           "step_s_median": med, "step_s_spread": [measured[0],
                                                   measured[-1]],
           "max_memory_gb": peak, "logged": r["logged"],
           "launches": launches, "launches_per_step": per_step,
           "warm_step_s": warm, "warm_step_s_median": warm_med,
           "warm_step_s_spread": [warm_sorted[0], warm_sorted[-1]],
           "profile": prof, "sync_checked": True}
    log(f"  kitti_occ from the loader: step s {r['step_s']} (median of "
        f"steps 1-4 {med:.4f}), peak {peak:.2f} GiB, last losses "
        f"{r['logged'][max(r['logged'])]}; {WARM_STEPS} warm steps on one "
        f"batch {[round(x, 4) for x in warm]} (median {warm_med:.4f}); "
        f"busy {prof['device_busy_share']:.1%} of the loader-fed median, "
        f"{prof['device_busy_share_warm']:.1%} of the warm median; "
        f"launches per step {per_step}")
    del trainer, batch
    torch.cuda.empty_cache()
    return res


def kitti_tiny_config():
    """``tiny`` widths with ``kitti_occ``'s options (as the CPU parity test
    builds them): the h_half mapping over a front-only box, one camera, the
    compact second derivative, ``return_uniform_sdf`` with the five KITTI
    losses, 3 SH colour channels, no semantic head, dropout 0."""
    from selfocc_tpu_torch.configs import experiments as ex
    cfg, k = ex.tiny(), ex.kitti_occ()
    pc = (-10.0, 0.0, -1.0, 10.0, 10.0, 3.0)
    mapping = dict(cfg.model.head.mapping_args, h_half=True)
    loss_cfgs = [dict(c, img_size=list(cfg.img_size),
                      ray_resize=list(cfg.num_rays)) if "img_size" in c
                 else dict(c) for c in k.loss_cfgs]
    enc = dataclasses.replace(cfg.model.encoder, mapping_args=mapping,
                              pc_range=pc, num_cams=1, dropout=0.0)
    head = dataclasses.replace(
        cfg.model.head, roi_aabb=pc, mapping_args=mapping,
        use_compact_2nd_grad=True, return_uniform_sdf=True, return_sem=False,
        color_dims=3, sem_dims=0)
    return dataclasses.replace(
        cfg, name="kitti_tiny",
        model=dataclasses.replace(cfg.model, encoder=enc, head=head),
        loss_cfgs=loss_cfgs, loss_input_convertion=dict(
            k.loss_input_convertion), num_cams=1, sem=False)


def kitti_train_parity(device):
    """A KITTI-shaped ``tiny`` step with the kernels on the card (rendered
    in checkpointed chunks of 20 rays: 24 rays, the last chunk padded)
    against the plain versions on the CPU rendered densely, same weights
    and draws (the uniform grid's shift included): four losses within rtol
    1e-5 and each parameter's gradient of them within GRAD_RTOL of its max;
    SecondGradLoss within rtol 1e-3, and its stencil held on one volume.
    The compact stencil divides differences of sdf taps 0.01 m apart by
    1e-4, so it turns the rounding differences of the two paths' decoded
    volumes (the encoder's sums on the card and on the CPU) into noise at
    every sample whose taps share a cell, where the true second derivative
    is 0 and |.| keeps the noise: the loss moves by about 3e-4 of itself,
    and its parameter gradients by rounding noise alone where they vanish
    in exact arithmetic (the sdf channel's bias shifts all taps alike);
    their worst error is reported. So the card's second derivative is
    also held on the card's decoded volume handed to both paths, at the
    first chunk's samples: values within 1e-4 of their max + 1e-5 and the
    volume's cotangent (a random one) within GRAD_RTOL of its max, as
    tests/test_torch_port_train.py holds them against JAX. The sdf is
    centred on 0 (the last layer's bias), so that SoftSparsityLoss has
    negative sdf to act on."""
    import torch
    from selfocc_tpu_torch.geometry.projection import rays_from_img2lidar
    from selfocc_tpu_torch.losses import MultiLoss
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.models.heads import uniform_axes
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    from selfocc_tpu_torch.utils.train_lib import build_loss_inputs
    cfg = kitti_tiny_config()
    h = cfg.model.head
    item = get_dataset(cfg, synthetic=True)[0]
    g = torch.Generator().manual_seed(SEED)
    R = h.ray_number[0] * h.ray_number[1]
    xs, ys, zs = uniform_axes(h.roi_aabb, h.resolution)
    draws = {"cellular": torch.rand(4, generator=g),
             "t_rand": torch.rand((R, h.num_samples + 1), generator=g),
             "bkgd": torch.rand((R, 3), generator=g),
             "uniform_shift": torch.rand((len(ys), len(xs), len(zs), 3),
                                         generator=g)}
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.head.field.density_net[-1].bias[0] -= 1.0
    results = []
    for dev, chunk in ((device, PARITY_RAY_CHUNK), (torch.device("cpu"), 0)):
        m = copy.deepcopy(model).to(dev).train()
        m.head.train_ray_chunk = chunk
        batch = to_device(item, dev)
        grads = []
        for part in ("others", "SecondGradLoss"):
            out = m(batch["imgs"], batch["lidar2img"], batch[h.trans_kw],
                    train=True, draws=draws)
            _, ldict = MultiLoss(cfg.loss_cfgs)(
                build_loss_inputs(cfg, out, batch))
            loss = ldict["SecondGradLoss"] if part == "SecondGradLoss" else \
                sum(v for k, v in ldict.items() if k != "SecondGradLoss")
            m.zero_grad(set_to_none=True)
            loss.backward()
            grads.append({n: p.grad.detach().cpu()
                          for n, p in m.named_parameters()
                          if p.grad is not None})
        results.append(({k: float(v.detach()) for k, v in ldict.items()},
                        grads))
        if dev == device:
            with torch.no_grad():
                volume = m.prepare(batch["imgs"], batch["lidar2img"])
            head = m.head
            rays = head.ray_sampler(dev, None, draws["cellular"].to(dev))
            o, d = rays_from_img2lidar(batch[h.trans_kw], rays)
            o = o[:, :, None, :].expand(d.shape).reshape(-1, 3)
            unit = d.reshape(-1, 3)
            unit = unit / torch.linalg.norm(unit, dim=-1, keepdim=True)
            near, far = neus.ray_aabb_near_far(o, unit, head.roi_aabb,
                                               head.near_plane,
                                               head.far_plane)
            mids = neus.sample_uniform(near, far, head.num_samples,
                                       draws["t_rand"].to(dev)).mids
            pos = (o[:, None] + unit[:, None] * mids[..., None]).reshape(-1,
                                                                         3)
    (l_k, g_k), (l_p, g_p) = results
    if not l_p["SoftSparsityLoss"] > 0:
        raise AssertionError(f"kitti parity: no negative sdf ({l_p})")
    for k in l_p:
        rtol = 1e-3 if k == "SecondGradLoss" else 1e-5
        check(f"kitti tiny loss {k}", abs(l_k[k] - l_p[k]),
              rtol * abs(l_p[k]) + 1e-7)
    worst = {}
    for part, gk, gp in zip(("others", "SecondGradLoss"), g_k, g_p):
        if set(gk) != set(gp):
            raise AssertionError(f"kitti parity {part}: gradients of "
                                 f"{sorted(set(gk) ^ set(gp))}")
        w = 0.0
        for n in gp:
            err = max_err(gk[n], gp[n])
            tol = GRAD_RTOL * float(gp[n].abs().max()) + 1e-7
            if part == "others" and not err <= tol:
                raise AssertionError(f"kitti tiny grad {n}: {err:.3e} > "
                                     f"{tol:.3e}")
            w = max(w, err / tol)
        worst[part] = w
    # the stencil on one volume: kernels on the card, plain on the CPU
    field = model.head.field
    cot = torch.randn((pos.shape[0], 3), generator=g)
    stencil = []
    for dev in (device, torch.device("cpu")):
        v = volume.detach().permute(1, 2, 3, 0).contiguous().to(dev)
        v.requires_grad_(True)
        sg = field.to(dev).second_grad(v.permute(3, 0, 1, 2), pos.to(dev),
                                       h.numerical_gradients_delta)
        (sg * cot.to(dev)).sum().backward()
        stencil.append((sg.detach().cpu(), v.grad.cpu()))
    field.cpu()
    (sg_k, gv_k), (sg_p, gv_p) = stencil
    check("kitti compact second derivative (one volume)",
          max_err(sg_k, sg_p), 1e-4 * float(sg_p.abs().max()) + 1e-5)
    # the cotangent of each voxel is a sum of terms of 1 / delta^2 = 1e4
    # times the cotangent that cancel within a cell, so its rounding scales
    # with the sum of their magnitudes: the stencil's cotangent of |cot|
    # with every coefficient taken positive (``absolute``)
    absolute = stencil_absolute_cotangent(field, volume.detach().cpu(),
                                          pos.cpu(), cot,
                                          h.numerical_gradients_delta)
    excess = ((gv_k[..., 0] - gv_p[..., 0]).abs().double()
              - GRAD_RTOL * float(gv_p.abs().max()) - 1e-7)
    ratio = float((excess / absolute.double().clamp_min(1e-30)).max())
    log(f"  kitti stencil cotangent: max_abs_err {max_err(gv_k, gv_p):.3e}, "
        f"largest {float(gv_p.abs().max()):.3e}, largest absolute sum "
        f"{float(absolute.max()):.3e}; error beyond GRAD_RTOL of the max "
        f"over the absolute sum: {ratio:.3e} (tolerance {STENCIL_RTOL:.0e})")
    if not ratio <= STENCIL_RTOL:
        raise AssertionError(f"kitti stencil cotangent: {ratio:.3e}")
    log(f"  kitti tiny, chunks of {PARITY_RAY_CHUNK} rays on the card vs "
        f"dense on the CPU: losses {l_k}; worst gradient error over "
        f"GRAD_RTOL of its max {worst} (SecondGradLoss's reported, not "
        f"held: see the docstring); the stencil on {pos.shape[0]} samples "
        f"of one volume within tolerance")
    return {"losses_cuda": l_k, "losses_cpu": l_p,
            "worst_grad_err_over_tol": worst,
            "second_grad_loss_rel_diff": abs(
                l_k["SecondGradLoss"] - l_p["SecondGradLoss"])
            / abs(l_p["SecondGradLoss"]),
            "stencil_max_abs_err": [max_err(sg_k, sg_p),
                                    max_err(gv_k, gv_p)]}


def stencil_absolute_cotangent(field, volume, pos, cot, delta):
    """The volume cotangent of the compact second derivative at metric
    points ``pos`` for the cotangent ``|cot|`` (N, 3), every stencil
    coefficient (1 / delta^2 at each tap, 2 / delta^2 at the centre) taken
    positive: per voxel, the sum of the magnitudes of the terms whose
    signed sum is the cotangent. Plain versions, (H, W, D)."""
    import torch
    from selfocc_tpu_torch.ops import interp
    plane = interp.first_channel(volume)
    a = cot.abs() / (delta * delta)
    m = field.mapping.meter2grid
    out = interp.trilinear_cf_bwd_plain(plane, m(pos), 2 * a.sum(-1,
                                                                 True))
    eye = torch.eye(3) * delta
    for axis in range(3):
        for sign in (1.0, -1.0):
            out = out + interp.trilinear_cf_bwd_plain(
                plane, m(pos + sign * eye[axis]), a[:, axis:axis + 1])
    return out[0]


def kitti_occupancy(device, root):
    """``eval_iou_kitti.main`` on one fabricated val frame (the 256 x 256 x
    32 grid over the front box at 0.2 m, labels read from ``root``), with
    its launch counts and peak memory; then the same model's query on that
    frame's volume, kernel path against plain path (the plain versions on
    the card): the occupancies may differ only at voxels with |sdf| <
    1e-5."""
    import numpy as np
    import torch
    from selfocc_tpu_torch import eval_iou_kitti
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.eval_depth import build_model
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.utils.eval_lib import GridOccEvaluator
    from selfocc_tpu_torch.utils.runtime import to_device
    wrappers = (interp.trilinear_cf_fwd, msda.msda_fwd)
    args = ["--py-config", "kitti_occ_fab", "--num-samples", "1",
            "--kitti-root", root, "--seed", str(SEED)]
    eval_iou_kitti.main(args)                      # cold
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    r = eval_iou_kitti.main(args)
    launches = read_counts(wrappers, "kitti occupancy frame")
    peak = torch.cuda.max_memory_allocated() / 2**30
    scores = {"iou": r["iou"], "scenerf_iou": r["stats"]["iou"],
              **{k: r["stats"][k] for k in ("precision", "recall",
                                             "iou_ssc_mean")}}
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"eval_iou_kitti scores: {scores}")
    cfg = get_config("kitti_occ_fab")
    model = build_model(cfg, SEED, device)
    batch = to_device(build_dataset(cfg, "val")[0], device)
    ev = GridOccEvaluator(model)
    volume = ev.prepare(batch["imgs"], batch["lidar2img"])
    aabb = eval_iou_kitti.KITTI_AABB
    sdf_k = ev.query_grid_device(volume, aabb, 0.2, keys=("sdf",))["sdf"]
    flat, shape = ev._flat_grid(aabb, 0.2, device)
    sdf_p = interp.trilinear_sample_cf_plain(
        interp.first_channel(volume),
        model.head.field.mapping.meter2grid(flat))[..., 0].reshape(shape)
    differ = (sdf_k <= 0) != (sdf_p <= 0)
    bad = differ & ~((sdf_k.abs() < 1e-5) | (sdf_p.abs() < 1e-5))
    flips = {"voxels": int(differ.numel()), "differ": int(differ.sum()),
             "sdf_max_abs_err": max_err(sdf_k, sdf_p),
             "occupied": float((sdf_k <= 0).float().mean())}
    log(f"  kitti occupancy: prepare {r['prepare_s']:.4f} s, query "
        f"{r['query_s']:.4f} s, peak {peak:.2f} GiB, scores {scores}; kernel "
        f"vs plain {flips}")
    if int(bad.sum()):
        raise AssertionError(f"kitti occupancy: {int(bad.sum())} voxels "
                             "differ outside |sdf| < 1e-5")
    del model, volume, sdf_k, sdf_p, flat
    torch.cuda.empty_cache()
    return {"prepare_s": r["prepare_s"], "query_s": r["query_s"],
            "grid": list(shape), "max_memory_gb": peak, "scores": scores,
            "launches": launches, "kernel_vs_plain": flips}


def kitti_eval_depth(device):
    """``eval_depth.main`` on one fabricated kitti_occ val frame (its lidar
    depth: ``EVAL_OVERRIDES`` puts ``return_depth`` on the val split) after
    a cold frame: prepare_s, render_s, launches (the fused render on the
    plane instance), peak, a finite table."""
    import numpy as np
    import torch
    from selfocc_tpu_torch import eval_depth
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    wrappers = (msda.msda_fwd, interp.trilinear_cf_with_grad_fwd,
                rw.neus_render_fwd)
    off = (rw.neus_weights_fwd, rw.neus_render_bwd, interp.trilinear_bwd,
           msda.msda_bwd)
    args = ["--py-config", "kitti_occ_fab", "--num-samples", "1", "--seed",
            str(SEED)]
    eval_depth.main(args)                          # cold
    reset_counts(wrappers + off)
    torch.cuda.reset_peak_memory_stats()
    r = eval_depth.main(args)
    launches = read_counts(wrappers, "kitti eval_depth frame")
    stray = {fn.__name__: fn.launches for fn in off if fn.launches}
    if stray:
        raise AssertionError(f"the kitti eval_depth frame launched {stray}")
    table = {k: float(np.mean(v)) for k, v in r["metric"].items()}
    if not all(np.isfinite(v) for v in table.values()):
        raise AssertionError(f"kitti eval_depth table: {table}")
    res = {"prepare_s": r["prepare_s"], "render_s": r["render_s"],
           "rays": r["rays"],
           "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "table": table}
    log(f"  kitti eval_depth frame: prepare {r['prepare_s']:.4f} s, render "
        f"{r['render_s']:.4f} s, {r['rays']} rays, table {table}")
    return res


def kitti_novel(device):
    """``eval_novel_depth_kitti.main`` on the fabricated sequence 08,
    ``--depth-tgt raw`` then ``max``: two frames (0 and 5, with 9 and 5
    following neighbours), prepare and render per neighbour (176 x 608
    rays), rays/s, peak, launch counts; then on frame 0's first neighbour:
    depths finite and in their rays' bands, and a 4096-ray subset on the
    card against the plain versions on the CPU (depth 1e-3 m, acc 1e-4, as
    [frame])."""
    import numpy as np
    import torch
    from selfocc_tpu_torch import eval_depth, eval_novel_depth_kitti
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  eval_ray_grid,
                                                  prep_input_imgs,
                                                  rays_for_cams)
    res = {}
    wrappers = (render_weights.neus_render_fwd,
                interp.trilinear_cf_with_grad_fwd, msda.msda_fwd)
    for tgt in ("raw", "max"):
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        r = eval_novel_depth_kitti.main([
            "--py-config", "kitti_novel_depth_fab", "--num-samples", "2",
            "--depth-tgt", tgt, "--seed", str(SEED)])
        launches = read_counts(wrappers, f"kitti novel-view frames ({tgt})")
        table = dict(r["table"])
        if not table or not all(np.isfinite(v).all()
                                for v in map(np.asarray, table.values())):
            raise AssertionError(f"kitti novel depth table ({tgt}): {table}")
        cfg = get_config("kitti_novel_depth_fab")
        if r["rays"] != cfg.eval_num_rays[0] * cfg.eval_num_rays[1]:
            raise AssertionError(f"kitti novel: {r['rays']} rays")
        warm = r["render_s"][1:]
        res[tgt] = {"prepare_s": r["prepare_s"], "render_s": r["render_s"],
                    "rays": r["rays"],
                    "rays_per_s": r["rays"] / (sum(warm) / len(warm)),
                    "max_memory_gb": torch.cuda.max_memory_allocated()
                    / 2**30, "launches": launches, "table": table}
        log(f"  kitti novel ({tgt}): prepare {r['prepare_s']} s, render per "
            f"neighbour {r['render_s']} s ({res[tgt]['rays_per_s']:.0f} "
            f"rays/s warm), peak {res[tgt]['max_memory_gb']:.2f} GiB")
    cfg = get_config("kitti_novel_depth_fab")
    model = eval_depth.build_model(cfg, SEED, device)
    input_imgs, _, metas = build_dataset(cfg, "novel_eval")[0]
    imgs = prep_input_imgs(input_imgs, cfg, device)
    l2i = torch.as_tensor(np.asarray(metas["lidar2img"]), dtype=torch.float32,
                          device=device)[None]
    renderer = ChunkedRenderer(model, chunk=CHUNK, outputs=("depth", "acc"))
    volume = renderer.prepare(imgs, l2i)
    tem = torch.as_tensor(np.asarray(metas["temImg2lidars"][0]),
                          dtype=torch.float32, device=device)[None]
    origin, direction = rays_for_cams(tem, eval_ray_grid(cfg, device=device))
    out = renderer.render_device(volume, origin, direction)
    dn = torch.linalg.norm(direction, dim=-1)
    near, far = neus.ray_aabb_near_far(origin, direction / dn[:, None],
                                       cfg.model.head.roi_aabb)
    if not bool(torch.isfinite(out["depth"]).all()):
        raise AssertionError("kitti novel depth: non-finite")
    if bool((out["depth"] < out["acc"] * near / dn - 1e-3).any()) or \
            bool((out["depth"] > far / dn * (1 + 1e-5) + 1e-3).any()):
        raise AssertionError("kitti novel depth outside [acc near, far]")
    idx = torch.linspace(0, origin.shape[0] - 1, SUBSET_RAYS,
                         device=device).long()
    gpu = ChunkedRenderer(model, chunk=SUBSET_RAYS,
                          outputs=("depth", "acc")).render(
        volume, origin[idx], direction[idx])
    cpu_model = copy.deepcopy(model).cpu()
    cpu = ChunkedRenderer(cpu_model, chunk=SUBSET_RAYS,
                          outputs=("depth", "acc")).render(
        volume.cpu(), origin[idx].cpu(), direction[idx].cpu())
    sub = {k: float(abs(gpu[k].astype("float64") - cpu[k]).max())
           for k in ("depth", "acc")}
    log(f"  kitti novel: depths finite and in band; 4096-ray subset, "
        f"kernels vs plain (CPU): {sub}")
    if not (sub["depth"] <= 1e-3 and sub["acc"] <= 1e-4):
        raise AssertionError(f"kitti novel subset disagrees: {sub}")
    res["subset_err"] = sub
    del model, cpu_model, volume, out
    torch.cuda.empty_cache()
    return res


def kitti_phase(device):
    """The SemanticKITTI recipe on a fabricated full-size odometry tree (a
    temporary directory, removed after): kitti_occ training from the
    loader, the KITTI-shaped tiny step against the CPU, one occupancy eval
    frame, one eval_depth frame and the novel-view depth eval."""
    import glob
    import os
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="selfocc_kitti_")
    try:
        t0 = time.time()
        fabricate_kitti(root)
        kitti_fab_configs(root)
        log(f"  fabricated SemanticKITTI sequences 00 ({KITTI_TRAIN_FRAMES} "
            f"frames) and 08 ({KITTI_VAL_FRAMES}) of {KITTI_IMG[1]}x"
            f"{KITTI_IMG[0]} PNGs and {KITTI_LIDAR_POINTS}-point scans in "
            f"{time.time() - t0:.1f}s")
        res = {"decoder": decoder_check("kitti", sorted(glob.glob(
            os.path.join(root, "dataset", "sequences", "00", "image_2",
                         "*.png")))[:8], KITTI_IMG)}
        res["train"] = kitti_train(device, root)
        res["train_parity"] = kitti_train_parity(device)
        res["occupancy"] = kitti_occupancy(device, root)
        res["eval_depth"] = kitti_eval_depth(device)
        res["novel"] = kitti_novel(device)
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


RAW_DAY = "2011_09_26"                 # its images are 1242 x 375
RAW_IMG = (375, 1242)
RAW_DRIVES = ("2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync")
RAW_FRAMES = 12                        # frames per drive
RAW_STEP = 1.0123                      # metres per frame, off the knots
RAW_LIDAR_POINTS = 120_000             # points per scan, 4 float32 each
# KITTI-like calibration of the 2011_09_26 drives: rectified projections
# of cameras 2 and 3 (focal 721.5 px, 0.54 m apart), the rectifying
# rotation, velodyne -> camera 0 (for (focal, cx, cy) of another image
# size, ``raw_calib`` scales the projections)
RAW_P2 = (721.5377, 609.5593, 172.854, 44.85728, 0.2163791, 0.002745884)
RAW_P3 = (721.5377, 609.5593, 172.854, -339.5242, 2.199936, 0.002729905)
RAW_R_RECT = ("9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 "
              "9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 "
              "9.999631e-01")
RAW_VELO = ("R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 "
            "7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 "
            "1.480755e-02\nT: -4.069766e-03 -7.631618e-02 -2.717806e-01\n")


def raw_calib(img_hw):
    """``calib_cam_to_cam.txt`` of the fabricated day for images of
    ``img_hw``: the 2011_09_26 projections scaled to that size."""
    s = img_hw[1] / RAW_IMG[1]
    lines = ["calib_time: 09-Jan-2012 13:57:47"]
    for name, (f, cx, cy, tx, ty, tz) in (("P_rect_02", RAW_P2),
                                          ("P_rect_03", RAW_P3)):
        lines.append(f"{name}: {f * s:.6e} 0 {cx * s:.6e} {tx * s:.6e} 0 "
                     f"{f * s:.6e} {cy * s:.6e} {ty * s:.6e} 0 0 1 {tz:.6e}")
    lines.append(f"R_rect_00: {RAW_R_RECT}")
    return "\n".join(lines) + "\n"


def fabricate_kitti_raw(root, img_hw=RAW_IMG, frames=RAW_FRAMES,
                        points=RAW_LIDAR_POINTS):
    """A KITTI-raw tree under ``root`` in the layout of the JAX tests'
    fixture (``tests/test_kitti_raw_dataset.py::_make_raw_tree``): the day
    ``2011_09_26`` with two drives of ``frames`` frames ``RAW_STEP`` metres
    apart along the camera's z, ``image_02`` / ``image_03`` PNGs of
    ``img_hw`` (smooth colour fields with noise of their own per frame and
    side), velodyne scans of ``points`` points (x, y, z, reflectance; 3/4 on
    the ground 3-70 m out, 1/4 on walls 8-40 m out), the day's calibration
    (``raw_calib``), ORB-SLAM pose files and the eigen_zhou split: every
    4th frame of each drive, both sides, in ``test_files.txt``, the others
    in ``train_files.txt``. Returns (root, pose dir, split dir)."""
    import math
    import os
    from concurrent.futures import ThreadPoolExecutor
    import cv2
    import numpy as np
    H, W = img_hw
    y = np.linspace(0, 1, H)[:, None]
    x = np.linspace(0, 1, W)[None]
    data, poses = os.path.join(root, "raw"), os.path.join(root, "poses")
    split = os.path.join(root, "splits", "eigen_zhou")
    for d in (os.path.join(poses, RAW_DAY), split):
        os.makedirs(d)

    def write_frame(job):
        d, i = job
        seq = os.path.join(data, RAW_DAY, RAW_DRIVES[d])
        r = np.random.RandomState(1000 * d + i)
        for c, cam in enumerate(("image_02", "image_03")):
            img = np.stack(np.broadcast_arrays(
                120 + 80 * np.sin(6 * x + 0.3 * i + c) * y,
                140 + 60 * np.cos(4 * y + 2 * x + 0.1 * i),
                160 - 100 * y + 30 * np.sin(9 * x * y + 0.2 * i + d)), -1)
            img = img + r.uniform(-30, 30, img.shape)
            cv2.imwrite(os.path.join(seq, cam, "data", f"{i:010d}.png"),
                        img.clip(0, 255).astype(np.uint8))
        n_g = points * 3 // 4
        ang = r.uniform(0, 2 * math.pi, points)
        rad = np.concatenate([r.uniform(3, 70, n_g),
                              r.uniform(8, 40, points - n_g)])
        z = np.concatenate([np.full(n_g, -1.73),
                            r.uniform(-1.73, 3, points - n_g)])
        pts = np.stack([rad * np.cos(ang), rad * np.sin(ang), z,
                        r.uniform(0, 1, points)], 1)
        pts.astype(np.float32).tofile(os.path.join(
            seq, "velodyne_points", "data", f"{i:010d}.bin"))

    lines = {"train_files.txt": [], "test_files.txt": []}
    for d, drive in enumerate(RAW_DRIVES):
        seq = os.path.join(data, RAW_DAY, drive)
        for sub in ("image_02/data", "image_03/data", "velodyne_points/data"):
            os.makedirs(os.path.join(seq, sub))
        rows = []
        for i in range(frames):
            pose = np.eye(4)
            pose[2, 3] = RAW_STEP * i
            rows.append(" ".join(f"{v:.9e}" for v in pose[:3].reshape(-1)))
            name = "train_files.txt" if i % 4 else "test_files.txt"
            lines[name] += [f"{RAW_DAY}/{drive} {i} l",
                            f"{RAW_DAY}/{drive} {i} r"]
        with open(os.path.join(poses, RAW_DAY, f"{drive}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(data, RAW_DAY, "calib_cam_to_cam.txt"), "w") as f:
        f.write(raw_calib(img_hw))
    with open(os.path.join(data, RAW_DAY, "calib_velo_to_cam.txt"), "w") as f:
        f.write(RAW_VELO)
    for name, rows in lines.items():
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_frame, [(d, i) for d in range(len(RAW_DRIVES))
                                    for i in range(frames)]))
    return data, poses, split


def raw_dataset_args(cfg, tree, **extra):
    """``cfg``'s train and val dataset arguments pointed at a
    ``fabricate_kitti_raw`` tree (its eigen_zhou split files)."""
    import os
    data, poses, split = tree
    return {f"{phase}_dataset_args": dict(
        getattr(cfg, f"{phase}_dataset_args"), data_path=data,
        pose_path=poses, split_path=os.path.join(split, name), **extra)
        for phase, name in (("train", "train_files.txt"),
                            ("val", "test_files.txt"))}


def depth_fab_configs(tree, nusc_paths):
    """``kitti_raw_depth`` on the fabricated KITTI-raw tree and
    ``nuscenes_depth`` on the fabricated nuScenes files, registered as
    ``kitti_raw_depth_fab`` / ``nuscenes_depth_fab``: the recipes' own
    values with the data paths."""
    from selfocc_tpu_torch.configs import experiments as ex

    def raw():
        cfg = ex.kitti_raw_depth()
        return dataclasses.replace(cfg, name="kitti_raw_depth_fab",
                                   **raw_dataset_args(cfg, tree))

    def nusc():
        cfg = ex.nuscenes_depth()
        files = dict(data_path=nusc_paths["data_path"],
                     imageset=nusc_paths["sweeps"])
        return dataclasses.replace(
            cfg, name="nuscenes_depth_fab",
            train_dataset_args=dict(cfg.train_dataset_args, **files),
            val_dataset_args=dict(cfg.val_dataset_args, **files))

    ex.register_config("kitti_raw_depth_fab", raw)
    ex.register_config("nuscenes_depth_fab", nusc)


def depth_kernels():
    """The kernels of the depth recipes' paths, by role: the training
    step's (MSDA forward and backward, the trilinear forward and backward
    on the sdf plane, the fused render and its backward), the eval frame's
    (their forwards) and those that no depth path may launch (the
    trilinear rows instance, checked by count; the values-only query and
    its backward; the unfused weights kernel)."""
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    train = (msda.msda_fwd, msda.msda_bwd, interp.trilinear_cf_with_grad_fwd,
             interp.trilinear_bwd, render_weights.neus_render_fwd,
             render_weights.neus_render_bwd)
    frame = (msda.msda_fwd, interp.trilinear_cf_with_grad_fwd,
             render_weights.neus_render_fwd)
    never = (interp.trilinear_cf_fwd, interp.trilinear_cf_bwd,
             render_weights.neus_weights_fwd)
    return train, frame, never


def reset_depth_counts():
    train, _, never = depth_kernels()
    reset_counts(train + never)


def read_depth_counts(path, training=True):
    """``read_counts`` of a depth path's kernels (each launched; the
    trilinear ones on the plane instance), then no launch of the rows
    instance or of a kernel no depth path runs (and, for an eval frame, of
    a backward)."""
    train, frame, never = depth_kernels()
    need = train if training else frame
    counts = read_counts(need, path)
    stray = {fn.__name__: fn.launches for fn in
             never + tuple(f for f in train if f not in need) if fn.launches}
    stray.update({f"{fn.__name__}.rows": fn.launches - fn.plane_launches
                  for fn in need if hasattr(fn, "plane_launches")
                  and fn.launches != fn.plane_launches})
    if stray:
        raise AssertionError(f"the {path} launched {stray}")
    return counts


def depth_train(device, cfg_name, steps, want):
    """``steps`` training steps of ``cfg_name`` from its loader through
    ``train.main`` (a cold step, then measured ones, each logged so that
    its time ends with its losses read): the losses ``want`` and
    ``grad_norm`` finite, step times, the waits for the batch, peak memory
    and the launch counts of the run. Then on a trainer of its own and one
    loader batch (item 1, its focal ratios checked against the config's
    scale rates): a warm step, 3 steps each ended by a synchronise (the
    step without the loader), a profiled step with its launches, and a
    step under ``set_sync_debug_mode("error")``."""
    import tempfile
    import torch
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.utils.runtime import to_device
    reset_depth_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="selfocc_depth_train_") as work:
        r = train.main(["--py-config", cfg_name, "--seed", str(SEED),
                        "--print-freq", "1", "--prefetch", "2",
                        "--max-steps", str(steps), "--work-dir", work])
    launches = read_depth_counts(f"{cfg_name} training steps")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for step, vals in r["logged"].items():
        if not all(k in vals and math.isfinite(vals[k])
                   for k in want + ("grad_norm",)):
            raise AssertionError(f"{cfg_name} step {step}: {vals}")
    measured = sorted(r["step_s"][1:])
    res = {"items": r["items"], "step_s": r["step_s"],
           "step_s_median": (measured[(len(measured) - 1) // 2]
                             + measured[len(measured) // 2]) / 2,
           "step_s_spread": [measured[0], measured[-1]],
           "data_wait_s": r["data_wait_s"], "max_memory_gb": peak,
           "logged": r["logged"], "launches": launches}
    log(f"  {cfg_name} from the loader: step s {r['step_s']} (median of "
        f"steps 1-{steps - 1} {res['step_s_median']:.4f}), waits for the "
        f"batch {r['data_wait_s']}, peak {peak:.2f} GiB, last losses "
        f"{r['logged'][max(r['logged'])]}")
    cfg = get_config(cfg_name)
    host = train.host_batch(build_dataset(cfg, "train"), 1, SEED, 0, 1)
    # the loader's focal ratios: the scale rate over the pad scale rate
    # (x: its width entry); 0.9975 / 0.9712 for kitti_raw_depth, 1 without
    # a pad_scale_rate (nuscenes_depth)
    pad = cfg.wrapper_args.get("pad_scale_rate", [cfg.scale_rate] * 2)
    ratios = [float(host["focal_ratios_x"][0]),
              float(host["focal_ratios_y"][0])]
    if abs(ratios[0] - cfg.scale_rate / pad[1]) > 1e-6 or \
            abs(ratios[1] - cfg.scale_rate / pad[0]) > 1e-6:
        raise AssertionError(f"{cfg_name} focal ratios {ratios}")
    res["focal_ratios"] = ratios
    trainer = train.build_trainer(cfg, SEED, device)
    batch = to_device(host, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer.step(batch, gen, sync=torch.cuda.synchronize)
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch, gen)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    res["warm_step_s"] = warm
    reset_depth_counts()
    res["profile"] = profile_step(trainer, batch, gen, sorted(warm)[1])
    res["launches_per_step"] = read_depth_counts(f"profiled {cfg_name} step")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = trainer.step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not all(math.isfinite(float(v)) for k, v in m.items()
               if k != "times"):
        raise AssertionError(f"sync-checked {cfg_name} step: {m}")
    res["sync_checked"] = True
    log(f"  {cfg_name}: focal ratios {ratios}; warm steps on one batch "
        f"{[round(t, 4) for t in warm]} s; launches per step "
        f"{res['launches_per_step']}; a warm step under "
        "set_sync_debug_mode('error'): no synchronising call")
    del trainer, batch
    torch.cuda.empty_cache()
    return res


def raw_depth_train(device):
    """kitti_raw_depth at full width: ``depth_train`` with 5 steps, and the
    host seconds of 6 train items as ``train.py`` builds them."""
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    res = depth_train(device, "kitti_raw_depth_fab", 5,
                      ("ReprojLossMonoMultiNew", "EikonalLoss",
                       "EdgeLoss3DMS"))
    from selfocc_tpu_torch import native
    ds = build_dataset(get_config("kitti_raw_depth_fab"), "train")

    def item_s():
        secs = []
        for pos in range(6):
            t0 = time.perf_counter()
            train.host_batch(ds, pos, SEED, 0, pos)
            secs.append(time.perf_counter() - t0)
        return secs
    res["item_s"] = item_s()
    log(f"  kitti_raw_depth: host s per item "
        f"({native.native_status()['decoder']} decoder) "
        f"{[round(s, 4) for s in res['item_s']]}")
    if native.native_available():
        with cv2_decode():
            res["item_s_cv2"] = item_s()
        log(f"  kitti_raw_depth: host s per item (cv2 decoder) "
            f"{[round(s, 4) for s in res['item_s_cv2']]}")
    return res


def raw_tiny_config(tree):
    """``tiny`` widths with ``kitti_raw_depth``'s options, as the CPU
    parity test (``tests/test_torch_port_depth.py``) builds them: the
    h_half mapping over a front-only box, one camera, one sdf channel, the
    recipe's three losses, ``_KITTI_IMG_NORM``, its dataset arguments on
    ``tree`` at a 64 x 96 crop, a 0.5 resize with ``pad_scale_rate``
    (0.5149, 0.5013), dropout 0."""
    from selfocc_tpu_torch.configs import experiments as ex
    cfg, r = ex.tiny(), ex.kitti_raw_depth()
    pc = (-10.0, 0.0, -1.0, 10.0, 10.0, 3.0)
    mapping = dict(cfg.model.head.mapping_args, h_half=True)
    loss_cfgs = [dict(c, img_size=list(cfg.img_size),
                      ray_resize=list(cfg.num_rays)) if "img_size" in c
                 else dict(c) for c in r.loss_cfgs]
    enc = dataclasses.replace(cfg.model.encoder, mapping_args=mapping,
                              pc_range=pc, num_cams=1, dropout=0.0)
    head = dataclasses.replace(
        cfg.model.head, roi_aabb=pc, mapping_args=mapping,
        return_second_grad=False, return_sem=False, color_dims=0, sem_dims=0)
    return dataclasses.replace(
        cfg, name="raw_tiny",
        model=dataclasses.replace(cfg.model, encoder=enc, head=head),
        loss_cfgs=loss_cfgs, loss_input_convertion=dict(
            r.loss_input_convertion), num_cams=1, sem=False,
        dataset_type=r.dataset_type, scale_rate=0.5,
        wrapper_args=dict(r.wrapper_args, pad_img_size=list(cfg.input_size),
                          pad_scale_rate=[0.5149, 0.5013]),
        **raw_dataset_args(r, tree, crop_size=list(cfg.img_size)))


def raw_train_parity(device, root):
    """A KITTI-raw-shaped ``tiny`` step from a loader batch (a 72 x 104
    tree fabricated under ``root``; the batch carries its focal ratios,
    0.9975 / 0.9711, and ``flip``) with the kernels on the card (rendered
    in checkpointed chunks of 20 rays: 24 rays, the last chunk padded)
    against the plain versions on the CPU rendered densely, same weights
    and draws: the three losses within rtol 1e-5, each parameter's
    gradient within GRAD_RTOL of its max + 1e-7."""
    import torch
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.losses import MultiLoss
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import to_device
    from selfocc_tpu_torch.utils.train_lib import aug_kwargs, build_loss_inputs
    cfg = raw_tiny_config(fabricate_kitti_raw(root, (72, 104), 8, 400))
    h = cfg.model.head
    host = train.host_batch(build_dataset(cfg, "train"), 5, SEED, 0, 5)
    ratios = [float(host["focal_ratios_x"][0]), float(host["focal_ratios_y"][0])]
    if not max(abs(r - 1) for r in ratios) > 0.02:
        raise AssertionError(f"raw tiny batch: focal ratios {ratios}")
    g = torch.Generator().manual_seed(SEED)
    R = h.ray_number[0] * h.ray_number[1]
    draws = {"cellular": torch.rand(4, generator=g),
             "t_rand": torch.rand((R, h.num_samples + 1), generator=g),
             "bkgd": torch.rand((R, 3), generator=g)}
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(SEED))
    results = []
    for dev, chunk in ((device, PARITY_RAY_CHUNK), (torch.device("cpu"), 0)):
        m = copy.deepcopy(model).to(dev).train()
        m.head.train_ray_chunk = chunk
        batch = to_device(host, dev)
        out = m(batch["imgs"], batch["lidar2img"], batch[h.trans_kw],
                train=True, draws=draws, **aug_kwargs(batch))
        tot, ldict = MultiLoss(cfg.loss_cfgs)(build_loss_inputs(cfg, out,
                                                                batch))
        m.zero_grad(set_to_none=True)
        tot.backward()
        results.append(({k: float(v.detach()) for k, v in ldict.items()},
                        {n: p.grad.detach().cpu()
                         for n, p in m.named_parameters()
                         if p.grad is not None}))
    (l_k, g_k), (l_p, g_p) = results
    if sorted(l_p) != ["EdgeLoss3DMS", "EikonalLoss",
                       "ReprojLossMonoMultiNew"]:
        raise AssertionError(f"raw tiny losses {l_p}")
    for k in l_p:
        check(f"raw tiny loss {k}", abs(l_k[k] - l_p[k]),
              1e-5 * abs(l_p[k]) + 1e-7)
    if set(g_k) != set(g_p):
        raise AssertionError(f"raw tiny gradients of "
                             f"{sorted(set(g_k) ^ set(g_p))}")
    worst = 0.0
    for n in g_p:
        err = max_err(g_k[n], g_p[n])
        tol = GRAD_RTOL * float(g_p[n].abs().max()) + 1e-7
        if not err <= tol:
            raise AssertionError(f"raw tiny grad {n}: {err:.3e} > {tol:.3e}")
        worst = max(worst, err / tol)
    log(f"  raw tiny, loader batch (focal ratios {ratios}), chunks of "
        f"{PARITY_RAY_CHUNK} rays on the card vs dense on the CPU: losses "
        f"{l_k}; worst gradient error over its tolerance {worst:.3f}")
    return {"focal_ratios": ratios, "losses_cuda": l_k, "losses_cpu": l_p,
            "worst_grad_err_over_tol": worst}


def raw_eval(device):
    """``eval_depth.main`` on 2 fabricated val frames of kitti_raw_depth
    (176 x 608 rays a frame), four runs: raw, ``--flip``, ``--depth-metric-
    tgt max``, ``--save-depth``: prepare and render seconds, rays/s, peak,
    launches, the metric table finite, the saved maps; then on frame 1: the
    depths finite and in their rays' bands, a 4096-ray subset on the card
    against the CPU (depth 1e-3 m, acc 1e-4; ``max_depth`` in the tie band
    of ``max_depth_subset``), the flipped prepare's volume on the card
    against the CPU's (within 1e-4 of its largest magnitude: the two
    backbones' fp32 sums in another order), and a warm flipped frame
    (prepare and render) under ``set_sync_debug_mode("error")``."""
    import os
    import tempfile
    import numpy as np
    import torch
    from selfocc_tpu_torch import eval_depth
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.models import neus
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  enable_max_depth,
                                                  eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    from selfocc_tpu_torch.utils.runtime import to_device
    cfg = get_config("kitti_raw_depth_fab")
    n_rays = cfg.eval_num_rays[0] * cfg.eval_num_rays[1]
    res = {}
    args = ["--py-config", "kitti_raw_depth_fab", "--num-samples", "2",
            "--seed", str(SEED)]
    eval_depth.main(args + ["--flip", "--depth-metric-tgt", "max"])  # cold
    with tempfile.TemporaryDirectory(prefix="selfocc_depth_eval_") as work:
        for tag, flags in (("raw", []), ("flip", ["--flip"]),
                           ("max", ["--depth-metric-tgt", "max"]),
                           ("save", ["--save-depth", "--work-dir", work])):
            reset_depth_counts()
            torch.cuda.reset_peak_memory_stats()
            r = eval_depth.main(args + flags)
            launches = read_depth_counts(f"kitti_raw_depth eval ({tag})",
                                         training=False)
            passes = 2 if tag == "flip" else 1
            if r["rays"] != 2 * passes * n_rays:
                raise AssertionError(f"eval ({tag}): {r['rays']} rays")
            table = {k: float(np.asarray(v).mean())
                     for k, v in r["metric"].items()}
            if not table or not all(np.isfinite(v) for v in table.values()):
                raise AssertionError(f"eval ({tag}) table: {table}")
            res[tag] = {"prepare_s": r["prepare_s"], "render_s": r["render_s"],
                        "rays": r["rays"],
                        "rays_per_s": r["rays"] / r["render_s"],
                        "max_memory_gb": torch.cuda.max_memory_allocated()
                        / 2**30, "launches": launches, "table_means": table}
            log(f"  eval_depth ({tag}): prepare {r['prepare_s']:.4f} s, "
                f"render {r['render_s']:.4f} s for {r['rays']} rays "
                f"({res[tag]['rays_per_s']:.0f} rays/s), peak "
                f"{res[tag]['max_memory_gb']:.2f} GiB, table {table}")
        # the maps, beside the driver's run log <time>.log
        saved = sorted(n for n in os.listdir(work) if not n.endswith(".log"))
        if saved != ["depth_0000.npy", "depth_0001.npy"] or not np.array_equal(
                np.load(os.path.join(work, "depth_0001.npy")),
                r["last_depth"].numpy()):
            raise AssertionError(f"--save-depth wrote {saved}")
        res["save"]["saved"] = saved
    model = eval_depth.build_model(enable_max_depth(cfg), SEED, device)
    batch = to_device(build_dataset(cfg, "val")[1], device)
    origin, direction = rays_for_cams(eval_trans_mats(batch, cfg),
                                      eval_ray_grid(cfg, device=device))
    renderer = ChunkedRenderer(model, chunk=CHUNK, outputs=("depth", "acc"))
    mirrored = batch["imgs"].flip(3)
    vol_f = renderer.prepare(mirrored, batch["lidar2img"], flip=True)
    cpu_model = copy.deepcopy(model).cpu()
    vol_c = ChunkedRenderer(cpu_model).prepare(
        mirrored.cpu(), batch["lidar2img"].cpu(), flip=True)
    vol_err = max_err(vol_f.cpu(), vol_c)
    check("flipped prepare's volume, card vs CPU", vol_err,
          1e-4 * float(vol_c.abs().max()))
    del cpu_model, vol_c
    volume = renderer.prepare(batch["imgs"], batch["lidar2img"])
    out = renderer.render_device(volume, origin, direction)
    dn = torch.linalg.norm(direction, dim=-1)
    near, far = neus.ray_aabb_near_far(origin, direction / dn[:, None],
                                       cfg.model.head.roi_aabb)
    if not bool(torch.isfinite(out["depth"]).all()):
        raise AssertionError("kitti_raw_depth eval: non-finite depth")
    if bool((out["depth"] < out["acc"] * near / dn - 1e-3).any()) or \
            bool((out["depth"] > far / dn * (1 + 1e-5) + 1e-3).any()):
        raise AssertionError("kitti_raw_depth eval: depth outside "
                             "[acc near, far]")
    idx = torch.linspace(0, origin.shape[0] - 1, SUBSET_RAYS,
                         device=device).long()
    gpu = ChunkedRenderer(model, chunk=SUBSET_RAYS,
                          outputs=("depth", "acc")).render(
        volume, origin[idx], direction[idx])
    cpu = ChunkedRenderer(copy.deepcopy(model).cpu(), chunk=SUBSET_RAYS,
                          outputs=("depth", "acc")).render(
        volume.cpu(), origin[idx].cpu(), direction[idx].cpu())
    sub = {k: float(abs(gpu[k].astype("float64") - cpu[k]).max())
           for k in ("depth", "acc")}
    if not (sub["depth"] <= 1e-3 and sub["acc"] <= 1e-4):
        raise AssertionError(f"kitti_raw_depth subset disagrees: {sub}")
    res["subset_err"] = sub
    res["max_depth_subset"] = max_depth_subset(model, volume, origin,
                                               direction)
    res["flip_volume_max_abs_err"] = vol_err
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vol_f = renderer.prepare(mirrored, batch["lidar2img"], flip=True)
        renderer.render_device(vol_f, origin, direction)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    res["sync_checked"] = True
    log(f"  kitti_raw_depth eval frame: depths finite and in band; 4096-ray "
        f"subset vs the CPU {sub}; max_depth {res['max_depth_subset']}; "
        f"flipped volume card vs CPU {vol_err:.3e}; a warm flipped frame "
        "under set_sync_debug_mode('error'): no synchronising call")
    del model, volume, vol_f, out
    torch.cuda.empty_cache()
    return res


def depth_phase(device):
    """The depth recipes on fabricated full-size data (temporary
    directories, removed after): kitti_raw_depth training from the
    KITTI-raw loader, the KITTI-raw-shaped tiny step against the CPU,
    ``eval_depth`` on its val split (raw, flip, max, saved maps), then
    nuscenes_depth training from a fabricated nuScenes tree."""
    import glob
    import os
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="selfocc_depth_")
    try:
        t0 = time.time()
        tree = fabricate_kitti_raw(os.path.join(root, "kitti_raw"))
        nusc = fabricate_nuscenes(os.path.join(root, "nuscenes"))
        depth_fab_configs(tree, nusc)
        log(f"  fabricated KITTI-raw {RAW_DAY} ({len(RAW_DRIVES)} drives x "
            f"{RAW_FRAMES} frames x 2 sides of {RAW_IMG[1]}x{RAW_IMG[0]} "
            f"PNGs, {RAW_LIDAR_POINTS}-point scans) and nuScenes "
            f"({FAB_SAMPLES} keyframes x 6 cameras) in "
            f"{time.time() - t0:.1f}s")
        res = {"decoder": decoder_check("depth", sorted(glob.glob(
            os.path.join(tree[0], RAW_DAY, RAW_DRIVES[0], "image_02", "data",
                         "*.png")))[:8], RAW_IMG)}
        res["kitti_raw_train"] = raw_depth_train(device)
        res["train_parity"] = raw_train_parity(device,
                                               os.path.join(root, "tiny"))
        res["kitti_raw_eval"] = raw_eval(device)
        res["nuscenes_depth_train"] = depth_train(
            device, "nuscenes_depth_fab", 3,
            ("ReprojLossMonoMultiNewCombine", "EikonalLoss", "EdgeLoss3DMS"))
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ levers
LEVER_SHAPES = (     # main-path calls of the nuscenes_occ_fast recipe
    ("self", (1, 78899, ((257, 257), (25, 257), (257, 25)), 12)),
    ("hw", (6, 19840, ((96, 200), (48, 100), (24, 50), (12, 25)), 8)),
    ("zh", (6, 4864, ((96, 200), (48, 100), (24, 50), (12, 25)), 48)))
DENSE_Q = {"hw": 66049, "zh": 6425}   # the same calls without compaction


def shared_case(g, device, B, Q, shapes, P, H=6, D=16):
    """Random inputs of the head-shared op: ``msda_case``'s, with head 0's
    locations shared by every head."""
    value, shapes, loc, att = msda_case(g, device, B, Q, shapes, P, H, D)
    return value, shapes, loc[:, :, 0].contiguous(), att


def broadcast_heads(loc, H):
    """(B, Q, Lv, P, 2) shared locations as the per-head op's (B, Q, H, Lv,
    P, 2)."""
    return loc[:, :, None].expand(-1, -1, H, -1, -1, -1).contiguous()


# msda_shared_describe's fields, in its order
SHARED_INSTANCE_FIELDS = (
    "vec", "group_lanes", "R", "groups_per_unit", "chunks",
    "units_per_tile", "threads", "staging", "head_aligned", "smem_bytes",
    "blocks", "registers", "local_bytes", "static_smem_bytes", "buffers",
    "grads_staged")
SHARED_STAGING = ("bulk", "copy", "in place")


def shared_lib():
    """``csrc/msda_shared.cu``'s library with its describe entry point
    bound."""
    import ctypes
    from selfocc_tpu_torch import _build
    from selfocc_tpu_torch.ops import msda
    lib = _build.load("msda_shared", msda._SHARED_SIGNATURES)
    lib.msda_shared_describe.argtypes = (
        [_build.I32] + [_build.PTR] * 7 + [_build.I64] + [_build.I32] * 6
        + [_build.PTR])
    lib.msda_shared_describe.restype = ctypes.c_int
    return lib


def shared_instance(case, grad_out=None):
    """The instance that ``msda_shared_fwd`` (with ``grad_out``:
    ``msda_shared_bwd``) takes for ``case``: the launcher's plan and the
    kernel's registers, spills and shared memory."""
    import ctypes
    import torch
    from selfocc_tpu_torch import _build
    value, _, loc, att = case
    B, L, H, D = value.shape
    _, Q, Lv, P, _ = loc.shape
    info = (ctypes.c_int * len(SHARED_INSTANCE_FIELDS))()
    if grad_out is None:
        rows = torch.empty((B, Q, H * D), device=value.device)
        ptrs = (rows, None, None, None)
    else:
        ptrs = (grad_out, torch.empty_like(value), torch.empty_like(loc),
                torch.empty_like(att))
    status = shared_lib().msda_shared_describe(
        int(grad_out is not None), _build.ptr(value), _build.ptr(loc),
        _build.ptr(att), *(None if t is None else _build.ptr(t)
                           for t in ptrs), B, L, H, D, Q, Lv, P, info)
    _build.check(status, "msda_shared_describe")
    rec = dict(zip(SHARED_INSTANCE_FIELDS, info))
    rec["staging"] = SHARED_STAGING[rec["staging"]]
    return rec


def corners_in(loc, shapes):
    """Corners inside their level over all points of ``loc`` (B, Q, Lv, P,
    2): the backward sends one RED a row's float4 for each."""
    import torch
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=loc.device)[:, None, :]
    px = loc * size - 0.5
    x0 = px.floor()
    n = 0
    for dy in (0, 1):
        for dx in (0, 1):
            x = x0[..., 0] + dx
            y = x0[..., 1] + dy
            w, h = size[..., 0], size[..., 1]
            n += int(((x >= 0) & (x < w) & (y >= 0) & (y < h)).sum())
    return n


def log_instance(what, rec):
    log(f"  {what}: VEC {rec['vec']}, G {rec['group_lanes']}, R {rec['R']}, "
        f"S {rec['groups_per_unit']}, chunks {rec['chunks']}, "
        f"T {rec['units_per_tile']}, {rec['threads']} threads x "
        f"{rec['blocks']} blocks, staging {rec['staging']} x "
        f"{rec['buffers']} (gradients staged {rec['grads_staged']}), "
        f"head-aligned "
        f"{rec['head_aligned']}, {rec['registers']} registers, "
        f"{rec['local_bytes']} local bytes, {rec['smem_bytes']} B dynamic "
        f"shared")


def shared_ab(base, this, g, device):
    """Device ms and event ms of two checkouts' ``msda_shared_fwd`` /
    ``msda_shared_bwd`` at the three main-path calls, in turns: baseline,
    this, this, baseline; each side's sorted pair of readings."""
    import torch
    cases = {}
    for tag, args in LEVER_SHAPES:
        case = shared_case(g, device, *args)
        value, loc = case[0], case[2]
        cases[tag] = (case, torch.randn(
            (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3]),
            generator=g, device=device))
    runs = {"baseline": [], "this": []}
    for side in ("baseline", "this", "this", "baseline"):
        mod = base if side == "baseline" else this
        r = {}
        for tag, (case, gout) in cases.items():
            def fwd(m=mod, c=case):
                return m.msda_shared_fwd(*c)

            def bwd(m=mod, c=case, go=gout):
                return m.msda_shared_bwd(*c, go)
            r[f"fwd_{tag}"] = (device_ms(fwd, 10), timed(fwd, 10))
            r[f"bwd_{tag}"] = (device_ms(bwd, 10), timed(bwd, 10))
        runs[side].append(r)
        torch.cuda.empty_cache()
    out = {side: {k: sorted((rr[k] for rr in rs), key=lambda t: t[1])
                  for k in rs[0]}
           for side, rs in runs.items()}
    for k in out["this"]:
        log(f"  A/B {k} (device ms, event ms): baseline "
            f"{out['baseline'][k]}, this {out['this'][k]}")
    del cases
    torch.cuda.empty_cache()
    return out


def shared_kernel_checks(device, baseline=None):
    """``msda_shared_fwd`` / ``msda_shared_bwd`` at the nuscenes_occ_fast
    calls: against their plain versions and against the per-head kernels
    on broadcast locations; timed (events, device ms) beside the per-head
    kernels at the compacted and the dense shapes; the backward's REDs (its
    device ms over the forward's, the REDs' bytes); then off-path widths,
    each with the instance it took. With ``baseline`` (a checkout of
    another commit), that checkout's shared kernels timed in turns with
    this one's."""
    import importlib
    import torch
    from selfocc_tpu_torch.ops import msda
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    fwd, bwd, instances = {}, {}, {}
    for tag, args in LEVER_SHAPES:
        case = shared_case(g, device, *args)
        value, shapes, loc, att = case
        B, Q, H, D = value.shape[0], loc.shape[1], value.shape[2], \
            value.shape[3]
        pts = loc[..., 0].numel()
        loc6 = broadcast_heads(loc, H)
        head_case = (value, shapes, loc6, att)
        out = msda.msda_shared_fwd(*case)
        ref_out = msda.ms_deform_attn_shared_plain(*case)
        err = max_err(out, ref_out)
        check(f"msda_shared_fwd ({tag})", err, 1e-5)
        check(f"msda_shared_fwd vs per-head msda_fwd ({tag})",
              max_err(out, msda.msda_fwd(*head_case)), 1e-5)
        f = kernel_record(
            err, timed(lambda: msda.msda_shared_fwd(*case), 5),
            timed(lambda: msda.ms_deform_attn_shared_plain(*case), 3),
            (nbytes(value, loc, att, out),
             pts * (MSDA_FWD_OPS[0] + H * D * MSDA_FWD_OPS[1])),
            device_ms=device_ms(lambda: msda.msda_shared_fwd(*case), 5),
            per_head_device_ms=device_ms(lambda: msda.msda_fwd(*head_case),
                                         5),
            per_head_ms=timed(lambda: msda.msda_fwd(*head_case), 5),
            bytes=nbytes(value, loc, att, out), shape=f"{tag} B={B} Q={Q}")
        grad_out = torch.randn(out.shape, generator=g, device=device)
        del out
        inst = {"fwd": shared_instance(case),
                "bwd": shared_instance(case, grad_out)}
        log_instance(f"msda_shared_fwd ({tag}) instance", inst["fwd"])
        log_instance(f"msda_shared_bwd ({tag}) instance", inst["bwd"])
        got = msda.msda_shared_bwd(*case, grad_out)
        ref = msda.msda_shared_bwd_plain(*case, grad_out)
        err = check_grads(f"msda_shared_bwd ({tag})", got, ref)
        torch.cuda.empty_cache()
        gh = msda.msda_bwd(*head_case, grad_out)
        check_grads(f"msda_shared_bwd vs per-head msda_bwd ({tag})", got,
                    (gh[0], gh[1].sum(2), gh[2]))
        del got, gh
        torch.cuda.empty_cache()
        nb = 2 * nbytes(value, loc, att) + nbytes(grad_out)
        b = kernel_record(
            err, timed(lambda: msda.msda_shared_bwd(*case, grad_out), 5),
            timed(lambda: msda.msda_shared_bwd_plain(*case, grad_out), 2),
            (nb, pts * (MSDA_BWD_OPS[0] + H * MSDA_BWD_OPS[1]
                        + H * D * MSDA_BWD_OPS[2])),
            device_ms=device_ms(
                lambda: msda.msda_shared_bwd(*case, grad_out), 5),
            per_head_device_ms=device_ms(
                lambda: msda.msda_bwd(*head_case, grad_out), 5),
            per_head_ms=timed(lambda: msda.msda_bwd(*head_case, grad_out),
                              5),
            bytes=nb, shape=f"{tag} B={B} Q={Q}")
        del head_case, loc6
        # the backward's REDs: one per in-bounds corner and row float4
        b["red_bytes"] = corners_in(loc, shapes) * H * D * 4
        if b["device_ms"] and f["device_ms"]:
            over = b["over_forward_device_ms"] = \
                b["device_ms"] - f["device_ms"]
            log(f"  {tag}: backward - forward {over:.4f} ms device for "
                f"{b['red_bytes'] / 1e9:.3f} GB of REDs "
                f"({b['red_bytes'] / 1e9 / over:.2f} TB/s)")
        del ref, ref_out
        torch.cuda.empty_cache()
        if tag in DENSE_Q:
            # the per-head kernels on the same call without compaction
            dense = msda_case(g, device, B, DENSE_Q[tag], shapes,
                              args[3])
            gd = torch.randn((B, DENSE_Q[tag], H * D), generator=g,
                             device=device)
            f["per_head_dense_device_ms"] = device_ms(
                lambda: msda.msda_fwd(*dense), 5)
            b["per_head_dense_device_ms"] = device_ms(
                lambda: msda.msda_bwd(*dense, gd), 5)
            del dense, gd
        fwd[tag], bwd[tag], instances[tag] = f, b, inst
        log(f"  {tag}: fwd {f['device_ms']} ms device (per-head on "
            f"broadcast locations {f['per_head_device_ms']}), bound "
            f"{f['bound_ms']:.4f}; bwd {b['device_ms']} (per-head "
            f"{b['per_head_device_ms']}), bound {b['bound_ms']:.4f}")
        del case, value, loc, att, grad_out
        torch.cuda.empty_cache()
    # off-path widths, each with the instance it took: scalar lanes (D =
    # 6), a row of 36 float4s (D = 144: R = 6, 4 masked), H * D / 4 no
    # multiple of the group (H = 5, D = 12; H = 6, D = 20), R = 6 (H = 12,
    # D = 16), a two-lane group (H * D = 8), a group of one row (H = 4, D =
    # 8), a weights block of 3 x 15 floats (staged by plain loads), a value
    # 4 bytes off 16-byte alignment (scalar lanes, two chunks), unit counts
    # no multiple of the tile, fewer units than SMs, units of 2 x 4,000
    # points whose tiles do not fit in shared memory (read in place)
    small = ((12, 10), (6, 5), (3, 3), (2, 2))
    levels = ((96, 200), (48, 100), (24, 50), (12, 25))
    off_path = {}
    for B, Q, H, D, shapes, P, shift in (
            (1, 45, 3, 6, small, 5, False), (1, 19, 1, 144, small[:2], 3,
                                             False),
            (2, 37, 5, 12, small, 4, False), (2, 29, 6, 20, small, 4, False),
            (2, 37, 12, 16, small, 4, False), (2, 53, 2, 4, small, 4, False),
            (2, 53, 4, 8, small, 4, False), (2, 31, 3, 16, small[:3], 5,
                                             False),
            (2, 41, 6, 16, small, 8, True), (1, 5, 6, 16, levels, 8, False),
            (1, 2, 6, 16, ((60, 60), (60, 60)), 4000, False)):
        value, shapes, loc, att = shared_case(g, device, B, Q, shapes, P, H,
                                              D)
        if shift:
            buf = torch.empty(value.numel() + 1, device=device)
            buf[1:].copy_(value.reshape(-1))
            value = buf[1:].view(value.shape)
        case = (value, shapes, loc, att)
        tag = (f"B={B}, Q={Q}, H={H}, D={D}, Lv*P={len(shapes) * P}"
               + (", value +4 bytes" if shift else ""))
        gout = torch.randn((B, Q, H * D), generator=g, device=device)
        inst = {"fwd": shared_instance(case),
                "bwd": shared_instance(case, gout)}
        log_instance(f"msda_shared_fwd ({tag}) instance", inst["fwd"])
        log_instance(f"msda_shared_bwd ({tag}) instance", inst["bwd"])
        check(f"msda_shared_fwd ({tag})", max_err(
            msda.msda_shared_fwd(*case),
            msda.ms_deform_attn_shared_plain(*case)), 1e-5)
        check_grads(f"msda_shared_bwd ({tag})",
                    msda.msda_shared_bwd(*case, gout),
                    msda.msda_shared_bwd_plain(*case, gout))
        off_path[tag] = inst
    res = {}
    for name, rec in (("msda_shared_fwd", fwd), ("msda_shared_bwd", bwd)):
        res[name] = dict(rec["hw"], shape="hw cross-attention, compacted")
        for tag in ("zh", "self"):
            for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                      "per_head_device_ms", "red_bytes",
                      "over_forward_device_ms"):
                if k in rec[tag]:
                    res[name][f"{tag}_{k}"] = rec[tag][k]
        res[name]["zh_per_head_dense_device_ms"] = \
            rec["zh"]["per_head_dense_device_ms"]
        res[name]["max_abs_err"] = max(r["max_abs_err"] for r in rec.values())
        kind = name[len("msda_shared_"):]
        res[name]["instances"] = {
            tag: {k: v for k, v in inst.items() if k.startswith(kind)}
            for tag, inst in instances.items()}
    res["msda_shared_fwd"]["off_path_instances"] = off_path
    if baseline is not None:
        res["msda_shared_fwd"]["baseline_ab"] = shared_ab(
            importlib.import_module(f"{load_baseline(baseline)}.ops.msda"),
            msda, g, device)
    return res


def compaction_op_ms(model, batch):
    """Device ms of the compaction's own ops (``models/encoder.py``'s
    ``visible_first``, ``gather_visible``, ``rows_to_slots``, as the
    compacted cross-attention calls them) on the frame's masks, per plane
    (hw, zh, wz) and layer; the offsets, weights and rows are random, of
    the model's shapes."""
    import torch
    from selfocc_tpu_torch.geometry.projection import point_sampling
    from selfocc_tpu_torch.models.encoder import (gather_visible,
                                                  rows_to_slots,
                                                  visible_first,
                                                  visible_rows)
    enc = model.encoder
    g = torch.Generator(device=batch["imgs"].device).manual_seed(SEED)
    res = {}
    img_shape = tuple(batch["imgs"].shape[2:4])
    attns = enc.layers[0].attentions[1]
    for plane, ref, cap in zip(("hw", "zh", "wz"),
                               (enc.ref_3d_hw, enc.ref_3d_zh, enc.ref_3d_wz),
                               enc.visible_capacity):
        rc, m = point_sampling(ref, batch["lidar2img"], img_shape)
        ref_cams, masks = rc[:, 0], m[:, 0]
        cams, Q, P, _ = ref_cams.shape
        da = getattr(attns, f"attn_{plane}").deformable_attention
        H, L, C = da.num_heads, da.num_levels, da.value_proj.out_features
        M = visible_rows(Q, cap)
        hit = masks.sum(-1) > 0
        offsets = torch.randn((Q, H, L, P, 2), generator=g, device=g.device)
        attn = torch.rand((Q, H, L, P), generator=g, device=g.device)
        out = torch.randn((cams, M, C), generator=g, device=g.device)
        sel = visible_first(hit, M)
        hitf = gather_visible(sel, hit, ref_cams, offsets, attn)[0].float()
        res[plane] = {"Q": Q, "M": M, "visible_max": int((hit.sum(1)).max())}
        for op, fn in (
                ("argsort", lambda: visible_first(hit, M)),
                ("gather", lambda: gather_visible(sel, hit, ref_cams,
                                                  offsets, attn)),
                ("scatter", lambda: rows_to_slots(sel, Q, out, hitf))):
            res[plane][f"{op}_ms"] = device_ms(fn, 5)
            res[plane][f"{op}_events_ms"] = timed(fn, 5)
    log(f"  compaction ops (device ms and events ms per plane and layer): "
        f"{res}")
    return res


def prepare_profile(model, batch):
    """Kernel ms of one warm prepare by ``torch.profiler``: all kernels,
    the MSDA forward kernels (per-head and shared)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model.prepare(batch["imgs"], batch["lidar2img"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prepare(batch["imgs"], batch["lidar2img"])
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    msda_ms = sum(e.self_device_time_total for e in kernels
                  if "msda" in e.key) / 1e3
    return {"kernel_ms": total, "msda_ms": msda_ms,
            "kernels": sum(e.count for e in kernels)}




def lever_frames(device):
    """nuscenes_occ_compact and nuscenes_occ_fast eval frames against
    nuscenes_occ's on the same seeded weights: the compact planes against
    the dense ones (bit for bit, or within 1e-6 of their scale) with every
    overflow 0; each frame through ``eval_depth.evaluate`` (launches
    counted, prepare_s); the fast frame's depths in band and their
    deviation from nuscenes_occ's; MSDA and compaction device ms."""
    import torch
    from selfocc_tpu_torch import eval_depth
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import interp, msda, render_weights
    from selfocc_tpu_torch.utils.runtime import (get_dataset, get_logger,
                                                 to_device)
    logger = get_logger()
    cfgs = {n: get_config(n) for n in ("nuscenes_occ", "nuscenes_occ_compact",
                                       "nuscenes_occ_fast")}
    dense = eval_depth.build_model(cfgs["nuscenes_occ"], SEED, device)
    ds = get_dataset(cfgs["nuscenes_occ"], synthetic=True)
    item = ds[0]
    batch = to_device(item, device)
    res = {}
    with torch.no_grad():
        planes_d = dense.get_representation(batch["imgs"],
                                            batch["lidar2img"])
    fr = eval_depth.evaluate(cfgs["nuscenes_occ"], dense, [item], device, 1,
                             CHUNK, logger)
    depth_d = fr["last_depth"]
    res["dense_frame"] = {k: fr[k] for k in ("prepare_s", "render_s")}
    res["dense_prepare_profile"] = prepare_profile(dense, batch)
    state = dense.state_dict()
    del dense
    torch.cuda.empty_cache()
    for name, wrappers in (
            ("nuscenes_occ_compact", (msda.msda_fwd,)),
            ("nuscenes_occ_fast", (msda.msda_shared_fwd,))):
        cfg = cfgs[name]
        model = eval_depth.build_model(cfg, SEED, device)
        model.load_state_dict(state, strict=True)
        if name == "nuscenes_occ_compact":
            with torch.no_grad():
                planes_c = model.get_representation(batch["imgs"],
                                                    batch["lidar2img"])
            overflow = [int(o) for o in model.encoder.visible_overflow]
            errs = [float((c - d).abs().max() / d.abs().max())
                    for c, d in zip(planes_c, planes_d)]
            equal = all(torch.equal(c, d) for c, d in zip(planes_c, planes_d))
            log(f"  compact planes vs dense: bit-equal {equal}, max error "
                f"over scale {errs}; visible_overflow {overflow}")
            if overflow != [0, 0, 0]:
                raise AssertionError(f"visible_overflow {overflow}")
            if not max(errs) <= 1e-6:
                raise AssertionError(f"compact planes differ: {errs}")
            del planes_c
        # a cold frame, then the frame with its launches counted
        eval_depth.evaluate(cfg, model, [ds[1]], device, 1, CHUNK, logger)
        off_path = (msda.msda_fwd, msda.msda_shared_fwd, msda.msda_bwd,
                    msda.msda_shared_bwd, interp.trilinear_bwd,
                    render_weights.neus_render_bwd)
        reset_counts(off_path + (render_weights.neus_render_fwd,))
        torch.cuda.reset_peak_memory_stats()
        fr = eval_depth.evaluate(cfg, model, [item], device, 1, CHUNK,
                                 logger)
        launches = read_counts(wrappers + (render_weights.neus_render_fwd,),
                               f"{name} eval frame")
        stray = {fn.__name__: fn.launches for fn in off_path
                 if fn.launches and fn not in wrappers}
        if stray:
            raise AssertionError(f"the {name} frame launched {stray}")
        depth = fr["last_depth"]
        depth_in_band(cfg, batch, depth, device)
        fr = {k: fr[k] for k in ("prepare_s", "render_s", "rays")}
        fr.update(launches=launches,
                  max_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
                  prepare_profile=prepare_profile(model, batch))
        if name == "nuscenes_occ_compact":
            fr.update(planes_bit_equal=equal, planes_err=errs,
                      visible_overflow=overflow,
                      compaction_ops=compaction_op_ms(model, batch))
        else:
            dev = (depth - depth_d).abs()
            fr["depth_dev_from_nuscenes_occ"] = {
                "mean_m": float(dev.mean()), "max_m": float(dev.max()),
                "p99_m": float(dev.reshape(-1).kthvalue(
                    int(0.99 * dev.numel())).values)}
            log(f"  fast frame: depths finite and in band; deviation from "
                f"nuscenes_occ's {fr['depth_dev_from_nuscenes_occ']}")
        log(f"  {name}: prepare {fr['prepare_s']:.4f}s render "
            f"{fr['render_s']:.4f}s; prepare kernels "
            f"{fr['prepare_profile']} (nuscenes_occ: "
            f"{res['dense_prepare_profile']})")
        res[name] = fr
        del model
        torch.cuda.empty_cache()
    return res


def compact_grad_parity(device):
    """One ``nuscenes_occ_compact_train`` loss-and-grad at full width against
    ``nuscenes_occ``'s on the same weights, batch and draws (encoder
    dropout 0): the compaction is exact while nothing overflows and the
    2048-ray chunks only recompute, so the losses agree within 1e-5 of
    their size and every parameter gradient within GRAD_RTOL of its
    largest magnitude (the MSDA backward's atomics sum in another order)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.losses import MultiLoss
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.ops import msda
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    from selfocc_tpu_torch.utils.train_lib import (aug_kwargs,
                                                   build_loss_inputs)
    names = ("nuscenes_occ", "nuscenes_occ_compact_train")
    cfgs = {}
    for n in names:
        cfg = get_config(n)
        cfgs[n] = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, encoder=dataclasses.replace(cfg.model.encoder,
                                                   dropout=0.0)))
    model = TPVSegmentor(cfgs[names[0]].model)
    init_weights(model, torch.Generator().manual_seed(SEED))
    state = model.state_dict()
    del model
    batch = to_device(get_dataset(cfgs[names[0]], synthetic=True,
                                  length=1)[0], device)
    results = {}
    for n in names:
        cfg = cfgs[n]
        m = TPVSegmentor(cfg.model)
        m.load_state_dict(state, strict=True)
        m = m.to(device).train()
        gen = torch.Generator(device=device).manual_seed(SEED)
        reset_counts((msda.msda_fwd, msda.msda_bwd))
        out = m(batch["imgs"], batch["lidar2img"],
                batch[cfg.model.head.trans_kw], train=True, generator=gen,
                **aug_kwargs(batch))
        tot, ldict = MultiLoss(cfg.loss_cfgs)(
            build_loss_inputs(cfg, out, batch))
        del out
        tot.backward()
        read_counts((msda.msda_fwd, msda.msda_bwd), f"{n} loss-and-grad")
        overflow = ([int(o) for o in m.encoder.visible_overflow]
                    if m.encoder.visible_overflow is not None else None)
        results[n] = ({k: float(v.detach()) for k, v in ldict.items()},
                      {k: p.grad.detach() for k, p in m.named_parameters()
                       if p.grad is not None}, overflow)
        del m, tot, ldict
        torch.cuda.empty_cache()
    (l_d, g_d, _), (l_c, g_c, overflow) = (results[n] for n in names)
    if overflow != [0, 0, 0]:
        raise AssertionError(f"visible_overflow {overflow}")
    for k in l_d:
        check(f"compact_train loss {k}", abs(l_c[k] - l_d[k]),
              1e-5 * abs(l_d[k]) + 1e-7)
    if set(g_c) != set(g_d):
        raise AssertionError("the two steps' gradients name other tensors")
    worst = 0.0
    for k, ref in g_d.items():
        err = max_err(g_c[k], ref)
        tol = GRAD_RTOL * float(ref.abs().max()) + 1e-7
        if not err <= tol:
            raise AssertionError(f"compact_train grad {k}: {err:.3e} > "
                                 f"{tol:.3e}")
        worst = max(worst, err / tol)
    log(f"  nuscenes_occ_compact_train vs nuscenes_occ, one loss-and-grad "
        f"on the same weights and draws: losses {l_c} vs {l_d}; "
        f"{len(g_d)} gradients within tolerance (worst {worst:.3f} of it)")
    return {"losses_compact": l_c, "losses_dense": l_d,
            "grads": len(g_d), "worst_grad_err_over_tol": worst,
            "visible_overflow": overflow}


def lever_train(device, name, wrappers, off_path=None,
                render_kernels=("neus_render_fwd", "neus_render_bwd"),
                instances=("plane",), required=()):
    """``name`` at full width: a cold step, 3 measured steps (forward /
    backward / optimizer split, peak memory, launches of ``wrappers``, each
    launched; none of ``off_path``, by default the MSDA wrappers not in
    ``wrappers``), a profiled warm step (``render_kernels``: see
    ``profile_step``) and a warm step under
    ``torch.cuda.set_sync_debug_mode("error")``; ``instances``: the
    trilinear kernel instances the steps must launch, ``required`` other
    ``name.instance`` counts (``read_counts``). ``name``: a config's name,
    or the config."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import msda
    from selfocc_tpu_torch.train import build_trainer
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config(name) if isinstance(name, str) else name
    name = cfg.name
    trainer = build_trainer(cfg, SEED, device)
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    sync = torch.cuda.synchronize

    def finite(m):
        check_finite_metrics(m, f"{name} train metrics")

    finite(trainer.step(batch, gen, sync=sync))
    others = off_path if off_path is not None else tuple(
        fn for fn in (msda.msda_fwd, msda.msda_bwd, msda.msda_shared_fwd,
                      msda.msda_shared_bwd) if fn not in wrappers)
    reset_counts(wrappers + others)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = trainer.step(batch, gen, sync=sync)
        wall = time.perf_counter() - t0
        finite(m)
        steps.append(dict(step_s=wall, **m["times"],
                          total=float(m["total"]),
                          grad_norm=float(m["grad_norm"])))
    launches = read_counts(wrappers, f"{name} training steps", instances,
                           required)
    stray = {fn.__name__: fn.launches for fn in others if fn.launches}
    if stray:
        raise AssertionError(f"{name} steps launched {stray}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: sorted(s[k] for s in steps)[1]
           for k in ("step_s", "forward_s", "backward_s", "optimizer_s")}
    prof = profile_step(trainer, batch, gen, med["step_s"], render_kernels)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = trainer.step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    finite(m)
    log(f"  {name}: median step {med['step_s']:.4f}s (forward "
        f"{med['forward_s']:.4f}, backward {med['backward_s']:.4f}, "
        f"optimizer {med['optimizer_s']:.4f}), peak {peak:.2f} GiB; warm "
        f"step under set_sync_debug_mode('error'): no synchronising call")
    spread = [min(s["step_s"] for s in steps),
              max(s["step_s"] for s in steps)]
    res = {"median": med, "step_s_spread": spread, "max_memory_gb": peak,
           "steps": steps, "launches": launches,
           "launches_per_step": {k: v / 3 for k, v in launches.items()},
           "profile": prof, "sync_checked": True}
    del trainer, batch
    torch.cuda.empty_cache()
    return res


def levers_phase(device, baseline=None):
    """The encoder's recipe options at full width: the shared kernels (with
    ``baseline``, another checkout's beside them), the
    compact and fast eval frames, a compact loss-and-grad against the dense
    one, 3 steps each of nuscenes_occ_compact_train
    and nuscenes_occ_fast, and a tiny_fast step on the card against the
    CPU."""
    from selfocc_tpu_torch.ops import msda
    log(f"  card: {card_name()}")
    res = {"kernels": shared_kernel_checks(device, baseline)}
    res["frames"] = lever_frames(device)
    res["compact_grad_parity"] = compact_grad_parity(device)
    res["compact_train"] = lever_train(
        device, "nuscenes_occ_compact_train", (msda.msda_fwd, msda.msda_bwd))
    res["fast_train"] = lever_train(
        device, "nuscenes_occ_fast",
        (msda.msda_shared_fwd, msda.msda_shared_bwd))
    res["tiny_fast_parity"] = train_parity(device, "tiny_fast")
    return res


# ------------------------------------------------------ [bev], [density]
# nuscenes_occ_bev's MSDA calls (B, Q, shapes, P): the single-plane
# self-attention and the image cross-attention of the 257 x 257 plane
BEV_MSDA_CALLS = (("bev_self", (1, 66049, ((257, 257),), 12)),
                  ("bev_cross", (6, 66049, FPN_SHAPES, 8)))
# the density head's weights calls: a training step's 28,800 rays (one
# render, no chunks) and an eval chunk, 256 samples each
DENSITY_WEIGHTS_RAYS = (28800, CHUNK)
DENSITY_THRESH = 0.5     # eval_iou --density --thresh in [density]
# fp32 operations per sample of the alpha-input weights: forward, log,
# exp, the scan and the product (6); backward, those and b, its double
# residual, the recurrence's c and D and the product with T (14)
WEIGHTS_FWD_OPS = 6
WEIGHTS_BWD_OPS = 14



def uniform_sdf_points(cfg, device, gen):
    """The uniform sdf query of a ``return_uniform_sdf`` step
    (``NeuSHead.get_uniform_sdf``): the grid over ``roi_aabb`` at
    ``resolution`` (200 x 200 x 16 = 640,000 points at nuscenes width),
    jittered by uniforms from ``gen`` times the resolution, as fractional
    indices of the decoded volume."""
    import torch
    from selfocc_tpu_torch.geometry.mappings import make_mapping
    from selfocc_tpu_torch.models.heads import uniform_axes_on, uniform_grid
    h = cfg.model.head
    xyz = uniform_grid(*uniform_axes_on(tuple(h.roi_aabb), h.resolution,
                                        device))
    xyz = xyz + torch.rand(xyz.shape, generator=gen,
                           device=device) * h.resolution
    return make_mapping(**h.mapping_args).meter2grid(
        xyz.reshape(-1, 3)).contiguous()


def density_step_points(cfg, device, gen):
    """The density step's volume query: every ray of a synthetic batch
    (6 cameras x 4,800 cellular rays) x 256 jittered samples, one query
    without chunks (7,372,800 points), as fractional indices of the decoded
    volume; the rays and jitter drawn from ``gen``."""
    import torch
    from selfocc_tpu_torch.geometry.projection import rays_from_img2lidar
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    h = cfg.model.head
    head = TPVSegmentor._build_head(h)
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    origin, direction = rays_from_img2lidar(batch[h.trans_kw],
                                            head.ray_sampler(device, gen))
    origin = origin[:, :, None, :].expand(direction.shape).reshape(-1, 3)
    direction = direction.reshape(-1, 3)
    t_rand = torch.rand((origin.shape[0], head.num_samples + 1),
                        generator=gen, device=device)
    return render_grid_points(head, origin, direction, t_rand)


def values_pair_records(g, device, grid_shape, pts, tag, reps):
    """``trilinear_cf_fwd`` and ``trilinear_cf_bwd`` at (N, 3) points of a
    random channel-last (25, H, W, D) volume (``values_fwd_record``,
    ``values_bwd_record``: each against its plain version, timed beside
    ``F.grid_sample`` and its channel-first copy); the backward also for the
    main path's cotangent, where only the sdf channel is live (checked)."""
    import torch
    from selfocc_tpu_torch.ops import interp
    C = 25
    vol = torch.randn(tuple(grid_shape) + (C,), generator=g,
                      device=device).permute(3, 0, 1, 2)
    fwd = values_fwd_record(interp, vol, pts,
                            f"{tag}, C={C}, {pts.shape[0]} points", reps)
    del vol
    torch.cuda.empty_cache()
    return fwd, values_bwd_c25_record(g, device, grid_shape, pts, tag, reps)


def values_bwd_c25_record(g, device, grid_shape, pts, tag, reps):
    """``values_bwd_record`` at C = 25 for a random cotangent, then the
    cotangent with only the sdf channel live (checked)."""
    import torch
    from selfocc_tpu_torch.ops import interp
    vol_shape = (25,) + tuple(grid_shape)
    gv = torch.randn((pts.shape[0], 25), generator=g, device=device)
    bwd = values_bwd_record(interp, vol_shape, pts, gv, tag, reps)
    gv[:, 1:] = 0.0
    ref = interp.trilinear_cf_bwd_plain(torch.zeros(vol_shape, device=device),
                                        pts, gv)
    err = max_err(interp.trilinear_cf_bwd(vol_shape, pts, gv), ref)
    check(f"trilinear_cf_bwd ({tag}, channel 0 live)", err,
          GRAD_RTOL * float(ref.abs().max()) + 1e-7)
    bwd["channel0_live_max_abs_err"] = err
    del gv, ref
    torch.cuda.empty_cache()
    return bwd


def saturated_alpha(g, device, R=512, S=256):
    """Alpha rows where the closed form loses its digits in fp32: a sample
    of alpha exactly 1 mid-ray, runs of 1 - 2^-24, a ray of ones, exact
    zeros, a ray of zeros, a tail of 0.999; every row from the ninth on
    has one saturated sample at a random position, and every ninth row
    from the seventh has its alphas below 0.3 set to exactly 0."""
    import torch
    a = torch.rand((R, S), generator=g, device=device) ** 3
    a[0, 10] = 1.0
    a[1, 5:9] = 1.0 - 2.0 ** -24
    a[2] = 1.0
    a[3, ::3] = 0.0
    a[4] = 0.0
    a[5, 20:] = 0.999
    pos = torch.randint(0, S, (R,), generator=g, device=device)
    rows = torch.arange(8, R, device=device)
    a[rows, pos[8:]] = 1.0
    a[6::9] = torch.where(a[6::9] < 0.3, torch.zeros_like(a[6::9]),
                          a[6::9])
    return a


def weights_kernel_checks(g, device):
    """``neus_weights_fwd`` and ``neus_weights_bwd`` at the density head's
    calls (``DENSITY_WEIGHTS_RAYS`` x 256, alpha with saturated and zero
    samples) against their plain versions, timed (events, device time);
    the backward also against a float64 reference on the rows of
    ``saturated_alpha``, each row within 1e-5 of its reference's largest
    magnitude (the plain version's error there is logged); off-path shapes
    (ragged R and S, S = 1 .. 256) checked, S above
    ``MAX_WEIGHTS_BWD_SAMPLES`` refused ([head] holds the tiles above
    256)."""
    import torch
    from selfocc_tpu_torch.ops import render_weights as rw
    recs = {"neus_weights_fwd": {}, "neus_weights_bwd": {}}
    for R in DENSITY_WEIGHTS_RAYS:
        alpha = torch.rand((R, 256), generator=g, device=device) ** 4
        alpha[::7, 100:110] = 1.0
        alpha[::5, :20] = 0.0
        gw = torch.randn((R, 256), generator=g, device=device)
        w = rw.neus_weights_fwd(alpha)
        err_f = max_err(w, rw.weights_from_alpha_plain(alpha))
        check(f"neus_weights_fwd ({R} x 256)", err_f, 2e-5)
        ga = rw.neus_weights_bwd(alpha, gw)
        ref = rw.weights_grad_plain(alpha, gw)
        err_b = max_err(ga, ref)
        check(f"neus_weights_bwd ({R} x 256)", err_b,
              GRAD_RTOL * float(ref.abs().max()) + 1e-7)
        del w, ga, ref
        n = alpha.numel()
        recs["neus_weights_fwd"][R] = kernel_record(
            err_f, timed(lambda: rw.neus_weights_fwd(alpha), 20),
            timed(lambda: rw.weights_from_alpha_plain(alpha), 10),
            (2 * nbytes(alpha), WEIGHTS_FWD_OPS * n),
            device_ms=device_ms(lambda: rw.neus_weights_fwd(alpha), 20),
            shape=f"{R} x 256")
        recs["neus_weights_bwd"][R] = kernel_record(
            err_b, timed(lambda: rw.neus_weights_bwd(alpha, gw), 20),
            timed(lambda: rw.weights_grad_plain(alpha, gw), 10),
            (3 * nbytes(alpha), WEIGHTS_BWD_OPS * n),
            device_ms=device_ms(lambda: rw.neus_weights_bwd(alpha, gw), 20),
            shape=f"{R} x 256")
        del alpha, gw
        torch.cuda.empty_cache()

    a = saturated_alpha(g, device)
    gw = torch.randn(a.shape, generator=g, device=device)
    a64 = a.double().requires_grad_(True)
    b = 1.0 - a64 + 1e-7
    w64 = a64 * torch.cat([torch.ones_like(b[:, :1]),
                           torch.cumprod(b, -1)[:, :-1]], -1)
    (g64,) = torch.autograd.grad(w64, a64, gw.double())
    scale = g64.abs().amax(-1, keepdim=True).clamp_min(1e-30)

    def rel(x):
        return float(((x.double() - g64).abs() / scale).max())
    rel_k = rel(rw.neus_weights_bwd(a, gw))
    rel_p = rel(rw.weights_grad_plain(a, gw))
    check("neus_weights_bwd vs float64 (saturated rows) / row scale", rel_k,
          1e-5)
    log(f"  weights_grad_plain vs float64 on those rows: {rel_p:.3e} of "
        "the row scale")
    err_w = max_err(rw.neus_weights_fwd(a), w64.detach())
    check("neus_weights_fwd vs float64 (saturated rows)", err_w, 2e-5)
    for R, S in ((37, 19), (5, 256), (64, 16), (33, 100), (7, 255), (3, 1),
                 (9, 130)):
        x = torch.rand((R, S), generator=g, device=device)
        x[:, S // 2] = 1.0
        gx = torch.randn((R, S), generator=g, device=device)
        ref = rw.weights_grad_plain(x, gx)
        check(f"neus_weights_bwd ({R} x {S})",
              max_err(rw.neus_weights_bwd(x, gx), ref),
              GRAD_RTOL * float(ref.abs().max()) + 1e-7)
    S_over = rw.MAX_WEIGHTS_BWD_SAMPLES + 1
    try:
        rw.neus_weights_bwd(torch.rand((2, S_over), device=device),
                            torch.rand((2, S_over), device=device))
    except ValueError:
        pass
    else:
        raise AssertionError(f"neus_weights_bwd took S = {S_over}")
    out = {}
    for name, by_r in recs.items():
        rec = dict(by_r[DENSITY_WEIGHTS_RAYS[0]])
        for k in ("ms", "device_ms", "plain_ms", "bound_ms", "max_abs_err"):
            rec[f"eval_chunk_{k}"] = by_r[CHUNK][k]
        rec["max_abs_err"] = max(r["max_abs_err"] for r in by_r.values())
        out[name] = rec
    out["neus_weights_bwd"].update(float64_row_rel_err=rel_k,
                                   plain_float64_row_rel_err=rel_p)
    out["neus_weights_fwd"]["float64_max_abs_err"] = err_w
    for name, rec in out.items():
        log(f"  {name}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in rec.items()
            if k.endswith("ms") and v is not None))
    return out


def recipe_eval(device, name, frame_wrappers, off_path, density=False,
                occ3d=True):
    """Full-width eval of ``name`` (a config's name, or the config) with
    seeded weights on synthetic data:
    one depth frame through ``eval_depth``'s code path after a cold frame
    (prepare_s, render_s, peak; the launches of ``frame_wrappers``, each
    launched, none of ``off_path``; depths finite and in band; a 4096-ray
    subset against the CPU, ``frame_subset``; the frame's device work under
    ``set_sync_debug_mode("error")``); then one Occ3D occupancy frame
    through ``eval_iou``'s (``--occ3d --sem``, with ``density`` also
    ``--density --thresh 0.5``) after a cold one: prepare_s, query_s,
    peak, the launches of ``trilinear_cf_fwd`` (both instances) and
    ``msda_fwd``, finite scores (``occ3d=False``: the depth frame only)."""
    import numpy as np
    import torch
    from selfocc_tpu_torch import eval_depth, eval_iou
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    from selfocc_tpu_torch.utils.runtime import (get_dataset, get_logger,
                                                 to_device)
    cfg = get_config(name) if isinstance(name, str) else name
    name = cfg.name
    model = eval_depth.build_model(cfg, SEED, device)
    ds = get_dataset(cfg, synthetic=True)
    logger = get_logger()
    cold = eval_depth.evaluate(cfg, model, [ds[1]], device, 1, CHUNK, logger)
    reset_counts(frame_wrappers + off_path)
    torch.cuda.reset_peak_memory_stats()
    r = eval_depth.evaluate(cfg, model, [ds[0]], device, 1, CHUNK, logger)
    launches = read_counts(frame_wrappers, f"{name} eval frame")
    stray = {fn.__name__: fn.launches for fn in off_path if fn.launches}
    if stray:
        raise AssertionError(f"the {name} eval frame launched {stray}")
    frame = {"prepare_s": r["prepare_s"], "render_s": r["render_s"],
             "rays": r["rays"],
             "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
             "launches": launches,
             "cold": {k: cold[k] for k in ("prepare_s", "render_s")}}
    batch = to_device(ds[0], device)
    origin, direction, dn, near, far = depth_in_band(
        cfg, batch, r["last_depth"], device)
    frame.update(frame_device_path(cfg, model, batch))
    frame["subset_err"] = frame_subset(model, batch, origin, direction, dn,
                                       near, far, device,
                                       opacity_normalized=density)
    log(f"  {name} frame: prepare {r['prepare_s']:.4f}s render "
        f"{r['render_s']:.4f}s, peak {frame['max_memory_gb']:.2f} GiB")
    del origin, direction, dn, near, far
    if not occ3d:
        del model
        torch.cuda.empty_cache()
        return {"frame": frame}

    flags = ["--py-config", name, "--synthetic", "--occ3d", "--sem"]
    if density:
        flags += ["--density", "--thresh", str(DENSITY_THRESH)]
    args = eval_iou.parse_args(flags)
    occ_wrappers = (interp.trilinear_cf_fwd, msda.msda_fwd)
    occ_off = (interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
               interp.trilinear_cf_bwd, msda.msda_bwd, rw.neus_render_fwd,
               rw.neus_weights_fwd)
    cold = eval_iou.evaluate(cfg, model, OccItems(ds, 1), device, args,
                             logger)
    reset_counts(occ_wrappers + occ_off)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    o = eval_iou.evaluate(cfg, model, OccItems(ds, 0), device, args, logger)
    occ_launches = read_counts(occ_wrappers, f"{name} Occ3D frame",
                               ("plane", "rows"))
    stray = {fn.__name__: fn.launches for fn in occ_off if fn.launches}
    if stray:
        raise AssertionError(f"the {name} Occ3D frame launched {stray}")
    scores = {k: o[k] for k in ("iou_miou", "iou_iou", "miou_miou",
                                "miou_iou") if k in o}
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"{name} Occ3D: non-finite scores {scores}")
    occ = {"prepare_s": o["prepare_s"], "query_s": o["query_s"],
           "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": occ_launches, "scores": scores,
           "cold": {k: cold[k] for k in ("prepare_s", "query_s")}}
    log(f"  {name} Occ3D frame: prepare {o['prepare_s']:.4f}s query "
        f"{o['query_s']:.4f}s, {scores}")
    del model
    torch.cuda.empty_cache()
    return {"frame": frame, "occ3d": occ}


def bev_phase(device):
    """``nuscenes_occ_bev`` at full width: a ``tiny_bev`` step on the card
    against the CPU; ``msda_fwd`` / ``msda_bwd`` at the BEV self- and
    cross-attention calls; the values-only pair at the 640,000-point
    uniform sdf query (C = 25); 3 measured steps, a profiled one and one
    under the sync check; an eval frame and an Occ3D frame
    (``recipe_eval``)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.geometry.mappings import make_mapping
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    log(f"  card: {card_name()}")
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    res = {"tiny_parity": train_parity(device, "tiny_bev"), "msda": {}}
    for tag, args in BEV_MSDA_CALLS:
        fwd, bwd = msda_records(g, device, tag, args)
        res["msda"][tag] = {"msda_fwd": fwd, "msda_bwd": bwd}
    cfg = get_config("nuscenes_occ_bev")
    m = make_mapping(**cfg.model.head.mapping_args)
    pts = uniform_sdf_points(cfg, device,
                             torch.Generator(device=device).manual_seed(SEED))
    fwd, bwd = values_pair_records(g, device, (m.size_h, m.size_w, m.size_d),
                                   pts, "BEV uniform sdf", 10)
    res["values"] = {"trilinear_cf_fwd": fwd, "trilinear_cf_bwd": bwd}
    del pts
    torch.cuda.empty_cache()
    render = (rw.neus_render_fwd, interp.trilinear_cf_with_grad_fwd)
    res["train"] = lever_train(
        device, "nuscenes_occ_bev",
        render + (rw.neus_render_bwd, interp.trilinear_bwd, msda.msda_fwd,
                  msda.msda_bwd, interp.trilinear_cf_fwd,
                  interp.trilinear_cf_bwd),
        (msda.msda_shared_fwd, msda.msda_shared_bwd, rw.neus_weights_fwd,
         rw.neus_weights_bwd), instances=("rows",),
        required=("trilinear_cf_bwd.walk",))
    res["eval"] = recipe_eval(
        device, "nuscenes_occ_bev", render + (msda.msda_fwd,),
        (msda.msda_bwd, interp.trilinear_bwd, rw.neus_render_bwd,
         rw.neus_weights_fwd, interp.trilinear_cf_fwd))
    return res


def density_phase(device):
    """``nuscenes_occ_density`` at full width: the weights kernels
    (``weights_kernel_checks``); the values-only pair at the training step's
    7,372,800-point query (C = 25); a ``tiny_nerfacc`` step on the card
    against the CPU; 3 measured steps, a profiled one and one under the
    sync check; an eval frame and an ``eval_iou --density`` Occ3D frame
    (``recipe_eval``)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.geometry.mappings import make_mapping
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    log(f"  card: {card_name()}")
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    res = {"kernels": weights_kernel_checks(g, device)}
    cfg = get_config("nuscenes_occ_density")
    m = make_mapping(**cfg.model.head.mapping_args)
    pts = density_step_points(
        cfg, device, torch.Generator(device=device).manual_seed(SEED))
    fwd, bwd = values_pair_records(g, device, (m.size_h, m.size_w, m.size_d),
                                   pts, "density training query", 5)
    res["values"] = {"trilinear_cf_fwd": fwd, "trilinear_cf_bwd": bwd}
    del pts
    torch.cuda.empty_cache()
    res["tiny_parity"] = train_parity(device, "tiny_nerfacc")
    res["train"] = lever_train(
        device, "nuscenes_occ_density",
        (msda.msda_fwd, msda.msda_bwd, interp.trilinear_cf_fwd,
         interp.trilinear_cf_bwd, rw.neus_weights_fwd, rw.neus_weights_bwd),
        (rw.neus_render_fwd, rw.neus_render_bwd,
         interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
         msda.msda_shared_fwd, msda.msda_shared_bwd),
        ("neus_weights_fwd", "neus_weights_bwd"), instances=("rows",),
        required=("trilinear_cf_bwd.walk",))
    res["eval"] = recipe_eval(
        device, "nuscenes_occ_density",
        (msda.msda_fwd, interp.trilinear_cf_fwd, rw.neus_weights_fwd),
        (rw.neus_render_fwd, interp.trilinear_cf_with_grad_fwd,
         msda.msda_bwd, interp.trilinear_cf_bwd, rw.neus_weights_bwd,
         interp.trilinear_bwd), density=True)
    return res


# ------------------------------------------------------------------ [head]
# the importance recipe: nuscenes_occ with 64 importance samples in 4
# rounds (ts per ray before each round, and the merged render's)
HEAD_IMPORTANCE = 64
HEAD_ROUND_TS = (256, 272, 288, 304)
HEAD_SAMPLES = 320
HEAD_SKIP = (64, 64)          # eval_skip_coarse, eval_skip_fine
HOT_POINTS = 128              # csrc/trilinear.cu: kHotPoints
# the tiny parity steps' global_iter: mid-schedule, both schedules live
HEAD_TINY_ITER = 3516 * 5 + 123
# fp32 operations per point of the point-cotangent instances beyond their
# volume's: per in-volume corner the dot with the cotangent (2 C) and the
# weight derivatives and grad0's mixed terms (20)
POINTS_OPS_PER_CORNER = 20


def head_config(base, kind):
    """``base`` (``nuscenes_occ`` or ``tiny``) with one of the head's option
    sets: ``importance`` (``num_samples_importance`` 64 at full width, 8 at
    tiny, ``return_sample_sdf``, ``AdaptiveSparsityLoss`` on the samples'
    sdf), ``options`` (numerical gradients, ``beta_hand_tune``,
    ``anneal_aabb``, ``return_surface_sdf``, ``return_uniform_sdf``;
    ``SparsityLoss`` on the surface sdf and ``HardSparsityLoss`` on the
    uniform sdf) or ``skip`` (eval skipping, 64 + 64)."""
    from selfocc_tpu_torch.configs.experiments import get_config
    cfg = get_config(base)
    tiny = base == "tiny"
    losses, conv = [], {}
    if kind == "importance":
        opts = dict(num_samples_importance=8 if tiny else HEAD_IMPORTANCE,
                    return_sample_sdf=True)
        losses = [dict(type="AdaptiveSparsityLoss", weight=0.1,
                       slack=0.3 if tiny else 4.0)]
        conv = dict(sample_sdf="sdfs")
    elif kind == "options":
        opts = dict(use_numerical_gradients=True, beta_hand_tune=True,
                    anneal_aabb=True, return_surface_sdf=True,
                    return_uniform_sdf=True)
        losses = [dict(type="SparsityLoss", weight=0.01, scale=1.0,
                       input_dict={"density": "surface_sdf"}),
                  dict(type="HardSparsityLoss", weight=0.1, scale=2.0,
                       thresh=0.05, crop=((1, 2), (0, 1), (1, 0)),
                       input_dict={"density": "uniform_sdf"})]
        conv = dict(surface_sdf="surface_sdf", uniform_sdf="uniform_sdf")
    else:
        opts = dict(eval_skip_coarse=HEAD_SKIP[0], eval_skip_fine=HEAD_SKIP[1])
    head = dataclasses.replace(cfg.model.head, **opts)
    return dataclasses.replace(
        cfg, name=f"{base}_{kind}",
        model=dataclasses.replace(cfg.model, head=head),
        loss_cfgs=list(cfg.loss_cfgs) + losses,
        loss_input_convertion=dict(cfg.loss_input_convertion, **conv))


def head_points(device, samples):
    """Ray-major grid points of the first 4096-ray chunk of the [train]
    step (its batch, cellular rays and a seeded jitter) at each count of
    ``samples`` uniform samples a ray -> {count: (4096 * count, 3)}: the
    rounds' sdf queries and the merged render take as many points along
    the same rays (their positions follow the sdf; these stand in for
    them)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.geometry.projection import rays_from_img2lidar
    from selfocc_tpu_torch.models.heads import NeuSHead
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("nuscenes_occ")
    h = cfg.model.head
    head = NeuSHead(roi_aabb=h.roi_aabb, mapping_args=h.mapping_args,
                    near_plane=h.near_plane, far_plane=h.far_plane,
                    ray_sample_mode=h.ray_sample_mode,
                    ray_number=h.ray_number, ray_img_size=h.ray_img_size,
                    embed_dims=h.embed_dims)
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rays = head.ray_sampler(device, gen)
    origin, direction = rays_from_img2lidar(batch[h.trans_kw], rays)
    origin = origin[:, :, None, :].expand(direction.shape).reshape(-1, 3)
    direction = direction.reshape(-1, 3)
    n = h.train_ray_chunk
    out = {}
    for count in samples:
        head.num_samples = count
        t_rand = torch.rand((n, count + 1), generator=gen, device=device)
        out[count] = render_grid_points(head, origin[:n], direction[:n],
                                        t_rand)
    return out


class _StepPointsCaught(Exception):
    """Ends the capturing forward once it holds the first chunk's points."""


def importance_step_points(device, base="nuscenes_occ"):
    """The C = 1 point instances' points in the importance recipe's step:
    one forward of ``nuscenes_occ`` with the importance option set (seeded
    weights, its synthetic batch, draws from a seeded generator, iteration
    0), stopped after the first 4096-ray chunk's calls. Its fractional
    indices (grid space) are caught at the trilinear queries whose points
    need a gradient on a one-channel volume: the up-sample rounds' sdf
    queries after the first (``field.sdf``, the sdf channel read in place at
    row stride 25; 4096 x 272, 288, 304 points, ``trilinear_cf_bwd``'s
    point instance) and the merged 320-sample render's second-derivative
    taps (``second_grad_noncompact``: x + d, x - d along each axis,
    ``trilinear_bwd``'s plane point instance; 4096 x 320 points each) ->
    {"rounds": {count: (4096 * count, 3)}, "taps": [6 x (4096 * 320, 3)]}.
    The points are caught where ``models/field.py`` hands them to the
    trilinear queries."""
    import torch
    from selfocc_tpu_torch.models import field
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = head_config(base, "importance")
    h = cfg.model.head
    model = TPVSegmentor(cfg.model)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(device).train()
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    torch.manual_seed(SEED)     # the encoder's dropout
    got = {"rounds": [], "taps": []}
    want = {"rounds": h.num_upsample_steps - 1, "taps": 6}
    saved = field.trilinear_sample_cf, field.trilinear_sample_cf_with_grad

    def catch(fn, key):
        def query(vol, hwd, *rest):
            if hwd.requires_grad and vol.shape[0] == 1 and \
                    len(got[key]) < want[key]:
                got[key].append(hwd.detach().reshape(-1, 3).clone())
                if all(len(got[k]) == n for k, n in want.items()):
                    raise _StepPointsCaught()
            return fn(vol, hwd, *rest)
        return query

    field.trilinear_sample_cf = catch(saved[0], "rounds")
    field.trilinear_sample_cf_with_grad = catch(saved[1], "taps")
    try:
        model(batch["imgs"], batch["lidar2img"], batch[h.trans_kw],
              train=True, generator=torch.Generator(
                  device=device).manual_seed(SEED))
        raise AssertionError("the importance forward ended before its first "
                             "chunk's point queries were caught")
    except _StepPointsCaught:
        pass
    finally:
        field.trilinear_sample_cf, field.trilinear_sample_cf_with_grad = saved
    del model, batch
    torch.cuda.empty_cache()
    chunk = h.train_ray_chunk
    rounds = {p.shape[0] // chunk: p for p in got["rounds"]}
    if sorted(rounds) != list(HEAD_ROUND_TS[1:]) or any(
            p.shape[0] != chunk * HEAD_SAMPLES for p in got["taps"]):
        raise AssertionError(
            f"importance step points: rounds {sorted(rounds)}, taps "
            f"{[p.shape[0] for p in got['taps']]}")
    return {"rounds": rounds, "taps": got["taps"]}


def point_stats(pts, shape):
    """How a point set meets the C = 1 point instances: its runs (stretches
    of consecutive points in one cell) per warp of 32, the voxels its
    corners touch, the most points in one cell and the cells holding more
    than HOT_POINTS (the C > 1 instances' fp64 threshold, kHotPoints)."""
    import torch
    H, W, D = shape
    base = torch.floor(pts).long()
    inside = ((base >= 0) & (base < torch.tensor(shape, device=pts.device))
              ).all(-1)
    key = torch.where(inside, (base[:, 0] * W + base[:, 1]) * D + base[:, 2],
                      -1 - torch.arange(pts.shape[0], device=pts.device))
    n = pts.shape[0]
    k = torch.cat([key, key.new_full(((-n) % 32,), -2 - n)]).view(-1, 32)
    runs = 1 + (k[:, 1:] != k[:, :-1]).sum(1)
    counts = torch.bincount(key[inside], minlength=H * W * D)
    return {"points": n, "runs_per_warp_mean": float(runs.float().mean()),
            "runs_per_warp_median": float(runs.float().median()),
            "warps_of_one_run": float((runs == 1).float().mean()),
            "voxels_touched": corner_voxels(pts, shape),
            "cells": int((counts > 0).sum()),
            "max_points_in_a_cell": int(counts.max()),
            "cells_over_hot_points": int((counts > HOT_POINTS).sum())}


def call_kernels(fn, reps=5):
    """The device kernels a warm call of ``fn()`` launches, by short name
    -> [launches a call, device ms a call], from torch.profiler over
    ``reps`` calls: what the launcher took (fill kernels included; the
    profile shows no memsets). A profile that recorded no device kernel
    (seen often for profiles of a call or two) is taken again, at most
    three times; an empty dict if all three were empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
                m = re.search(r"(\w+_kernel)(<[\w, ]*>)?", e.key)
                name = m.group(1) + (m.group(2) or "") if m else e.key[:40]
                t = out.setdefault(name, [0, 0.0])
                t[0] += e.count / reps
                t[1] += e.self_device_time_total / 1e3 / reps
        if out:
            break
        log(f"    call_kernels: profile {attempt + 1} recorded no kernel")
    return out


def points_design(census):
    """The backward kernels among ``call_kernels``' names: the design the
    wrapper's launcher took (fills, pre-passes and folds left out)."""
    return ", ".join(k for k in census
                     if re.match(r"(trilinear|values)_bwd_\w+_kernel", k))


def head_ab(base, this, vol25, sets, sets_cf, g):
    """Median ms (events, device) of the two checkouts' C = 1 point
    instances, in turns: baseline, this, this, baseline. Each gets the same
    inputs: ``trilinear_bwd``'s plane point instance (both cotangents) on
    ``sets`` (the uniform stand-ins, the importance step's first tap) and
    ``trilinear_cf_bwd``'s (the sdf channel of ``vol25`` read at row stride
    25) on ``sets_cf`` (the uniform rounds, the step's own)."""
    import torch
    sdf_view = this.channel0_view(vol25)
    cots = {}
    for tag, (vol, p) in sets.items():
        cots[tag] = (torch.randn((p.shape[0], 1), generator=g,
                                 device=p.device),
                     torch.randn((p.shape[0], 3), generator=g,
                                 device=p.device))
    gv_cf = {tag: torch.randn((p.shape[0], 1), generator=g, device=p.device)
             for tag, p in sets_cf.items()}

    def calls(mod):
        out = {f"bwd_points_{tag}": (
            lambda v=vol, p=p, c=cots[tag]: mod.trilinear_bwd(
                v, p, c[0], c[1], points=True))
            for tag, (vol, p) in sets.items()}
        out.update({f"cf_bwd_points_{tag}": (
            lambda p=p, c=gv_cf[tag]: mod.trilinear_cf_bwd(
                tuple(sdf_view.shape), p, c, sdf_view))
            for tag, p in sets_cf.items()})
        return out

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


WEIGHTS_AB_SHAPES = ((4096, 320), (4096, 271), (4096, 287), (4096, 303),
                     (CHUNK, 320))   # the merged render, rounds, eval chunk


def weights_ab(base, this, g, device):
    """Median ms (events, device) of the two checkouts' ``neus_weights_bwd``
    above 256 samples, in turns: baseline, this, this, baseline, each on
    the same inputs at ``WEIGHTS_AB_SHAPES`` (alpha with saturated and zero
    samples, as ``head_kernel_checks``'), with each side's kernels a call
    (``call_kernels``) on the first turn."""
    import torch
    inputs = {}
    for R, S in WEIGHTS_AB_SHAPES:
        alpha = torch.rand((R, S), generator=g, device=device) ** 4
        alpha[::7, 100:110] = 1.0
        alpha[::5, :20] = 0.0
        inputs[f"{R}x{S}"] = (alpha, torch.randn((R, S), generator=g,
                                                 device=device))
    runs = {"baseline": [], "this": []}
    census = {}
    for side in ("baseline", "this", "this", "baseline"):
        mod = base if side == "baseline" else this
        fns = {k: (lambda a=a, gw=gw: mod.neus_weights_bwd(a, gw))
               for k, (a, gw) in inputs.items()}
        if side not in census:
            census[side] = {k: call_kernels(f) for k, f in fns.items()}
        runs[side].append({k: (timed(f, 20), device_ms(f, 20))
                           for k, f in fns.items()})
    out = {side: {k: sorted(r[k] for r in rs) for k in rs[0]}
           for side, rs in runs.items()}
    for k in out["this"]:
        log(f"  A/B neus_weights_bwd {k} (event ms, device ms): baseline "
            f"{out['baseline'][k]}, this {out['this'][k]}")
    for side, by in census.items():
        log(f"  A/B neus_weights_bwd kernels a call, {side}: {by}")
    out["kernels_per_call"] = census
    return out


def grid_sample_points_bwd_of(vol_cf, pts, grad_vals, padding="zeros"):
    """``F.grid_sample``'s backward with a grid that needs a gradient: the
    volume's and the grid's cotangents of the values ``grid_sample_of``
    computes with ``padding``, on its channel-first copy (made once,
    outside the call)."""
    import torch
    C, H, W, D = vol_cf.shape
    x = vol_cf.contiguous()[None]
    grid = torch.stack([2 * pts[:, 2] / (D - 1) - 1,
                        2 * pts[:, 1] / (W - 1) - 1,
                        2 * pts[:, 0] / (H - 1) - 1], -1).view(1, 1, 1, -1, 3)
    gout = grad_vals.T.contiguous().view(1, C, 1, 1, -1)

    def call():
        return torch.ops.aten.grid_sampler_3d_backward(
            gout, x, grid, 0, {"zeros": 0, "border": 1}[padding], True,
            [True, True])
    return call


def head_kernel_checks(g, device, baseline=None):
    """The three kernels' new instances at the importance recipe's shapes
    against their plain versions, timed (events, device time), beside the
    plain versions and ``F.grid_sample``'s backward with a grid that needs a
    gradient: ``neus_weights_bwd`` at the merged render (4096 x 320, a
    training chunk, and 32768 x 320, an eval chunk) and the up-sample rounds
    (4096 x 255 .. 303; above 256 the staged instances), each call with
    the kernels it launched, also against float64 on saturated rows (S =
    320 and 271) and at off-path S; ``trilinear_bwd``'s point instance,
    rows (C = 25) and plane (C = 1), at 4096 x 320 points;
    ``trilinear_cf_bwd``'s at 4096 x 256 .. 304 points (the rounds' sdf
    queries, C = 1 read at row stride 25 in place) and at the six taps of
    4096 x 320 points. The point instances' two cotangents also against
    their plain versions in float64 (``float64_check``). Each also at
    off-path inputs. The C = 1 point instances also at the importance
    step's own points (``importance_step_points``), each point set with its
    runs and crowding (``point_stats``), each call with the kernels it
    launched (``call_kernels``). With ``baseline`` (a checkout of another
    commit), that checkout's C = 1 point instances in turns with this one's
    on both point sets (``head_ab``) and its ``neus_weights_bwd`` above 256
    samples (``weights_ab``)."""
    import importlib
    import torch
    from selfocc_tpu_torch.ops import interp
    from selfocc_tpu_torch.ops import render_weights as rw
    recs = {"neus_weights_bwd": {}, "trilinear_bwd": {},
            "trilinear_cf_bwd": {}}

    # neus_weights_bwd
    shapes = [(4096, HEAD_SAMPLES), (CHUNK, HEAD_SAMPLES)] + [
        (4096, s - 1) for s in HEAD_ROUND_TS]
    for R, S in shapes:
        alpha = torch.rand((R, S), generator=g, device=device) ** 4
        alpha[::7, 100:110] = 1.0
        alpha[::5, :20] = 0.0
        gw = torch.randn((R, S), generator=g, device=device)
        got = rw.neus_weights_bwd(alpha, gw)
        ref = rw.weights_grad_plain(alpha, gw)
        err = max_err(got, ref)
        check(f"neus_weights_bwd ({R} x {S})", err,
              GRAD_RTOL * float(ref.abs().max()) + 1e-7)
        del got, ref
        n = alpha.numel()
        census = call_kernels(lambda: rw.neus_weights_bwd(alpha, gw))
        log(f"  neus_weights_bwd ({R} x {S}): kernels a call {census}")
        recs["neus_weights_bwd"][f"{R}x{S}"] = kernel_record(
            err, timed(lambda: rw.neus_weights_bwd(alpha, gw), 20),
            timed(lambda: rw.weights_grad_plain(alpha, gw), 5),
            (3 * nbytes(alpha), WEIGHTS_BWD_OPS * n),
            device_ms=device_ms(lambda: rw.neus_weights_bwd(alpha, gw), 20),
            kernels_per_call=census, shape=f"{R} x {S}", tiled=S > 256)
        del alpha, gw
        torch.cuda.empty_cache()
    # float64 on saturated rows: at S = 320 (float4 rows) and at 271 (no
    # row 16-byte aligned: scalar staging)
    for S in (HEAD_SAMPLES, HEAD_ROUND_TS[1] - 1):
        a = saturated_alpha(g, device, S=S)
        gw = torch.randn(a.shape, generator=g, device=device)
        a64 = a.double().requires_grad_(True)
        b = 1.0 - a64 + 1e-7
        w64 = a64 * torch.cat([torch.ones_like(b[:, :1]),
                               torch.cumprod(b, -1)[:, :-1]], -1)
        (g64,) = torch.autograd.grad(w64, a64, gw.double())
        scale = g64.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        rel = float(((rw.neus_weights_bwd(a, gw).double() - g64).abs()
                     / scale).max())
        check(f"neus_weights_bwd vs float64 (saturated rows, S = {S}) / "
              "row scale", rel, 1e-5)
        key = "float64_row_rel_err" + ("" if S == HEAD_SAMPLES else f"_{S}")
        recs["neus_weights_bwd"][key] = rel
    if baseline is not None:
        recs["weights_ab"] = weights_ab(
            importlib.import_module(
                f"{load_baseline(baseline)}.ops.render_weights"), rw, g,
            device)
    for R, S in ((37, 257), (5, 512), (9, 300), (3, 1000), (64, 8192)):
        x = torch.rand((R, S), generator=g, device=device)
        x[:, S // 2] = 1.0
        gx = torch.randn((R, S), generator=g, device=device)
        ref = rw.weights_grad_plain(x, gx)
        check(f"neus_weights_bwd ({R} x {S})",
              max_err(rw.neus_weights_bwd(x, gx), ref),
              GRAD_RTOL * float(ref.abs().max()) + 1e-7)

    # trilinear_bwd, point instance: rows (C = 25) and plane (C = 1) on the
    # uniform stand-ins; the plane also at the importance step's own taps
    shape = (257, 257, 25)
    vol25 = torch.randn(shape + (25,), generator=g,
                        device=device).permute(3, 0, 1, 2)
    vol1 = interp.first_channel(vol25)
    round_pts = head_points(device, HEAD_ROUND_TS + (HEAD_SAMPLES,))
    pts = round_pts.pop(HEAD_SAMPLES)
    step = importance_step_points(device)
    sets = {"plane": (vol1, pts), "plane_step": (vol1, step["taps"][0])}
    sets_cf = {str(ts): p for ts, p in round_pts.items()}
    sets_cf.update({f"{ts}_step": p for ts, p in step["rounds"].items()})
    for tag, (vol, p) in [("rows", (vol25, pts))] + list(sets.items()):
        C, n = vol.shape[0], p.shape[0]
        gv = torch.randn((n, C), generator=g, device=device)
        gg = torch.randn((n, 3), generator=g, device=device)
        got = interp.trilinear_bwd(vol, p, gv, gg, points=True)
        ref = interp.trilinear_bwd_plain(vol, p, gv, gg, points=True)
        err = check_grads(f"trilinear_bwd points ({tag}, C = {C})", got, ref)
        f64 = float64_check(
            f"trilinear_bwd points ({tag}, C = {C})", got, ref,
            interp.trilinear_bwd_plain(vol.double(), p.double(),
                                       gv.double(), gg.double(),
                                       points=True))
        plain_vol = interp.trilinear_bwd(vol, p, gv, gg)
        check(f"trilinear_bwd points ({tag}): volume cotangent as the "
              "point-free instance's", max_err(got[0], plain_vol),
              GRAD_RTOL * float(plain_vol.abs().max()) + 1e-7)
        del got, ref, plain_vol
        torch.cuda.empty_cache()
        lib = grid_sample_points_bwd_of(vol, p, gv)

        def kern():
            return interp.trilinear_bwd(vol, p, gv, gg, points=True)
        census = call_kernels(kern)
        extra = {}
        if C == 1:
            extra["points_set"] = point_stats(p, shape)
            log(f"  trilinear_bwd points ({tag}): {extra['points_set']}; "
                f"kernels a call {census}")
        recs["trilinear_bwd"][tag] = kernel_record(
            err, timed(kern, 20),
            timed(lambda: interp.trilinear_bwd_plain(vol, p, gv, gg,
                                                     points=True), 3),
            (nbytes(p, gv, gg, vol) + corner_voxels(p, shape) * C * 4
             + n * 12, n * 8 * (9 + 4 * C + POINTS_OPS_PER_CORNER)),
            library_ms=timed(lib, 10), library="F.grid_sample backward, "
            "grid with a gradient (values only)",
            library_device_ms=device_ms(lib, 10),
            device_ms=device_ms(kern, 20),
            point_free_device_ms=device_ms(
                lambda: interp.trilinear_bwd(vol, p, gv, gg), 20),
            launches_per_call=sum(c for c, _ in census.values()),
            kernels_per_call=census,
            design=points_design(census),
            shape=f"C={C}, {n} points", points=n, C=C, float64=f64, **extra)
        del gv, gg, lib
        torch.cuda.empty_cache()

    # trilinear_cf_bwd, point instance: the rounds' sdf queries read
    # channel 0 of the volume in place (row stride 25), on the uniform
    # stand-ins and at the importance step's own rounds
    sdf_view = interp.channel0_view(vol25)
    for ts in list(sets_cf) + ["taps"]:
        p = (sets_cf[ts] if ts != "taps" else
             (pts[:, None, :] + 0.05 * torch.randn(
                 (pts.shape[0], 6, 3), generator=g,
                 device=device)).reshape(-1, 3))
        vol = sdf_view if ts != "taps" else vol1
        m = p.shape[0]
        gv = torch.randn((m, 1), generator=g, device=device)
        got = interp.trilinear_cf_bwd(tuple(vol.shape), p, gv, vol)
        ref = interp.trilinear_cf_bwd_plain(vol, p, gv, points=True)
        tag = f"{ts} a ray" if ts != "taps" else "six taps"
        err = check_grads(f"trilinear_cf_bwd points ({tag})", got, ref)
        f64 = float64_check(
            f"trilinear_cf_bwd points ({tag})", got, ref,
            interp.trilinear_cf_bwd_plain(vol.double(), p.double(),
                                          gv.double(), points=True))
        del got, ref
        lib = grid_sample_points_bwd_of(vol, p, gv)

        def kern():
            return interp.trilinear_cf_bwd(tuple(vol.shape), p, gv, vol)
        census = call_kernels(kern)
        stats = point_stats(p, shape)
        log(f"  trilinear_cf_bwd points ({tag}): {stats}; kernels a call "
            f"{census}")
        recs["trilinear_cf_bwd"][ts] = kernel_record(
            err, timed(kern, 20),
            timed(lambda: interp.trilinear_cf_bwd_plain(vol, p, gv,
                                                        points=True), 3),
            (nbytes(p, gv) + 2 * shape[0] * shape[1] * shape[2] * 4 + m * 12,
             m * (20 + 16 + 8 * (2 + POINTS_OPS_PER_CORNER))),
            library_ms=timed(lib, 10), library="F.grid_sample backward, "
            "grid with a gradient",
            library_device_ms=device_ms(lib, 10),
            device_ms=device_ms(kern, 20),
            point_free_device_ms=device_ms(
                lambda: interp.trilinear_cf_bwd(tuple(vol.shape), p, gv),
                20),
            launches_per_call=sum(c for c, _ in census.values()),
            kernels_per_call=census,
            design=points_design(census), points_set=stats,
            shape=f"C=1, {m} points ({tag})", points=m, C=1, float64=f64)
        del p, gv, lib
        torch.cuda.empty_cache()
    if baseline is not None:
        recs["head_ab"] = head_ab(
            importlib.import_module(f"{load_baseline(baseline)}.ops.interp"),
            interp, vol25, sets, sets_cf, g)
    del sets, sets_cf, step, round_pts

    # off-path: every instance on a small volume, rays in and out of it,
    # knots, a ragged count, a row stride above C, each cotangent alone
    small = (13, 17, 9)
    sh = torch.tensor(small, dtype=torch.float32, device=device)
    uni = torch.rand((5003, 3), generator=g, device=device) * (sh + 3) - 1.5
    uni[::8] = torch.round(uni[::8])
    for C in (1, 3, 25, 33):
        vol = torch.randn(small + (C + 2,), generator=g,
                          device=device)[..., :C].permute(3, 0, 1, 2)
        for cots in (("vals", "grad0"), ("vals",), ("grad0",)):
            gv = (torch.randn((5003, C), generator=g, device=device)
                  if "vals" in cots else None)
            gg = (torch.randn((5003, 3), generator=g, device=device)
                  if "grad0" in cots else None)
            kvol = interp.kernel_volume(vol)
            check_grads(f"trilinear_bwd points (C={C}, {cots})",
                        interp.trilinear_bwd(kvol, uni, gv, gg, points=True),
                        interp.trilinear_bwd_plain(kvol, uni, gv, gg,
                                                   points=True))
        gv = torch.randn((5003, C), generator=g, device=device)
        check_grads(f"trilinear_cf_bwd points (C={C}, row stride {C + 2})",
                    interp.trilinear_cf_bwd(tuple(vol.shape), uni, gv, vol),
                    interp.trilinear_cf_bwd_plain(vol, uni, gv, points=True))
    del vol25, vol1, sdf_view, pts
    torch.cuda.empty_cache()
    for name, by in recs.items():
        for k, r in by.items():
            if isinstance(r, dict):
                log(f"  {name} {k}: " + ", ".join(
                    f"{x} {v:.4g}" for x, v in r.items()
                    if x.endswith("ms") and v is not None))
    return recs


def head_eval(device, cfg, model, ds, fused):
    """One eval frame of ``cfg`` through ``eval_depth``'s code path after a
    cold one: prepare_s, render_s, rays/s, peak, launches (``fused``: the
    uniform samples' fused render; else the alpha-input render's kernels
    and the sdf-only queries that place the samples, and no fused render),
    and the depth maps."""
    import torch
    from selfocc_tpu_torch import eval_depth
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    from selfocc_tpu_torch.utils.runtime import get_logger
    logger = get_logger()
    eval_depth.evaluate(cfg, model, [ds[1]], device, 1, CHUNK, logger)
    wrappers = (msda.msda_fwd, interp.trilinear_cf_with_grad_fwd)
    alpha_route = (interp.trilinear_cf_fwd, rw.neus_weights_fwd)
    wrappers += (rw.neus_render_fwd,) if fused else alpha_route
    off = (rw.neus_render_bwd, rw.neus_weights_bwd, interp.trilinear_bwd,
           interp.trilinear_cf_bwd, msda.msda_bwd)
    off += alpha_route if fused else (rw.neus_render_fwd,)
    reset_counts(wrappers + off)
    torch.cuda.reset_peak_memory_stats()
    r = eval_depth.evaluate(cfg, model, [ds[0]], device, 1, CHUNK, logger)
    launches = read_counts(wrappers, f"{cfg.name} eval frame")
    stray = {fn.__name__: fn.launches for fn in off if fn.launches}
    if stray:
        raise AssertionError(f"the {cfg.name} eval frame launched {stray}")
    depth = torch.as_tensor(r["last_depth"])
    if not bool(torch.isfinite(depth).all()):
        raise AssertionError(f"{cfg.name} eval frame: non-finite depth")
    res = {"prepare_s": r["prepare_s"], "render_s": r["render_s"],
           "rays": r["rays"], "rays_per_s": r["rays"] / r["render_s"],
           "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches}
    log(f"  {cfg.name} frame: prepare {r['prepare_s']:.4f}s render "
        f"{r['render_s']:.4f}s ({res['rays_per_s']:.0f} rays/s), peak "
        f"{res['max_memory_gb']:.2f} GiB")
    return res, depth


def head_split_parity(device):
    """``two_split`` at tiny width, each option set's head: on the card,
    the split outputs are the unsplit forward's camera halves exactly (same
    weights and draws); with the options set (uniform samples), card
    against CPU, the split depth, opacity and ts within 1e-5 of their
    scale. (The importance rounds place samples in bins of little
    probability with the cdf's rounding times the bin's width over its
    probability, so its forward is held across devices by its losses, in
    ``train_parity``.) The tiny losses read every camera, so no loss is
    taken."""
    import torch
    from selfocc_tpu_torch.models.heads import split_cams_for_losses
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    worst = {}
    for kind in ("importance", "options"):
        cfg = head_config("tiny", kind)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, encoder=dataclasses.replace(cfg.model.encoder,
                                                   dropout=0.0)))
        h = cfg.model.head
        R = cfg.num_cams * h.ray_number[0] * h.ray_number[1]
        gen = torch.Generator().manual_seed(SEED)
        draws = {"cellular": torch.rand(4, generator=gen),
                 "t_rand": torch.rand((R, h.num_samples + 1), generator=gen),
                 "bkgd": torch.rand((R, 3), generator=gen)}
        model = TPVSegmentor(cfg.model)
        init_weights(model, torch.Generator().manual_seed(SEED))
        item = get_dataset(cfg, synthetic=True)[0]
        outs = {}
        for dev, split in ((device, True), (device, False),
                           (torch.device("cpu"), True)):
            m = copy.deepcopy(model).to(dev).train()
            m.head.train_ray_chunk = PARITY_RAY_CHUNK if dev == device else 0
            m.head.two_split = split
            batch = to_device(item, dev)
            with torch.no_grad():
                outs[(dev.type, split)] = m(
                    batch["imgs"], batch["lidar2img"], batch[h.trans_kw],
                    train=True, draws=draws, global_iter=HEAD_TINY_ITER)
        split = outs[(device.type, True)]
        ref = split_cams_for_losses(outs[(device.type, False)],
                                    cfg.num_cams)
        keys = [k for k in ("ms_depths", "ms_accs", "ms_fars", "ms_colors",
                            "sem", "weights", "ts", "deltas", "sample_sdf",
                            "surface_sdf") if k in ref]
        for k in keys:
            a, b = split[k], ref[k]
            a, b = (a[0], b[0]) if isinstance(a, list) else (a, b)
            if a.shape[1] != cfg.num_cams // 2 or not torch.equal(a, b):
                raise AssertionError(f"two_split {kind} {k}: not the "
                                     "unsplit halves")
        log(f"  two_split {kind}: {len(keys)} outputs the unsplit halves on "
            "the card")
        if kind == "options":
            # depth sums weights times positions: held at the positions'
            # scale (the annealed band leaves the tiny rays nearly empty)
            ts_scale = float(outs[("cpu", True)]["ts"].abs().max())
            for k in ("ms_depths", "ms_accs", "ts"):
                a, b = split[k], outs[("cpu", True)][k]
                a, b = (a[0], b[0]) if isinstance(a, list) else (a, b)
                worst[k] = max_err(a.cpu(), b)
                scale = ts_scale if k == "ms_depths" else float(
                    b.abs().max())
                check(f"two_split options {k} card vs CPU", worst[k],
                      1e-5 * scale + 1e-7)
    return worst


def head_phase(device, baseline=None):
    """The NeuS head's options at full width (``nuscenes_occ``'s widths and
    depth, seeded weights, synthetic data): the new kernel instances
    against their plain versions (``head_kernel_checks``); (a) 3 steps of
    the importance recipe (64 importance samples, ``return_sample_sdf``,
    ``AdaptiveSparsityLoss``), profiled and sync-checked, and its eval
    frame; (b) 3 steps of the options recipe (numerical gradients,
    ``beta_hand_tune``, ``anneal_aabb``, the surface and uniform sdf with
    ``SparsityLoss`` and ``HardSparsityLoss``); (c) a 64 + 64 eval-skip
    frame and its depth's deviation from the uniform frame's (another
    function: reported, not bounded); (e) each option set's tiny step on
    the card against the CPU, and ``two_split``'s outputs."""
    import torch
    from selfocc_tpu_torch import eval_depth
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    from selfocc_tpu_torch.utils.runtime import get_dataset
    log(f"  card: {card_name()}")
    t0 = time.time()

    def lap(what):
        nonlocal t0
        log(f"  [head] {what}: {time.time() - t0:.1f}s")
        t0 = time.time()

    g = torch.Generator(device=device).manual_seed(SEED + 5)
    res = {"kernels": head_kernel_checks(g, device, baseline)}
    lap("kernel checks")
    if baseline is not None:
        res["head_ab"] = res["kernels"].pop("head_ab")
        res["weights_ab"] = res["kernels"].pop("weights_ab")
    res["tiny_parity"] = {
        kind: train_parity(device, cfg=head_config("tiny", kind),
                           global_iter=HEAD_TINY_ITER, baseline=True)
        for kind in ("importance", "options")}
    res["tiny_parity"]["two_split"] = head_split_parity(device)
    lap("tiny steps")
    shared = (msda.msda_shared_fwd, msda.msda_shared_bwd)
    imp = head_config("nuscenes_occ", "importance")
    res["importance_train"] = lever_train(
        device, imp,
        (msda.msda_fwd, msda.msda_bwd, interp.trilinear_cf_with_grad_fwd,
         interp.trilinear_bwd, interp.trilinear_cf_fwd,
         interp.trilinear_cf_bwd, rw.neus_weights_fwd, rw.neus_weights_bwd),
        (rw.neus_render_fwd, rw.neus_render_bwd) + shared,
        ("neus_weights_fwd", "neus_weights_bwd"), instances=(),
        required=("trilinear_bwd.rows", "trilinear_bwd.plane",
                  "trilinear_bwd.points", "trilinear_bwd.points_walk",
                  "trilinear_cf_bwd.points", "trilinear_cf_fwd.plane",
                  "neus_weights_bwd.tiled"))
    lap("importance steps")
    opt = head_config("nuscenes_occ", "options")
    res["options_train"] = lever_train(
        device, opt,
        (msda.msda_fwd, msda.msda_bwd, interp.trilinear_cf_with_grad_fwd,
         interp.trilinear_bwd, interp.trilinear_cf_fwd,
         interp.trilinear_cf_bwd, rw.neus_render_fwd, rw.neus_render_bwd),
        (rw.neus_weights_fwd, rw.neus_weights_bwd) + shared, instances=(),
        required=("trilinear_cf_fwd.rows", "trilinear_cf_fwd.plane",
                  "trilinear_cf_bwd.rows", "trilinear_cf_bwd.walk",
                  "trilinear_cf_bwd.plane", "trilinear_cf_bwd.points"))
    lap("options steps")
    # eval frames on one set of seeded weights: uniform, importance, skip
    frames, depths = {}, {}
    base = eval_depth.build_model(head_config("nuscenes_occ", "skip"), SEED,
                                  device)
    ds = get_dataset(imp, synthetic=True)
    for kind in ("uniform", "importance", "skip"):
        h = base.head
        h.num_samples_importance = HEAD_IMPORTANCE if kind == "importance" \
            else 0
        h.eval_skip_coarse, h.eval_skip_fine = (HEAD_SKIP if kind == "skip"
                                                else (0, 0))
        cfg = dataclasses.replace(imp, name=f"nuscenes_occ_{kind}")
        frames[kind], depths[kind] = head_eval(device, cfg, base, ds,
                                               fused=kind == "uniform")
    dev = (depths["skip"] - depths["uniform"]).abs()
    frames["skip"]["depth_deviation_from_uniform"] = {
        "max": float(dev.max()), "mean": float(dev.mean()),
        "median": float(dev.median())}
    dev = (depths["importance"] - depths["uniform"]).abs()
    frames["importance"]["depth_deviation_from_uniform"] = {
        "max": float(dev.max()), "mean": float(dev.mean()),
        "median": float(dev.median())}
    log(f"  skip frame depth against the uniform frame: "
        f"{frames['skip']['depth_deviation_from_uniform']}")
    res["frames"] = frames
    lap("eval frames")
    del base
    torch.cuda.empty_cache()
    return res


# [variants]: nuscenes_occ with the model options no shipped config sets.
# The grid is NonLinearMapping at make_mapping's defaults (the reference
# GridMeterMapping's: 128 inner cells over 51.2 m and 32 growing ones to
# 80 m a side, z from -4 m over 20 + 10 cells to 12 m): 321 x 321 x 31.
VARIANT_MAPPING = {"nonlinear_mode": "linear_upscale"}
VARIANT_PC = (-80.0, -80.0, -4.0, 80.0, 80.0, 12.0)
# the tiny twin's grid: 17 x 17 x 9, 6 inner cells a side and 2 growing
TINY_VARIANT_MAPPING = dict(
    nonlinear_mode="linear_upscale", h_size=[6, 2], h_range=[6.0, 4.0],
    h_half=False, w_size=[6, 2], w_range=[6.0, 4.0], w_half=False,
    d_size=[6, 2], d_range=[-1.0, 1.4, 3.0])
# train.main's run in [train]: micro-step 5 is the one --profile traces; a
# full-size synthetic batch takes ~6.3 s on the host (12 steps until PR 19)
TRAIN_DRIVER_STEPS = 6
PORT_KERNEL_NAMES = re.compile(r"msda_|trilinear|values_|neus_render_")


def variant_config(base="nuscenes_occ"):
    """``base`` with every model option the port added last on at once, as
    a user's variant config is built (``dataclasses.replace`` of a shipped
    config): ``TPVPositionLifter`` (``tot_range`` the point-cloud range,
    ``num_freqs`` the encoder's ``pos_num_freqs``, the same mapping),
    ``camera_aware``, ``multi_plane_ffn_norm``, ``ray_sample_mode
    "random"`` and ``NonLinearMapping``; ``nuscenes_occ`` at
    ``VARIANT_MAPPING`` over ``VARIANT_PC`` (the pc range and the
    ``roi_aabb``), ``tiny`` at ``TINY_VARIANT_MAPPING``."""
    from selfocc_tpu_torch.configs.experiments import get_config
    cfg = get_config(base)
    if base == "nuscenes_occ":
        mapping, pc = dict(VARIANT_MAPPING), VARIANT_PC
    else:
        mapping, pc = dict(TINY_VARIANT_MAPPING), \
            tuple(cfg.model.encoder.pc_range)
    m = cfg.model
    enc = dataclasses.replace(m.encoder, mapping_args=mapping, pc_range=pc,
                              camera_aware=True, multi_plane_ffn_norm=True)
    head = dataclasses.replace(m.head, mapping_args=mapping, roi_aabb=pc,
                               ray_sample_mode="random")
    model = dataclasses.replace(
        m, encoder=enc, head=head, lifter_type="TPVPositionLifter",
        lifter_args=dict(tot_range=pc, num_freqs=tuple(enc.pos_num_freqs),
                         mapping_args=mapping))
    return dataclasses.replace(cfg, name=f"{base}_variants", model=model)


def load_tool(name):
    """``selfocc_tpu_torch/tools/<name>.py`` of this checkout as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "selfocc_tpu_torch", "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flow_head_setup(device):
    """The BEV flow head at ``nuscenes_occ_bev``'s width with seeded
    weights, in training mode: (the recipe's head config, the head on the
    card, a copy on the CPU, three random (1, 257 x 257, 96) planes, a
    synthetic batch's ``img2lidar``, the card's generator)."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.segmentor import TPVSegmentor
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("nuscenes_occ_bev")
    h = cfg.model.head
    flow_cfg = dataclasses.make_dataclass(
        "FlowHeadConfig", [("estimate_flow", bool, True)],
        bases=(type(h),), frozen=True)(**dataclasses.asdict(h))
    head = TPVSegmentor._build_head(flow_cfg)
    init_weights(head, torch.Generator().manual_seed(SEED))
    cpu_head = copy.deepcopy(head).train()
    head = head.to(device).train()
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    H, W = head.field.mapping.size_h, head.field.mapping.size_w
    reps = [0.5 * torch.randn((1, H * W, h.embed_dims), generator=g,
                              device=device) for _ in range(3)]
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    return h, head, cpu_head, reps, batch[h.trans_kw], g


def flow_lookup_inputs(head, out, img2lidar):
    """The flow lookup's inputs in the head's forward ``out``: the rays'
    origins and directions (one a ray), the samples as fractional indices
    of the flow grid (N, 3), unclipped (the kernels clip), and the
    ``curr2prev_flow`` volume (H, W, D, 3)."""
    import torch
    from selfocc_tpu_torch.geometry.projection import rays_from_img2lidar
    with torch.no_grad():
        origin, direction = rays_from_img2lidar(img2lidar, out["ms_rays"])
        n_cams, n_rays = direction.shape[1:3]
        origin = origin[0, :, None, :].expand(n_cams, n_rays, 3).reshape(
            -1, 3)
        direction = direction[0].reshape(-1, 3)
        S = out["ts"].shape[-1]
        norm = direction.norm(dim=-1, keepdim=True)
        positions = origin[:, None, :] + (direction / norm)[:, None, :] \
            * (out["ts"].reshape(-1, S) * norm)[..., None]
        pts = head.field.mapping.meter2grid(
            positions.reshape(-1, 3)).contiguous()
        vol = out["curr2prev_flow"][0].detach().contiguous()
    return origin, direction, pts, vol


def flow_forward_backward(head, reps, img2lidar, g):
    """One training forward of the flow head and a backward of the warped
    samples and the four flows (random cotangents); returns the outputs."""
    import torch
    out = head(reps[0], img2lidar, train=True, generator=g,
               prev_rep=reps[1], next_rep=reps[2])
    keys = ("prev_warp", "next_warp", "curr2prev_flow", "curr2next_flow",
            "prev2curr_flow", "next2curr_flow")
    cots = [torch.randn(out[k].shape, generator=g, device=out[k].device)
            for k in keys]
    torch.autograd.backward([out[k] for k in keys], cots)
    return out


def flow_profile(head, reps, img2lidar, g, narrow=True):
    """torch.profiler over one more forward and backward of the flow head:
    the kernel time, the launches and the wall, and (``narrow``) the
    narrow kernels' device ms per call and calls in it, 2 each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            flow_forward_backward(head, reps, img2lidar, g)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in kernels)
        if total_us > 0:
            break
        log(f"  profiled flow head {attempt + 1}: no device time recorded")
    res = {"profiled_wall_ms": wall_ms, "kernel_ms": total_us / 1e3,
           "kernel_launches": sum(e.count for e in kernels)}
    for name in ("values_fwd_narrow", "values_bwd_narrow")[:2 * narrow]:
        hits = [e for e in kernels if f"{name}_kernel" in e.key]
        calls = sum(e.count for e in hits)
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        res[name] = {"calls": calls, "device_ms": ms,
                     "ms_per_call": ms / max(calls, 1)}
        log(f"    {name} in the flow head's forward and backward: x{calls} "
            f"{ms:.4f} ms ({ms / max(calls, 1):.4f} ms per call)")
        if calls != 2:
            raise AssertionError(f"profiled flow head: {name} x{calls}, "
                                 "expected 2")
    log(f"  profiled flow head: wall {wall_ms:.1f} ms, "
        f"{res['kernel_launches']} kernels, {res['kernel_ms']:.2f} ms of "
        "kernel time")
    return res


def walk_library():
    """``csrc/trilinear.cu`` without the narrow instances (``narrow_walk``
    of ``tools/trilinear_scatter_variants.py``), built and loaded: C = 2
    and 3 with zeros padding take the walks there."""
    import tempfile
    tool = load_tool("trilinear_scatter_variants")
    with tempfile.TemporaryDirectory() as tmp:
        return tool.build(tmp, ("narrow_walk",))["narrow_walk"]


@contextlib.contextmanager
def walk_route(lib):
    """The flow lookup by the route before the narrow instances while the
    block runs: the head's ``sample_border`` clipping in torch, then the
    zeros-padded query, and ``lib`` (``walk_library``) swapped in for the
    port's trilinear library."""
    from selfocc_tpu_torch import _build
    from selfocc_tpu_torch.models import heads
    from selfocc_tpu_torch.ops import interp
    own = _build.load("trilinear", interp._SIGNATURES)
    narrow_lookup = heads.sample_border

    def clip_then_zeros(vol, hwd):
        return interp.trilinear_sample_cf(
            vol.permute(3, 0, 1, 2), clip_in_torch(hwd, vol.shape[:3]),
            "zeros")
    heads.sample_border = clip_then_zeros
    _build._LIBS["trilinear"] = lib
    try:
        yield
    finally:
        heads.sample_border = narrow_lookup
        _build._LIBS["trilinear"] = own


def flow_route_ab(head, reps, img2lidar, g, lib):
    """The flow head's forward and backward by the narrow instances
    (``narrow``) and by the route they replaced (``walk``, ``walk_route``),
    in turns (narrow, walk, walk, narrow): each turn's median wall over 3
    runs (synchronised) and the kernel time of one profiled run."""
    import statistics
    import torch
    res = {"narrow": [], "walk": []}
    for route in ("narrow", "walk", "walk", "narrow"):
        with (walk_route(lib) if route == "walk"
              else contextlib.nullcontext()):
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flow_forward_backward(head, reps, img2lidar, g)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof = flow_profile(head, reps, img2lidar, g,
                                narrow=route == "narrow")
        res[route].append({"wall_s": statistics.median(walls),
                           "kernel_ms": prof["kernel_ms"],
                           "kernel_launches": prof["kernel_launches"]})
    log(f"  the flow head's forward and backward, narrow against walk in "
        f"turns: {res}")
    return res


def dropped_walk_route(interp, vol_cf, pts, gv, lib):
    """The route the narrow instances replaced, timed in this call: the
    points clipped in torch (``clip_in_torch``), then ``trilinear_cf_fwd``
    / ``trilinear_cf_bwd``'s walk kernels at C = 3 with zeros padding,
    from ``lib`` (``walk_library``), swapped in for the port's library
    while it runs. Each walk is held against the plain border version on
    the unclipped points."""
    import torch
    from selfocc_tpu_torch import _build
    shape = tuple(vol_cf.shape[1:])
    clipped = clip_in_torch(pts, shape).contiguous()
    own = _build.load("trilinear", interp._SIGNATURES)
    _build._LIBS["trilinear"] = lib
    try:
        def fwd():
            return interp.trilinear_cf_fwd(vol_cf, clipped)

        def bwd():
            return interp.trilinear_cf_bwd(tuple(vol_cf.shape), clipped, gv)
        ref = interp.trilinear_sample_cf_plain(vol_cf, pts, "border")
        rel, err = channel_close(fwd(), ref)
        check("walk at C = 3 on the clipped points / channel tolerance",
              rel, 1.0)
        del ref
        ref = interp.trilinear_cf_bwd_plain(vol_cf, pts, gv,
                                            padding="border")
        berr = max_err(bwd(), ref)
        check("walk backward at C = 3 on the clipped points", berr,
              GRAD_RTOL * float(ref.abs().max()) + 1e-7)
        del ref
        torch.cuda.empty_cache()
        rec = {"fwd": {"device_ms": device_ms(fwd, 10), "ms": timed(fwd, 10),
                       "batched_ms": batched_ms(fwd, 10),
                       "max_abs_err": err},
               "bwd": {"device_ms": device_ms(bwd, 10), "ms": timed(bwd, 10),
                       "batched_ms": batched_ms(bwd, 10),
                       "max_abs_err": berr}}
    finally:
        _build._LIBS["trilinear"] = own
    clip = (lambda: clip_in_torch(pts, shape))
    rec["clip_device_ms"] = device_ms(clip, 10)
    rec["clip_ms"] = timed(clip, 10)
    rec["clip_launches"] = sum(c for c, _ in call_kernels(clip).values())
    log(f"  the dropped route (torch clip, then the walk): {rec}")
    return rec


def flow_points_record(interp, vol_cf, pts, g):
    """The narrow backward's point instance (``values_bwd_narrow_kernel``
    with kPoints, border padding) on stand-ins of the step's points: of
    every 48, one snapped to a knot of each of the six faces (the other
    two indices rounded) and one to its nearest knot; the rest as the step
    has them, inside and beyond the volume. Both cotangents against the
    plain version (GRAD_RTOL), their distances from the plain version in
    float64 logged; timed beside ``F.grid_sample``'s backward with a grid
    gradient (border). Bound: points and cotangent read, the corner rows
    read once, the volume's and the points' cotangents written; 20 + 16 C
    + 8 (2 C + 20) operations per point."""
    import torch
    C = vol_cf.shape[0]
    shape = tuple(vol_cf.shape[1:])
    m = pts.shape[0]
    stand = pts.clone()
    knots = clip_in_torch(torch.round(pts), shape)
    for f in range(7):
        sel = slice(8 * f, None, 48)
        stand[sel] = knots[sel]
        if f < 6:
            stand[sel, f // 2] = (f % 2) * (shape[f // 2] - 1.0)
    gv = torch.randn((m, C), generator=g, device=pts.device)
    got = interp.trilinear_cf_bwd(tuple(vol_cf.shape), stand, gv, vol_cf,
                                  "border")
    ref = interp.trilinear_cf_bwd_plain(vol_cf, stand, gv, points=True,
                                        padding="border")
    err = check_grads("trilinear_cf_bwd narrow points (flow stand-ins, "
                      "knots on every face)", got, ref)
    ref64 = interp.trilinear_cf_bwd_plain(
        vol_cf.double(), stand.double(), gv.double(), points=True,
        padding="border")
    f64 = {which: {"kernel": max_err(a, r), "plain_fp32": max_err(b, r),
                   "scale": float(r.abs().max())}
           for which, a, b, r in zip(("volume", "points"), got, ref, ref64)}
    log(f"  narrow points against float64: {f64}")
    del got, ref, ref64
    torch.cuda.empty_cache()
    lib = grid_sample_points_bwd_of(vol_cf, stand, gv, "border")

    def kern():
        return interp.trilinear_cf_bwd(tuple(vol_cf.shape), stand, gv,
                                       vol_cf, "border")
    voxels = corner_voxels(clip_in_torch(stand, shape), shape)
    rec = kernel_record(
        err, timed(kern, 10),
        timed(lambda: interp.trilinear_cf_bwd_plain(
            vol_cf, stand, gv, points=True, padding="border"), 3),
        (nbytes(stand, gv) + voxels * C * 4
         + shape[0] * shape[1] * shape[2] * C * 4 + m * 12,
         m * (20 + 16 * C + 8 * (2 * C + POINTS_OPS_PER_CORNER))),
        library_ms=timed(lib, 10), library="F.grid_sample backward, grid "
        "with a gradient (border)", library_device_ms=device_ms(lib, 10),
        device_ms=device_ms(kern, 10), batched_ms=batched_ms(kern, 10),
        float64=f64, shape=f"flow stand-ins, C={C}, {m} points", points=m,
        C=C,
        corner_voxels=voxels)
    log(f"  trilinear_cf_bwd narrow points: {rec}")
    del stand, gv, lib
    torch.cuda.empty_cache()
    return rec


def flow_head_path(device):
    """The BEV flow head (``estimate_flow``) at ``nuscenes_occ_bev``'s full
    width: the head with seeded weights takes random (1, 257 x 257, 96)
    current, previous and next planes and renders one training forward on
    the card (28,800 random-grid rays x 256 samples); its four (1, 257,
    257, 25, 3) flows and the two warped sample sets go into a backward.
    The lookups at the samples must launch the narrow instances of
    ``trilinear_cf_fwd`` and ``trilinear_cf_bwd`` (C = 3, the border
    padding in the kernel) twice each and no walk (the forward's rows
    instance once more for the recipe's uniform sdf grid). Held against
    the plain path on the CPU: the four flows (GRAD_RTOL of their max) and
    the warps of 4096 rays (1e-5 of their max). A profiled forward and
    backward gives the pair's in-step device ms (``flow_profile``), and
    the head's forward and backward is timed beside the route the narrow
    instances replaced (``flow_route_ab``). Then,
    at the step's own 7,372,800 unclipped points of ``curr2prev_flow``
    (their clipped share and most points in one cell logged): both
    kernels (``values_fwd_record`` / ``values_bwd_record`` with
    ``"border"``: against their plain versions, timed beside
    ``F.grid_sample`` with border padding and its backward), the dropped
    route in the same call (``dropped_walk_route``) and the point instance
    (``flow_points_record``)."""
    import torch
    from selfocc_tpu_torch.ops import interp
    h, head, cpu_head, reps, img2lidar, g = flow_head_setup(device)
    wrappers = (interp.trilinear_cf_fwd, interp.trilinear_cf_bwd)
    reset_counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = flow_forward_backward(head, reps, img2lidar, g)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = read_counts(wrappers, "flow head", (),
                           ("trilinear_cf_fwd.narrow",
                            "trilinear_cf_bwd.narrow"))
    launches.update({f"{fn.__name__}.{k}": n for fn in wrappers
                     for k, n in instance_counts(fn).items()})
    # the two lookups, and the recipe's uniform sdf query (C = 25; the
    # backward above leaves its output out)
    want = {"trilinear_cf_fwd.narrow": 2, "trilinear_cf_bwd.narrow": 2,
            "trilinear_cf_fwd.rows": int(h.return_uniform_sdf),
            "trilinear_cf_bwd.rows": 0, "trilinear_cf_bwd.walk": 0,
            "trilinear_cf_bwd.points": 0}
    wrong = {k: (launches[k], n) for k, n in want.items()
             if launches[k] != n}
    if wrong:
        raise AssertionError(f"the flow lookups launched (got, expected) "
                             f"{wrong}")
    res = {"forward_backward_s": step_s, "launches": launches,
           "flow_shape": list(out["curr2prev_flow"].shape)}
    with torch.no_grad():
        cpu_flows = cpu_head.flows(*(r.cpu() for r in reps))
        err = {}
        for k, ref in cpu_flows.items():
            e = max_err(out[k].detach().cpu(), ref)
            check(f"flow head {k}, card against CPU", e,
                  GRAD_RTOL * float(ref.abs().max()) + 1e-7)
            err[k] = e
        origin, direction, pts, vol = flow_lookup_inputs(head, out,
                                                         img2lidar)
        S = out["ts"].shape[-1]
        idx = torch.linspace(0, origin.shape[0] - 1, SUBSET_RAYS,
                             device=device).long()
        ts = out["ts"].reshape(-1, S)[idx]
        warps = cpu_head.warped_samples(cpu_flows, origin[idx].cpu(),
                                        direction[idx].cpu(), ts.cpu())
        for k, ref in warps.items():
            e = max_err(out[k].detach().reshape(-1, S, 3)[idx].cpu(), ref)
            check(f"flow head {k} (4096 rays), card against CPU", e,
                  1e-5 * float(ref.abs().max()))
            err[k] = e
        res["max_abs_err"] = err
    del out, cpu_head, origin, direction
    torch.cuda.empty_cache()
    res["profile"] = flow_profile(head, reps, img2lidar, g)
    lib = walk_library()
    res["route_ab"] = flow_route_ab(head, reps, img2lidar, g, lib)
    shape = tuple(vol.shape[:3])
    clipped = clip_in_torch(pts, shape)
    res["clipped_share"] = float((clipped != pts).any(-1).float().mean())
    res["points_census"] = point_stats(clipped, shape)
    log(f"  flow lookup points: {res['clipped_share']:.4f} clipped; "
        f"{res['points_census']}")
    del clipped
    vol_cf = vol.permute(3, 0, 1, 2)
    tag = f"flow lookup, C=3, {pts.shape[0]} points"
    fwd = values_fwd_record(interp, vol_cf, pts, tag, 10, padding="border")
    gv = torch.randn((pts.shape[0], 3), generator=g, device=device)
    bwd = values_bwd_record(interp, tuple(vol_cf.shape), pts, gv,
                            "flow lookup", 10, padding="border")
    walk = dropped_walk_route(interp, vol_cf, pts, gv, lib)
    fwd.update(walk_device_ms=walk["fwd"]["device_ms"],
               walk_ms=walk["fwd"]["ms"],
               walk_batched_ms=walk["fwd"]["batched_ms"],
               clip_device_ms=walk["clip_device_ms"],
               clip_ms=walk["clip_ms"], clip_launches=walk["clip_launches"])
    bwd.update(walk_device_ms=walk["bwd"]["device_ms"],
               walk_ms=walk["bwd"]["ms"],
               walk_batched_ms=walk["bwd"]["batched_ms"],
               points_instance=flow_points_record(interp, vol_cf, pts, g))
    res["trilinear_cf_fwd"], res["trilinear_cf_bwd"] = fwd, bwd
    res["dropped_walk_route"] = walk
    del vol, vol_cf, pts, gv, head, reps
    torch.cuda.empty_cache()
    return res


def variants_phase(device):
    """``nuscenes_occ`` at full width and depth with every model option the
    port added last (``variant_config``): its tiny twin's step on the card
    against the CPU (``train_parity``), 3 measured steps (profiled,
    sync-checked: ``lever_train``), one eval frame and one Occ3D frame
    (``recipe_eval``: prepare with the cameras, a 4096-ray subset against
    the CPU), and the BEV flow head (``flow_head_path``)."""
    import torch
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    log(f"  card: {card_name()}")
    res = {"tiny_parity": train_parity(device, cfg=variant_config("tiny"))}
    cfg = variant_config()
    m = cfg.model
    log(f"  {cfg.name}: lifter {m.lifter_type}, mapping "
        f"{m.encoder.mapping_args}, camera_aware {m.encoder.camera_aware}, "
        f"multi_plane_ffn_norm {m.encoder.multi_plane_ffn_norm}, rays "
        f"{m.head.ray_sample_mode}")
    render = (rw.neus_render_fwd, interp.trilinear_cf_with_grad_fwd)
    off = (msda.msda_shared_fwd, msda.msda_shared_bwd, rw.neus_weights_fwd,
           rw.neus_weights_bwd)
    res["train"] = lever_train(
        device, cfg, render + (rw.neus_render_bwd, interp.trilinear_bwd,
                               msda.msda_fwd, msda.msda_bwd),
        off, instances=("plane", "rows"))
    res["eval"] = recipe_eval(
        device, cfg, render + (msda.msda_fwd,),
        off + (msda.msda_bwd, interp.trilinear_bwd, rw.neus_render_bwd))
    torch.cuda.empty_cache()
    res["flow"] = flow_head_path(device)
    return res


def train_driver_run(device):
    """``selfocc_tpu_torch.train.main`` at ``nuscenes_occ``'s full width
    with the driver's options: ``--gradient-accumulation 2 --profile
    --eval-every-epoch --eval-samples 1 --max-steps 6`` on synthetic data,
    in a temporary work dir. Fails unless the run log (with the per-epoch
    depth table, which it logs), ``scalars.jsonl`` and the profiler's trace
    are there, the trace names the port's kernels (``msda_*``,
    ``trilinear*`` / ``values_*``, ``neus_render_*``), every kernel of the
    step was launched, and the last checkpoint counts 6 micro-steps and 3
    updates. Then ``accumulation_check``."""
    import glob
    import os
    import tempfile
    import torch
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    wrappers = (rw.neus_render_fwd, rw.neus_render_bwd,
                interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
                msda.msda_fwd, msda.msda_bwd)
    with tempfile.TemporaryDirectory() as work:
        reset_counts(wrappers)
        t0 = time.time()
        out = train.main(["--py-config", "nuscenes_occ", "--synthetic",
                          "--gradient-accumulation", "2", "--profile",
                          "--eval-every-epoch", "--eval-samples", "1",
                          "--max-steps", str(TRAIN_DRIVER_STEPS),
                          "--work-dir", work])
        wall = time.time() - t0
        launches = read_counts(wrappers, "train driver run",
                               ("plane", "rows"))
        logs = glob.glob(os.path.join(work, "*.log"))
        if len(logs) != 1:
            raise AssertionError(f"run logs in the work dir: {logs}")
        with open(logs[0]) as f:
            text = f.read()
        for want in ("=== epoch 0 depth eval ===", "profiler trace written",
                     f"[e0 i{TRAIN_DRIVER_STEPS - 1}]"):
            if want not in text:
                raise AssertionError(f"the run log lacks {want!r}")
        with open(os.path.join(work, "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        if not scalars or not all(math.isfinite(r["value"])
                                  for r in scalars):
            raise AssertionError(f"scalars.jsonl: {scalars[:4]}")
        trace_path = os.path.join(work, "profile", "trace.json")
        trace_mb = os.path.getsize(trace_path) / 2**20
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel" and \
                    PORT_KERNEL_NAMES.search(e.get("name", "")):
                m = PORT_KERNEL_NAMES.search(e["name"])
                kernels[m.group(0)] = kernels.get(m.group(0), 0) + 1
        del events
        missing = [want for want, names in (
            ("msda", ("msda_",)), ("trilinear", ("trilinear", "values_")),
            ("neus_render", ("neus_render_",)))
            if not any(k in kernels for k in names)]
        if missing:
            raise AssertionError(f"the trace names no {missing} kernel: "
                                 f"{kernels}")
        state = torch.load(os.path.join(work, "ckpts", "latest.pt"),
                           map_location="cpu")
        counts = (state["step"], state["updates"], state["mini_step"])
        if counts != (TRAIN_DRIVER_STEPS, TRAIN_DRIVER_STEPS // 2, 0):
            raise AssertionError(f"checkpoint step, updates, mini_step "
                                 f"{counts}")
        del state
    table = {k: [[float(x) for x in row] for row in v]
             for k, v in out["epoch_evals"][0].items()}
    waits = sorted(out["data_wait_s"])
    log(f"  train.main: {TRAIN_DRIVER_STEPS} micro-steps in {wall:.1f}s "
        f"(build, profile and eval included; the wait for a synthetic "
        f"batch: median {waits[len(waits) // 2]:.2f}s, total "
        f"{sum(waits):.1f}s); trace {trace_mb:.1f} MiB, "
        f"port kernel events {kernels}; epoch-0 depth table "
        f"abs_rel {table['abs_rel']}, rmse {table['rmse']}")
    torch.cuda.empty_cache()
    return {"wall_s": wall, "launches": launches, "scalars": len(scalars),
            "trace_mib": trace_mb, "trace_port_kernel_events": kernels,
            "epoch_eval": table, "step_s": out["step_s"],
            "data_wait_s": out["data_wait_s"],
            "accumulation": accumulation_check(device)}


def accumulation_check(device):
    """Gradient accumulation at ``nuscenes_occ``'s full width, on one
    batch: with K = 2 the parameters are bitwise unchanged after micro-step
    1, and after micro-step 2 they equal one K = 1 optimizer step of
    another trainer on the same initial weights on the mean of the two
    micro-steps' gradients (the very gradients the K = 2 trainer took:
    the kernels' atomics make a recomputed gradient differ in its last
    bits, which AdamW's first step magnifies where a gradient is near
    eps), within GRAD_RTOL of each tensor's largest update."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.train import build_trainer
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    from selfocc_tpu_torch.utils.train_lib import optimizer_step
    cfg = get_config("nuscenes_occ")
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    acc = build_trainer(cfg, SEED, device, 2)
    p0 = {n: p.detach().clone() for n, p in acc.model.named_parameters()}
    grads = []
    apply = acc.apply_gradients

    def caught():
        grads.append({n: p.grad.clone() for n, p in
                      acc.model.named_parameters() if p.grad is not None})
        return apply()

    acc.apply_gradients = caught
    acc.step(batch, torch.Generator(device=device).manual_seed(SEED))
    same = all(torch.equal(p, p0[n]) for n, p in
               acc.model.named_parameters())
    if not same:
        raise AssertionError("K = 2: parameters moved at micro-step 1")
    acc.step(batch, torch.Generator(device=device).manual_seed(SEED + 1))
    ref = build_trainer(cfg, SEED, device, 1)
    for n, p in ref.model.named_parameters():
        if n in grads[0]:
            p.grad = grads[0][n] + (grads[1][n] - grads[0][n]) / 2
    optimizer_step(ref.optimizer, ref.sched, 0, cfg.grad_max_norm)
    worst, bitwise = 0.0, True
    refs = dict(ref.model.named_parameters())
    for n, p in acc.model.named_parameters():
        upd = float((refs[n].detach() - p0[n]).abs().max())
        err = max_err(p.detach(), refs[n].detach())
        bitwise &= err == 0.0
        ratio = err / (GRAD_RTOL * upd + 1e-30)
        if not ratio <= 1.0:
            raise AssertionError(f"K = 2 after micro-step 2, {n}: "
                                 f"{ratio:.3f} of its tolerance")
        worst = max(worst, ratio)
    log(f"  accumulation (K = 2, full width): parameters bitwise unchanged "
        f"after micro-step 1; after micro-step 2 one step on the mean "
        f"gradient (bit for bit: {bitwise}; worst {worst:.3g} of GRAD_RTOL "
        f"of the update)")
    del acc, ref, p0, grads
    torch.cuda.empty_cache()
    return {"unchanged_after_micro_step_1": same,
            "mean_step_bitwise": bitwise, "worst_err_over_tol": worst}

# the UNet2D recipe: nuscenes_occ on the EfficientNet-B7 UNet2D (the
# reference's tf_efficientnet_b7, unet_scaling (2.0, 3.1)) with the identity
# neck; its pyramid is at strides 2..16 of the 384 x 800 input
UNET_SHAPES = ((192, 400), (96, 200), (48, 100), (24, 50))
UNET_MSDA_CALLS = (("unet_cross", (6, 66049, UNET_SHAPES, 8)),
                   ("unet_zh", (6, 6425, UNET_SHAPES, 48)))
TINY_UNET_SCALING = (0.25, 0.35)


def unet_config(base="nuscenes_occ"):
    """``base`` on the UNet2D backbone with the identity neck, as a user's
    variant config builds it (``dataclasses.replace``): ``out_feature`` =
    ``embed_dims`` at every level; ``nuscenes_occ`` at B7's scaling (the
    ``ModelConfig`` default), ``tiny`` at ``TINY_UNET_SCALING``."""
    from selfocc_tpu_torch.configs.experiments import get_config
    cfg = get_config(base)
    m = dataclasses.replace(
        cfg.model, backbone_type="unet2d", neck_type="identity",
        fpn_in_channels=(cfg.model.embed_dims,) * 4,
        unet_scaling=cfg.model.unet_scaling if base == "nuscenes_occ"
        else TINY_UNET_SCALING)
    return dataclasses.replace(cfg, name=f"{base}_unet", model=m)


def unet_phase(device):
    """``nuscenes_occ`` on the B7 UNet2D with the identity neck
    (``unet_config``), synthetic batches, seeded weights: its tiny twin's
    step on the card against the CPU (``train_parity``); ``msda_fwd`` /
    ``msda_bwd`` at the image cross-attention's calls on the UNet's levels
    (192 x 400 .. 24 x 50) against their plain versions, timed; 3 measured
    steps (median, spread, split, peak, launches), a profiled step and one
    under the sync check (``lever_train``); one eval frame
    (``recipe_eval``: prepare_s, render_s, a 4096-ray subset against the
    CPU)."""
    import torch
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    log(f"  card: {card_name()}")
    res = {"tiny_parity": train_parity(device, cfg=unet_config("tiny")),
           "msda": {}}
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    for tag, args in UNET_MSDA_CALLS:
        fwd, bwd = msda_records(g, device, tag, args)
        res["msda"][tag] = {"msda_fwd": fwd, "msda_bwd": bwd}
        for name, rec in res["msda"][tag].items():
            log(f"  {name} ({tag}): " + ", ".join(
                f"{k} {rec[k]:.4g}" for k in ("device_ms", "ms", "plain_ms",
                                              "bound_ms")
                if rec.get(k) is not None))
    cfg = unet_config()
    log(f"  {cfg.name}: EfficientNet scaling {cfg.model.unet_scaling}, "
        f"levels {UNET_SHAPES}, neck {cfg.model.neck_type}")
    render = (rw.neus_render_fwd, interp.trilinear_cf_with_grad_fwd)
    off = (msda.msda_shared_fwd, msda.msda_shared_bwd, rw.neus_weights_fwd,
           rw.neus_weights_bwd)
    res["train"] = lever_train(
        device, cfg, render + (rw.neus_render_bwd, interp.trilinear_bwd,
                               msda.msda_fwd, msda.msda_bwd),
        off, instances=("plane", "rows"))
    res["eval"] = recipe_eval(
        device, cfg, render + (msda.msda_fwd,),
        off + (msda.msda_bwd, interp.trilinear_bwd, rw.neus_render_bwd),
        occ3d=False)
    return res


# the teacher: Swin-T (embed 96, depths 2/2/6/2, window 7) under a
# 512-channel UperNet with OpenSeeD's 21 classes, random weights
TEACHER_CLASSES, TEACHER_CHANNELS = 21, 512
TEACHER_IMGS = (6, 768, 1600)     # nuscenes_occ's curr_imgs at img_size


def random_teacher_state_dict():
    """A seeded Swin-T UperNet's state dict in HF's keys, its BatchNorm
    statistics and relative-position tables off their init."""
    import torch
    from selfocc_tpu_torch.models.initializers import init_weights
    from selfocc_tpu_torch.models.swin import SwinConfig
    from selfocc_tpu_torch.models.upernet import SwinUperNet
    model = SwinUperNet(TEACHER_CLASSES, SwinConfig(), TEACHER_CHANNELS)
    init_weights(model, torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    sd = model.state_dict()
    with torch.no_grad():
        for k, t in sd.items():
            if k.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif k.endswith(("running_mean", "bias_table")):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return sd


def teacher_maps_agree(got, ref, logits, what):
    """Class maps equal wherever the two largest logits differ by more
    than 1e-4; the share of such pixels."""
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    bad = int(((got != ref) & clear).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} pixels differ off near-ties")
    return float(clear.float().mean())


def teacher_phase(device):
    """The online semantic teacher (``TorchSemTeacher``, ``--teacher-ckpt``)
    with a random Swin-T UperNet written in HF's keys as ``.pt`` and
    ``.safetensors`` in a temporary directory: both load to the same
    weights; logits and maps on the card against the CPU on one 96 x 160
    image (logits within 1e-4 of their scale, maps equal off near-ties);
    its ms a call on 6 x 768 x 1600 (events and device time, peak, top
    kernels); ``nuscenes_occ`` steps on one synthetic batch with its
    ``sem_gt`` and with the teacher's in its place (3 measured each,
    synchronised); then ``train.main --teacher-ckpt`` for 2 steps on a
    fabricated nuScenes tree with no offline maps (``teacher_train_run``)."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.train import build_trainer
    from selfocc_tpu_torch.utils.openseed_utils import TorchSemTeacher
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    from selfocc_tpu_torch.utils.swin_import import write_safetensors
    log(f"  card: {card_name()}")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        sd = random_teacher_state_dict()
        pt = os.path.join(tmp, "teacher.pt")
        st = os.path.join(tmp, "teacher.safetensors")
        torch.save(sd, pt)
        write_safetensors(st, sd)
        del sd
        teacher = TorchSemTeacher.from_checkpoint(st, device=device)
        cpu = TorchSemTeacher.from_checkpoint(pt, device="cpu")
        a, b = teacher.model.state_dict(), cpu.model.state_dict()
        if set(a) != set(b) or not all(torch.equal(a[k].cpu(), b[k])
                                       for k in a):
            raise AssertionError("the .pt and .safetensors teachers differ")
        cfg_s = teacher.model.backbone.cfg
        log(f"  teacher from .safetensors and .pt: Swin {cfg_s}, "
            f"{sum(t.numel() for t in a.values()) / 1e6:.2f}M values")
        img = torch.rand((1, 96, 160, 3),
                         generator=torch.Generator().manual_seed(SEED)) * 255
        lc = teacher.logits(img.to(device)).cpu()
        lp = cpu.logits(img)
        scale = float(lp.abs().max())
        err = max_err(lc, lp)
        check("teacher logits, 96 x 160 (card vs CPU)", err, 1e-4 * scale)
        share = teacher_maps_agree(teacher(img.to(device)).cpu(), cpu(img),
                                   lp, "teacher maps (card vs CPU)")
        res["card_vs_cpu"] = {"logits_max_abs_err": err,
                              "logits_scale": scale,
                              "maps_compared_share": share}
        del cpu
        imgs = torch.rand(TEACHER_IMGS + (3,), device=device) * 255
        size = TEACHER_IMGS[1:]
        maps = teacher(imgs, size=size)
        if maps.shape != TEACHER_IMGS or maps.dtype != torch.uint8:
            raise AssertionError(f"teacher maps {maps.shape} {maps.dtype}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = timed(lambda: teacher(imgs, size=size), 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        dev = device_ms(lambda: teacher(imgs, size=size), 2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            teacher(imgs, size=size)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in kernels)
        top = [{"name": e.key[:90], "calls": e.count,
                "device_ms": e.self_device_time_total / 1e3}
               for e in kernels[:8]]
        log(f"  teacher on {TEACHER_IMGS[0]} x {size[0]}x{size[1]}: "
            f"{ms:.2f} ms (events), {dev} ms device, {len(kernels)} kernel "
            f"kinds, {total / 1e3:.2f} ms profiled, peak {peak:.2f} GiB")
        for t in top:
            log(f"    {t['device_ms']:9.2f} ms x{t['calls']:<4d} {t['name']}")
        res["teacher"] = {"ms": ms, "device_ms": dev, "max_memory_gb": peak,
                          "profiled_kernel_ms": total / 1e3, "top": top,
                          "imgs": list(TEACHER_IMGS)}
        del imgs, maps

        cfg = get_config("nuscenes_occ")
        trainer = build_trainer(cfg, SEED, device)
        batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0],
                          device)
        bare = {k: v for k, v in batch.items() if k != "sem_gt"}
        gen = torch.Generator(device=device).manual_seed(SEED)
        sync = torch.cuda.synchronize

        def with_teacher():
            b = dict(bare)
            b["sem_gt"] = teacher(b["curr_imgs"][0] * 256.0,
                                  size=cfg.img_size)[None]
            return trainer.step(b, gen, sync=sync)

        times = {"given": [], "teacher": []}
        check_finite_metrics(with_teacher(), "teacher step")
        for _ in range(3):
            for key, fn in (("given", lambda: trainer.step(batch, gen,
                                                           sync=sync)),
                            ("teacher", with_teacher)):
                sync()
                t0 = time.perf_counter()
                check_finite_metrics(fn(), f"{key} step")
                times[key].append(time.perf_counter() - t0)
        med = {k: sorted(v)[1] for k, v in times.items()}
        log(f"  nuscenes_occ step, sem_gt given: median {med['given']:.4f}s "
            f"{times['given']}; from the teacher: {med['teacher']:.4f}s "
            f"{times['teacher']} (+{med['teacher'] - med['given']:.4f}s)")
        res["step"] = {"median_s": med, "steps_s": times}
        del trainer, batch, bare, teacher
        torch.cuda.empty_cache()
        res["train_main"] = teacher_train_run(device, st)
    return res


def teacher_train_run(device, ckpt):
    """``train.main --teacher-ckpt`` for 2 ``nuscenes_occ`` steps from the
    loader on a fabricated nuScenes tree (``fabricate_nuscenes``) whose
    config reads no offline maps: its items carry no ``sem_gt`` and the
    semantic loss needs one, so the run fails unless the teacher filled
    it; the teacher's calls are counted (one a step) and the logged
    losses finite."""
    import shutil
    import tempfile
    import torch
    from selfocc_tpu_torch import train
    from selfocc_tpu_torch.configs import experiments as ex
    from selfocc_tpu_torch.data import build_dataset
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    from selfocc_tpu_torch.utils.openseed_utils import TorchSemTeacher
    root = tempfile.mkdtemp(prefix="selfocc_teacher_")
    try:
        paths = fabricate_nuscenes(root)
        base, _ = fabricated_configs(paths)
        cfg = dataclasses.replace(base, name="nuscenes_occ_fab_teacher",
                                  wrapper_args={})
        ex.register_config(cfg.name, lambda: cfg)
        if "sem_gt" in build_dataset(cfg, "train")[0]:
            raise AssertionError("the fabricated items carry sem_gt")
        calls = []
        call = TorchSemTeacher.__call__

        def counted(self, imgs, size=None):
            out = call(self, imgs, size)
            calls.append(tuple(out.shape))
            return out

        wrappers = (rw.neus_render_fwd, rw.neus_render_bwd,
                    interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
                    msda.msda_fwd, msda.msda_bwd)
        TorchSemTeacher.__call__ = counted
        reset_counts(wrappers)
        t0 = time.time()
        try:
            with tempfile.TemporaryDirectory() as work:
                out = train.main(["--py-config", cfg.name, "--max-steps",
                                  "2", "--print-freq", "1", "--work-dir",
                                  work, "--teacher-ckpt", ckpt])
        finally:
            TorchSemTeacher.__call__ = call
        wall = time.time() - t0
        launches = read_counts(wrappers, "train.main --teacher-ckpt",
                               ("plane", "rows"))
        if calls != [(1 * cfg.num_cams,) + tuple(cfg.img_size)] * 2:
            raise AssertionError(f"teacher calls {calls}")
        sem = {step: v["SemCELossMS"] for step, v in out["logged"].items()}
        if len(sem) != 2 or not all(math.isfinite(x) for x in sem.values()):
            raise AssertionError(f"SemCELossMS of the steps: {sem}")
        log(f"  train.main --teacher-ckpt: 2 steps from the fabricated "
            f"loader in {wall:.1f}s, the teacher's maps {calls[0]} a step, "
            f"SemCELossMS {sem}, step_s {out['step_s']}")
        torch.cuda.empty_cache()
        return {"wall_s": wall, "teacher_calls": len(calls),
                "sem_loss": sem, "step_s": out["step_s"],
                "data_wait_s": out["data_wait_s"], "launches": launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


VIS_NOVEL = (1.0123, 0.5, 0.3, 10.0)   # vis_pics --novel-view, off knots
VIS_SCENE_FRAMES = 2                   # keyframes of the scene walk


def kernel_wrappers():
    """Every kernel wrapper of the port, with a launch count each."""
    from selfocc_tpu_torch.ops import gather_rows, interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    return (msda.msda_fwd, msda.msda_bwd, msda.msda_shared_fwd,
            msda.msda_shared_bwd, rw.neus_render_fwd, rw.neus_render_bwd,
            rw.neus_weights_fwd, rw.neus_weights_bwd,
            interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
            interp.trilinear_cf_fwd, interp.trilinear_cf_bwd,
            gather_rows.gather_rows_fwd)


def vis_path(what, run, expect):
    """``run()`` with every kernel's launch count set to 0 just before it
    and read just after (each wrapper's and, as ``name.kind``, each
    instance's; ``instance_counts``). Fails if a count differs from
    ``expect`` ({key: launches}, positive for the path's kernels) or a
    kernel outside ``expect`` was launched. Returns (result, counts,
    seconds, peak GiB)."""
    import torch
    wrappers = kernel_wrappers()
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {}
    for fn in wrappers:
        counts[fn.__name__] = fn.launches
        counts.update({f"{fn.__name__}.{k}": n
                       for k, n in instance_counts(fn).items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  launches in the {what}: "
        f"{ {k: n for k, n in counts.items() if n} }")
    wrong = {k: (counts[k], n) for k, n in expect.items() if counts[k] != n}
    stray = {k: n for k, n in counts.items() if n and k not in expect
             and k.split(".")[0] not in expect}
    if wrong or stray:
        raise AssertionError(f"{what}: launches (got, expected) {wrong}, "
                             f"kernels off its path {stray}")
    return out, counts, wall, peak


def captured_msda_calls(model, batch):
    """The arguments of each distinct MSDA call (by value and location
    shape) of one prepare of ``model`` on ``batch``: the encoder's own
    inputs."""
    import torch
    from selfocc_tpu_torch.models import encoder
    calls, orig = {}, encoder.ms_deform_attn

    def record(value, shapes, loc, attn, shared=False):
        key = (tuple(value.shape), tuple(loc.shape))
        if key not in calls and not shared:
            calls[key] = tuple(t.float().contiguous().clone() if i != 1
                               else tuple(t)
                               for i, t in enumerate((value, shapes, loc,
                                                      attn)))
        return orig(value, shapes, loc, attn, shared)

    encoder.ms_deform_attn = record
    try:
        with torch.no_grad():
            model.prepare(batch["imgs"], batch["lidar2img"])
    finally:
        encoder.ms_deform_attn = orig
    return list(calls.values())


def msda_real_records(model, batch):
    """``msda_fwd`` at the prepare's own calls (the TPV self-attention and
    the hw, zh / wz cross-attention on the model's values and locations)
    against its plain version (within 1e-5 of the output's scale), timed
    beside it (events, device ms) with its bound."""
    import torch
    from selfocc_tpu_torch.ops import msda
    recs = {}
    for case in captured_msda_calls(model, batch):
        value, shapes, loc, att = case
        tag = f"Q{loc.shape[1]}_L{len(shapes)}_P{loc.shape[-2]}"
        out = msda.msda_fwd(*case)
        ref = msda.ms_deform_attn_plain(*case)
        err = max_err(out, ref)
        check(f"msda_fwd at the vis prepare's {tag} call", err,
              1e-5 * max(1.0, float(ref.abs().max())))
        pts_n, D = msda_points(case)
        recs[tag] = kernel_record(
            err, timed(lambda: msda.msda_fwd(*case), 5),
            timed(lambda: msda.ms_deform_attn_plain(*case), 3),
            (nbytes(value, loc, att, out),
             pts_n * (MSDA_FWD_OPS[0] + D * MSDA_FWD_OPS[1])),
            device_ms=device_ms(lambda: msda.msda_fwd(*case), 5),
            value=list(value.shape), loc=list(loc.shape))
        del out, ref
    torch.cuda.empty_cache()
    return recs


def c25_frame_record(model, volume, origin, direction):
    """The C = 25 instance (rows kernel) of ``trilinear_cf_with_grad_fwd``
    at the first 32768-ray chunk of the novel-view render (8,388,608
    points on the decoded volume) against its plain version (each channel
    and the gradient within 1e-5 of its scale), timed with its bound."""
    import torch
    from selfocc_tpu_torch.ops import interp
    pts = render_grid_points(model.head, origin[:CHUNK], direction[:CHUNK])
    n, C = pts.shape[0], volume.shape[0]
    v_k, g_k = interp.trilinear_cf_with_grad_fwd(volume, pts)
    v_p, g_p = interp.trilinear_sample_cf_with_grad_plain(volume, pts)
    rel = max(channel_close(v_k, v_p)[0], channel_close(g_k, g_p)[0])
    err = max(max_err(v_k, v_p), max_err(g_k, g_p))
    check(f"trilinear_cf_with_grad_fwd (C={C}, vis chunk) / channel "
          "tolerance", rel, 1.0)
    del v_k, g_k, v_p, g_p
    torch.cuda.empty_cache()
    voxels = corner_voxels(pts, tuple(volume.shape[1:]))

    def kern():
        return interp.trilinear_cf_with_grad_fwd(volume, pts)
    rec = kernel_record(
        err, timed(kern, 10),
        timed(lambda: interp.trilinear_sample_cf_with_grad_plain(volume,
                                                                 pts), 3),
        (voxels * C * 4 + nbytes(pts) + n * (C + 3) * 4,
         n * (20 + 16 * C + 96)),
        device_ms=device_ms(kern, 10), points=n, C=C, corner_voxels=voxels,
        channel_rel_err=rel, shape=f"C={C}, {n} vis-chunk points")
    log(f"  trilinear_cf_with_grad_fwd C={C} vis chunk: ms {rec['ms']:.4g}, "
        f"device_ms {rec['device_ms']}, plain_ms {rec['plain_ms']:.4g}, "
        f"bound_ms {rec['bound_ms']:.4g} ({rec['bound_by']})")
    del pts
    torch.cuda.empty_cache()
    return rec


def vis_pics_path(device, work):
    """``vis_pics.main`` on one full-width ``nuscenes_occ`` frame from the
    novel pose, its launches counted; then, on the same seeded weights and
    frame, the depths in band, a 4096-ray subset (depth, acc, rgb) against
    the plain versions on the CPU, MSDA at the prepare's calls and the
    C = 25 forward at the render's first chunk against theirs."""
    import numpy as np
    import torch
    from selfocc_tpu_torch import vis_pics
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.eval_depth import build_model
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("nuscenes_occ")
    rh, rw = cfg.eval_num_rays
    chunks = -(-cfg.num_cams * rh * rw // CHUNK)
    r, counts, wall, peak = vis_path(
        "vis_pics frame",
        lambda: vis_pics.main(["--py-config", "nuscenes_occ", "--synthetic",
                               "--num-samples", "1", "--seed", str(SEED),
                               "--novel-view", *map(str, VIS_NOVEL),
                               "--work-dir", work]),
        {"msda_fwd": 16, "neus_render_fwd": chunks,
         "trilinear_cf_with_grad_fwd": chunks,
         "trilinear_cf_with_grad_fwd.rows": chunks,
         "trilinear_cf_with_grad_fwd.plane": 0})
    pngs = sorted(f for f in os.listdir(work) if f.endswith(".png"))
    if len(pngs) != 2 * cfg.num_cams:
        raise AssertionError(f"vis_pics wrote {pngs}")
    rgb = r["last_rgb"]
    if not np.isfinite(rgb).all():
        raise AssertionError("non-finite rgb")
    saturated = float((np.clip(rgb * 256 * 255, 0, 255) >= 255).mean())
    res = {"wall_s": wall, "prepare_s": r["prepare_s"],
           "render_s": r["render_s"], "png_write_s": r["write_s"],
           "rays": r["rays"], "rays_per_s": r["rays"] / r["render_s"],
           "max_memory_gb": peak, "chunks": chunks, "launches": counts,
           "rgb_saturated_share": saturated}
    log(f"  vis_pics: prepare {r['prepare_s']:.3f}s, render "
        f"{r['render_s']:.3f}s ({res['rays_per_s']:.0f} rays/s), PNGs "
        f"{r['write_s']:.3f}s, peak {peak:.2f} GiB, wall {wall:.1f}s; RGB "
        f"channels saturated by the 256 * 255 scale: {saturated:.4f}")

    model = build_model(cfg, SEED, device)
    batch = to_device(get_dataset(cfg, True, "val")[0], device)
    origin, direction, dn, near, far = depth_in_band(
        cfg, batch, torch.from_numpy(r["last_depth"]), device,
        novel_view=VIS_NOVEL)
    res["subset_err"] = frame_subset(model, batch, origin, direction, dn,
                                     near, far, device,
                                     outputs=("depth", "acc", "rgb"))
    res["msda_fwd"] = msda_real_records(model, batch)
    with torch.no_grad():
        volume = model.prepare(batch["imgs"], batch["lidar2img"]).float()
    res["trilinear_c25"] = c25_frame_record(model, volume, origin, direction)
    del model, volume, origin, direction
    torch.cuda.empty_cache()
    return res


def vis_3d_path(device, work):
    """On one full-width ``nuscenes_occ`` frame (the 200 x 200 x 16 grid at
    0.4 m): the model's query on its volume, kernel against plain version
    (the plain versions on the card), at the threshold that splits the
    grid in half (the seeded weights put every voxel below 0, where the
    check would hold nothing): the occupancies may differ only at voxels
    with |sdf - thresh| < 1e-5; ``trilinear_cf_fwd`` at the grid's points
    timed (``values_fwd_record``); then ``vis_3d.main --gt`` at that
    ``--thresh``, its launches counted and its occupancy against the
    check's. Returns the results and the threshold."""
    import numpy as np
    import torch
    from selfocc_tpu_torch import vis_3d
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.eval_depth import build_model
    from selfocc_tpu_torch.models.heads import uniform_axes_on, uniform_grid
    from selfocc_tpu_torch.ops import interp
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("nuscenes_occ")
    xyz = uniform_grid(*uniform_axes_on(tuple(cfg.model.head.roi_aabb), 0.4,
                                        device))
    grid = tuple(xyz.shape[:3])
    model = build_model(cfg, SEED, device)
    batch = to_device(get_dataset(cfg, True, "val")[0], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        volume = model.prepare(batch["imgs"], batch["lidar2img"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    field = model.head.field
    with torch.no_grad():
        sdf_k = field.query_geo(volume, xyz)["sdf"]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with plain_versions():
            sdf_p = field.query_geo(volume, xyz)["sdf"]
    thresh = float(sdf_k.median())
    occ_k = sdf_k <= thresh
    differ = occ_k != (sdf_p <= thresh)
    bad = differ & ~(((sdf_k - thresh).abs() < 1e-5)
                     | ((sdf_p - thresh).abs() < 1e-5))
    flips = {"voxels": int(differ.numel()), "differ": int(differ.sum()),
             "sdf_max_abs_err": max_err(sdf_k, sdf_p),
             "occupied": int(occ_k.sum()),
             "occupied_at_0": int((sdf_k <= 0).sum())}
    if int(bad.sum()):
        raise AssertionError(f"vis_3d occupancy: {int(bad.sum())} voxels "
                             "differ outside |sdf - thresh| < 1e-5")
    pts = field.mapping.meter2grid(xyz.reshape(-1, 3)).contiguous()
    rec = values_fwd_record(interp, volume, pts, "vis_3d "
                            + "x".join(map(str, grid)) + " grid", 20)
    del model, volume, xyz, pts, sdf_p
    torch.cuda.empty_cache()

    r, counts, wall, peak = vis_path(
        "vis_3d frame",
        lambda: vis_3d.main(["--py-config", "nuscenes_occ", "--synthetic",
                             "--num-samples", "1", "--gt", "--thresh",
                             repr(thresh), "--seed", str(SEED),
                             "--work-dir", work]),
        {"msda_fwd": 16, "trilinear_cf_fwd": 1, "trilinear_cf_fwd.rows": 1,
         "trilinear_cf_fwd.plane": 0})
    if tuple(r["last"]["sdf"].shape) != grid or not {
            "occ_000.ply", "gt_000.ply"} <= set(os.listdir(work)):
        raise AssertionError(f"vis_3d: grid {r['last']['sdf'].shape}, "
                             f"{os.listdir(work)}")
    occ_main = np.load(os.path.join(work, "occ_000.npy"))
    flips["driver_occupied"] = int(occ_main.sum())
    flips["driver_vs_check_differ"] = int(
        (occ_main != occ_k.cpu().numpy()).sum())
    res = {"wall_s": wall, "occ_s": r["occ_s"], "write_s": r["write_s"],
           "prepare_s": t1 - t0, "query_s": t2 - t1, "thresh": thresh,
           "voxel_count": r["voxels"][0], "grid": list(grid),
           "max_memory_gb": peak, "launches": counts,
           "kernel_vs_plain": flips, "trilinear_cf_fwd": rec}
    log(f"  vis_3d: thresh {thresh:.6g} (the check's median sdf), "
        f"forward_occ {r['occ_s']:.3f}s (prepare {t1 - t0:.4f}s, query "
        f"{t2 - t1:.4f}s on the check's volume), npy + PLY + GT writes "
        f"{r['write_s']:.3f}s, {r['voxels'][0]} occupied voxels of "
        f"{np.prod(grid)}, peak {peak:.2f} GiB; kernel vs plain {flips}")
    return res, thresh


def vis_scene_path(device, work, tmp, thresh):
    """``vis_3d_scene.main --imageset`` over ``VIS_SCENE_FRAMES`` keyframes
    of a fabricated full-size nuScenes tree (``fabricate_nuscenes``) at
    ``--thresh thresh``, its launches counted: the scene cloud holds every
    frame's voxels."""
    from selfocc_tpu_torch import vis_3d_scene
    t0 = time.time()
    paths = fabricate_nuscenes(os.path.join(tmp, "nusc"), VIS_SCENE_FRAMES)
    fab_s = time.time() - t0
    n = VIS_SCENE_FRAMES
    r, counts, wall, peak = vis_path(
        "vis_3d_scene walk",
        lambda: vis_3d_scene.main(
            ["--py-config", "nuscenes_occ", "--imageset", paths["sweeps"],
             "--data-path", paths["data_path"], "--num-samples", str(n),
             "--thresh", repr(thresh), "--seed", str(SEED), "--work-dir",
             work]),
        {"msda_fwd": 16 * n, "trilinear_cf_fwd": n,
         "trilinear_cf_fwd.rows": n, "trilinear_cf_fwd.plane": 0})
    with open(os.path.join(work, "scene.ply")) as f:
        header = [f.readline() for _ in range(3)][2].split()
    if len(r["voxels"]) != n or int(header[-1]) != sum(r["voxels"]) or \
            r["points"] != sum(r["voxels"]):
        raise AssertionError(f"scene.ply {header}, frames {r['voxels']}, "
                             f"points {r['points']}")
    log(f"  vis_3d_scene: {n} keyframes (fabricated in {fab_s:.1f}s), "
        f"voxels {r['voxels']} = scene.ply's {header[-1]}; forward_occ "
        f"{r['occ_s']:.3f}s, writes {r['write_s']:.3f}s, wall {wall:.1f}s, "
        f"peak {peak:.2f} GiB")
    return {"wall_s": wall, "fabricate_s": fab_s, "voxels": r["voxels"],
            "points": r["points"], "occ_s": r["occ_s"],
            "write_s": r["write_s"], "max_memory_gb": peak,
            "launches": counts}


def vis_phase(device):
    """The vis tools at ``nuscenes_occ``'s full width, seeded weights:
    ``vis_pics`` (novel view), ``vis_3d --gt``, ``vis_3d_scene`` on a
    fabricated scene walk and ``generate_videos`` on ``vis_pics``'s PNGs,
    in a temporary directory (removed after)."""
    import tempfile
    from selfocc_tpu_torch import generate_videos
    log(f"  card: {card_name()}")
    res = {}
    with tempfile.TemporaryDirectory(prefix="selfocc_vis_") as tmp:
        pics = os.path.join(tmp, "pics")
        res["vis_pics"] = vis_pics_path(device, pics)
        res["vis_3d"], thresh = vis_3d_path(device, os.path.join(tmp, "occ"))
        res["vis_3d_scene"] = vis_scene_path(
            device, os.path.join(tmp, "scene"), tmp, thresh)
        video = os.path.join(tmp, "demo.mp4")
        t0 = time.time()
        r = generate_videos.main(["--src-dir", pics, "--out", video])
        size = os.path.getsize(video)
        if r["frames"] != 1 or size <= 0:
            raise AssertionError(f"generate_videos: {r}, {size} bytes")
        res["generate_videos"] = dict(r, bytes=size,
                                      wall_s=time.time() - t0)
        log(f"  generate_videos: {r['frames']} frame {r['size']} -> "
            f"{size} bytes in {res['generate_videos']['wall_s']:.2f}s")
    return res


DP_STEPS = 4          # timed steps after [dp]'s checked one


def dp_wrappers():
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    return (rw.neus_render_fwd, rw.neus_render_bwd,
            interp.trilinear_cf_with_grad_fwd, interp.trilinear_bwd,
            msda.msda_fwd, msda.msda_bwd)


def dp_step_times(trainer, batch, gen, steps):
    """Host seconds (synchronised) of ``steps`` training steps, with each
    step's split; the peak GiB allocated by this process in them."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    out = []
    for i in range(steps):
        t0 = time.perf_counter()
        m = trainer.step(batch, gen(i), sync=torch.cuda.synchronize)
        check_finite_metrics(m)
        out.append(dict(step_s=time.perf_counter() - t0, **m["times"]))
    return out, torch.cuda.max_memory_allocated() / 2**30


def dp_rank_run(group):
    """One rank of [dp]'s data-parallel step at ``nuscenes_occ``'s full
    width (run by ``parallel.mesh.spawn``): rank 0's weights broadcast as
    the driver does, item ``rank`` of the synthetic set, one step with the
    counts set to 0 just before it and read after (each kernel of the step
    must launch on every rank), the tensors this rank gave
    ``all_reduce_mean`` (its own gradients, losses and BatchNorm
    statistics) caught, then ``DP_STEPS`` timed steps."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.parallel.mesh import broadcast_
    from selfocc_tpu_torch.train import build_trainer, step_seed
    from selfocc_tpu_torch.utils import train_lib
    from selfocc_tpu_torch.utils.runtime import (get_dataset, resolve_device,
                                                 to_device)
    device = resolve_device("cuda", group.device.index)
    cfg = get_config("nuscenes_occ")
    trainer = build_trainer(cfg, SEED, device, group=group)
    broadcast_(list(trainer.model.parameters()) + trainer.running_stats(),
               group)
    batch = to_device(get_dataset(cfg, synthetic=True, length=2)[group.rank],
                      device)
    caught = {"reduce_s": []}
    reduce = train_lib.all_reduce_mean

    def catching(tensors, grp, *args, **kwargs):
        if "local" not in caught:
            caught["local"] = [t.detach().cpu().clone() for t in tensors]
        caught["bytes"] = sum(t.numel() * t.element_size() for t in tensors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(tensors, grp, *args, **kwargs)
        torch.cuda.synchronize()
        caught["reduce_s"].append(time.perf_counter() - t0)
    train_lib.all_reduce_mean = catching

    def gen(step):
        return torch.Generator(device=device).manual_seed(
            step_seed(SEED, step, group.rank))
    wrappers = dp_wrappers()
    reset_counts(wrappers)
    m = trainer.step(batch, gen(0), sync=torch.cuda.synchronize)
    check_finite_metrics(m)
    launches = read_counts(wrappers, f"rank {group.rank}'s data-parallel "
                           "step", ("plane", "rows"))
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    res = {"launches": launches, "local": caught["local"],
           "n_params": len(params),
           "losses": ["total"] + sorted(k for k in m if k not in (
               "total", "grad_norm", "lr", "times")),
           "metrics": {k: float(v) for k, v in m.items() if k != "times"},
           "params": [p.detach().cpu().clone() for p in params],
           "stats": [s.cpu().clone() for s in trainer.running_stats()]}
    res["steps"], res["max_memory_gb"] = dp_step_times(
        trainer, batch, lambda i: gen(i + 1), DP_STEPS)
    res["reduce_s"], res["reduce_bytes"] = caught["reduce_s"][1:], \
        caught["bytes"]
    return res


def spread(xs):
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}


def dp_reference(device, r0, r1):
    """The checks of [dp]'s two-rank step against one process: both ranks'
    parameters bit-equal, and within 1e-5 of each tensor's max of one
    optimizer step on the mean of the ranks' own gradients; the averaged
    losses the mean of the ranks' own (rtol 1e-5); the statistics the mean
    of the ranks' own updates. Returns the reference trainer (its step
    taken) and the errors."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.train import build_trainer
    n = r0["n_params"]
    differ = [i for i, (a, b) in enumerate(zip(r0["params"], r1["params"]))
              if not torch.equal(a, b)]
    if differ or n != r1["n_params"]:
        raise AssertionError(f"the ranks' parameters differ after the step "
                             f"(tensors {differ[:8]} of {n})")
    trainer = build_trainer(get_config("nuscenes_occ"), SEED, device)
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    for p, g0, g1 in zip(params, r0["local"][:n], r1["local"][:n]):
        p.grad = (g0.to(device) + g1.to(device)) / 2
    norm, _ = trainer.apply_gradients()
    param_err, bitwise = 0.0, True
    for p, got in zip(params, r0["params"]):
        ref = p.detach().cpu()
        err = max_err(got, ref) / max(float(ref.abs().max()), 1e-30)
        param_err = max(param_err, err)
        bitwise = bitwise and torch.equal(got, ref)
    if param_err > 1e-5:
        raise AssertionError(f"two-rank step against one process's step on "
                             f"the mean gradient: {param_err:.3e} of a "
                             "tensor's max > 1e-5")
    loss_err = 0.0
    for k, l0, l1 in zip(r0["losses"], r0["local"][n + 1], r1["local"][
            n + 1]):
        mean = float((l0 + l1) / 2)
        loss_err = max(loss_err, abs(r0["metrics"][k] - mean) / abs(mean))
    if loss_err > 1e-5:
        raise AssertionError(f"averaged losses vs the ranks' mean: "
                             f"{loss_err:.3e} > rtol 1e-5")
    norm_err = abs(float(norm) - r0["metrics"]["grad_norm"]) / float(norm)
    if norm_err > 1e-5:
        raise AssertionError(f"grad_norm {r0['metrics']['grad_norm']} vs "
                             f"the mean gradient's {float(norm)}")
    stats_err = 0.0
    for got, s0, s1 in zip(r0["stats"], r0["local"][n + 2:],
                           r1["local"][n + 2:]):
        stats_err = max(stats_err, max_err(got, (s0 + s1) / 2))
    if stats_err > 0 or not all(torch.equal(a, b) for a, b in
                                zip(r0["stats"], r1["stats"])):
        raise AssertionError(f"BatchNorm statistics: the ranks' mean "
                             f"{stats_err:.3e} away, or ranks differ")
    log(f"  two ranks, one step on items 0 and 1: parameters bit-equal "
        f"across ranks; against one process's step on the mean gradient "
        f"{param_err:.3e} of a tensor's max"
        + (" (bit-equal)" if bitwise else "")
        + f"; averaged losses vs the ranks' mean {loss_err:.3e}; grad_norm "
        f"{norm_err:.3e}; {len(r0['stats'])} BatchNorm statistics the "
        "ranks' mean, bit for bit")
    return trainer, {"param_rel_err": param_err, "param_bitwise": bitwise,
                     "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
                     "stats_max_abs_err": stats_err}


def dp_sync_check(trainer, batch, gen, device):
    """A warm step of ``trainer`` in a one-rank NCCL group under
    ``set_sync_debug_mode("error")``."""
    import tempfile
    import torch
    from selfocc_tpu_torch.parallel.mesh import close, init_group
    with tempfile.TemporaryDirectory() as tmp:
        group = init_group("nccl", 0, 1, device,
                           f"file://{os.path.join(tmp, 'store')}")
        trainer.group = group
        try:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                m = trainer.step(batch, gen)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            check_finite_metrics(m)
        finally:
            trainer.group = None
            close(group)
    log("  a one-rank NCCL group's warm step under "
        "set_sync_debug_mode('error'): no synchronising call")


def dp_train_main(device):
    """``train.main --dp`` for 2 steps at ``nuscenes_occ``'s full width
    (synthetic): NCCL over every visible card, one a rank; with one card
    the plain step in this process, whose launches are counted. Fails
    unless the checkpoint counts 2 steps and, with several cards, the
    ranks ended bit-equal."""
    import tempfile
    import torch
    from selfocc_tpu_torch import train
    n = torch.cuda.device_count()
    wrappers = dp_wrappers()
    with tempfile.TemporaryDirectory() as work:
        reset_counts(wrappers)
        t0 = time.time()
        out = train.main(["--py-config", "nuscenes_occ", "--synthetic",
                          "--dp", "--max-steps", "2", "--print-freq", "1",
                          "--work-dir", work])
        wall = time.time() - t0
        state = torch.load(os.path.join(work, "ckpts", "latest.pt"),
                           map_location="cpu")
        if state["step"] != 2 or state["last_iter"] != 2 * n:
            raise AssertionError(f"--dp checkpoint: step {state['step']}, "
                                 f"item {state['last_iter']}")
        del state
    res = {"cards": n, "wall_s": wall, "step_s": out["step_s"]}
    if n == 1:
        res["launches"] = read_counts(wrappers, "train.main --dp run",
                                      ("plane", "rows"))
    elif out.get("replicas_equal") is not True:
        raise AssertionError(f"train.main --dp over {n} cards: ranks not "
                             "bit-equal")
    log(f"  train.main --dp: {n} card(s), "
        + ("the plain step (one card)" if n == 1 else
           f"{n} NCCL ranks, bit-equal at the end")
        + f"; 2 steps in {wall:.1f}s (build and items included)")
    torch.cuda.empty_cache()
    return res


def dp_eval(device):
    """One ``nuscenes_occ`` eval frame and one occupancy query (the
    512 x 512 x 40 grid at 0.2 m, sdf and logits) on one device, on
    ``[cuda:0, cuda:0]`` and on every visible card: the prepare with its
    cameras split, then the render and the query of the one-device volume,
    each within 1e-6 of the largest one-device value (bit-equal where
    said), with the sharded frame's launches counted; then the same frame
    again, timed warm (the first call on another card copies the model
    there and loads its kernels): render seconds sharded and not."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.eval_depth import build_model
    from selfocc_tpu_torch.ops import interp, msda
    from selfocc_tpu_torch.ops import render_weights as rw
    from selfocc_tpu_torch.utils.eval_lib import (ChunkedRenderer,
                                                  GridOccEvaluator,
                                                  eval_ray_grid,
                                                  eval_trans_mats,
                                                  rays_for_cams)
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("nuscenes_occ")
    model = build_model(cfg, SEED, device)
    batch = to_device(get_dataset(cfg, synthetic=True, phase="val",
                                  length=1)[0], device)
    origin, direction = rays_for_cams(eval_trans_mats(batch, cfg),
                                      eval_ray_grid(cfg, device=device))
    sync = torch.cuda.synchronize

    def sharded(devices):
        """prepare, then the render and the query of ``volume`` (default:
        the prepared one) on ``devices``, timed"""
        r = ChunkedRenderer(model, chunk=CHUNK, outputs=("depth",),
                            devices=devices, prepare_shard=True)
        ev = GridOccEvaluator(model, devices=devices)

        def frame(volume=None):
            sync()
            t0 = time.perf_counter()
            vol = r.prepare(batch["imgs"], batch["lidar2img"])
            sync()
            t1 = time.perf_counter()
            volume = vol if volume is None else volume
            depth = r.render_device(volume, origin, direction)["depth"]
            sync()
            t2 = time.perf_counter()
            grid = ev.query_grid_device(volume, OPENOCC_PCR, 0.2,
                                        keys=("sdf", "logits"))
            sync()
            return vol, depth, grid, {"prepare_s": t1 - t0,
                                      "render_s": t2 - t1,
                                      "query_s": time.perf_counter() - t2}
        return frame

    one = sharded(None)
    one()                                          # warm
    vol, depth, grid, one_s = one()
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    res = {"one_device": one_s}
    wrappers = (rw.neus_render_fwd, interp.trilinear_cf_with_grad_fwd,
                interp.trilinear_cf_fwd, msda.msda_fwd)
    for tag, devices in (("cuda0_twice", [device, device]),
                         ("all_cards", cards)):
        frame = sharded(devices)
        reset_counts(wrappers)
        svol, sdepth, sgrid, cold = frame(volume=vol)
        launches = read_counts(
            wrappers, f"sharded frame ({tag})", (),
            ("trilinear_cf_with_grad_fwd.plane", "trilinear_cf_fwd.rows"))
        errs = {"prepare": max_err(svol, vol) / float(vol.abs().max()),
                "render": max_err(sdepth, depth) / float(depth.abs().max())}
        bits = {"prepare": torch.equal(svol, vol),
                "render": torch.equal(sdepth, depth)}
        for k in grid:
            errs[f"query_{k}"] = max_err(sgrid[k], grid[k]) / float(
                grid[k].abs().max())
            bits[f"query_{k}"] = torch.equal(sgrid[k], grid[k])
        del svol, sdepth, sgrid
        secs = frame(volume=vol)[3]
        bad = {k: e for k, e in errs.items() if e > 1e-6}
        log(f"  sharded eval over {[str(d) for d in devices]}: largest "
            "difference from one device, over its largest value: "
            + ", ".join(f"{k} {e:.3e}" + (" (bit-equal)" if bits[k] else "")
                        for k, e in errs.items())
            + f"; warm: prepare {secs['prepare_s']:.3f}s, render "
            f"{secs['render_s']:.3f}s, query {secs['query_s']:.3f}s "
            f"sharded; {one_s['prepare_s']:.3f}s, {one_s['render_s']:.3f}s, "
            f"{one_s['query_s']:.3f}s on one device (first call: render "
            f"{cold['render_s']:.3f}s, query {cold['query_s']:.3f}s)")
        if bad:
            raise AssertionError(f"sharded eval ({tag}) differs beyond 1e-6 "
                                 f"relative: {bad}")
        res[tag] = {"devices": [str(d) for d in devices], "rel_err": errs,
                    "bitwise": bits, "launches": launches, "first": cold,
                    **secs}
    del model, vol, depth, grid
    torch.cuda.empty_cache()
    return res


def dp_phase(device):
    """[dp]: data-parallel training at ``nuscenes_occ``'s full width and
    the sharded eval. Two gloo ranks on the one card (NCCL refuses two
    ranks on one device) take one step on items 0 and 1 and are held to
    one process (``dp_reference``), then time ``DP_STEPS`` steps; the
    one-rank step is timed beside them and sync-checked in a one-rank NCCL
    group; ``train.main --dp`` runs 2 steps over NCCL on every visible
    card; ``dp_eval``."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.parallel.mesh import spawn
    from selfocc_tpu_torch.train import step_seed
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    log(f"  card: {card_name()}; {torch.cuda.device_count()} visible")
    log("  backend: gloo (two ranks on one card; NCCL refuses two ranks on "
        "one device)")
    torch.cuda.empty_cache()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.time()
    r0, r1 = spawn(dp_rank_run, 2, "gloo", [device, device])
    spawn_s = time.time() - t0
    log(f"  two ranks spawned, built, stepped {DP_STEPS + 1} times and "
        f"joined in {spawn_s:.1f}s")
    trainer, checks = dp_reference(device, r0, r1)
    batch = to_device(get_dataset(get_config("nuscenes_occ"), synthetic=True,
                                  length=1)[0], device)

    def gen(step):
        return torch.Generator(device=device).manual_seed(
            step_seed(SEED, step))
    one, one_peak = dp_step_times(trainer, batch, gen, DP_STEPS + 1)
    one = one[1:]
    dp_sync_check(trainer, batch, gen(DP_STEPS + 1), device)
    del trainer
    torch.cuda.empty_cache()
    two = [s for r in (r0, r1) for s in r["steps"]]
    reduce_s = [t for r in (r0, r1) for t in r["reduce_s"]]
    res = {
        "backend_one_card": "gloo", "cards": torch.cuda.device_count(),
        "spawn_wall_s": spawn_s, "checks": checks,
        "one_rank_step_s": spread([s["step_s"] for s in one]),
        "two_rank_step_s": spread([s["step_s"] for s in two]),
        "all_reduce_s": spread(reduce_s),
        "all_reduce_bytes": r0["reduce_bytes"],
        "peak_gb": {"one_rank": one_peak, "rank0": r0["max_memory_gb"],
                    "rank1": r1["max_memory_gb"]},
        "launches_rank0": r0["launches"], "launches_rank1": r1["launches"],
        "steps_one_rank": one, "steps_two_ranks": two}
    log(f"  step s (median, min-max): one rank "
        f"{res['one_rank_step_s']['median']:.3f} "
        f"({res['one_rank_step_s']['min']:.3f}-"
        f"{res['one_rank_step_s']['max']:.3f}); two gloo ranks on one card "
        f"{res['two_rank_step_s']['median']:.3f} "
        f"({res['two_rank_step_s']['min']:.3f}-"
        f"{res['two_rank_step_s']['max']:.3f}); all-reduce "
        f"{res['all_reduce_s']['median'] * 1e3:.1f} ms "
        f"({res['all_reduce_s']['min'] * 1e3:.1f}-"
        f"{res['all_reduce_s']['max'] * 1e3:.1f}) of "
        f"{res['all_reduce_bytes'] / 2**20:.1f} MiB a step; peak GiB: "
        f"one rank {one_peak:.2f}, ranks {r0['max_memory_gb']:.2f} / "
        f"{r1['max_memory_gb']:.2f}")
    res["train_main"] = dp_train_main(device)
    res["eval"] = dp_eval(device)
    return res


MP_STEPS = 3          # timed steps after [mp]'s checked and timed-collective ones


def mp_rank_shapes(world=2, rank=0):
    """The MSDA calls of ``nuscenes_occ``'s model-parallel step on ``rank``
    of ``world`` (``msda_case``'s B, Q, shapes, P): the hw- and zh-plane
    cross-attention on the rank's rows, the self-attention's rows of the
    three planes against the whole sequence."""
    from selfocc_tpu_torch.parallel.mesh import split_rows
    hw, zh = (b - a for a, b in (split_rows(n, world)[rank]
                                 for n in (66049, 6425)))
    return (("mp_cross", (6, hw, FPN_SHAPES, 8)),
            ("mp_zh", (6, zh, FPN_SHAPES, 48)),
            ("mp_self", (1, hw + 2 * zh, ((257, 257), (25, 257), (257, 25)),
                         12)))


def timed_collectives(records):
    """Wrap the model-parallel step's collectives (``parallel.mesh``'s
    ``_gather`` and ``_scatter_sum``, ``utils/train_lib``'s
    ``all_reduce_sum`` of the gradients) so that each call is synchronised
    and timed: its kind, ms and the bytes of its buffer go to
    ``records``. Returns the function that restores them."""
    import torch
    from selfocc_tpu_torch.parallel import mesh
    from selfocc_tpu_torch.utils import train_lib
    saved = (mesh._gather, mesh._scatter_sum, train_lib.all_reduce_sum)

    def rows_bytes(args, out):
        t, rows = args
        n = rows.n if rows.route == "all_reduce" else \
            rows.group.world * rows.width
        return n * t[0, 0].numel() * t.element_size()

    def flat_bytes(args, out):
        return sum(t.numel() * t.element_size() for t in args[0])

    def timing(kind, fn, nbytes):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            records.append({"kind": kind, "bytes": nbytes(args, out),
                            "ms": (time.perf_counter() - t0) * 1e3})
            return out
        return call

    mesh._gather = timing("gather_rows", saved[0], rows_bytes)
    mesh._scatter_sum = timing("gather_rows backward", saved[1], rows_bytes)
    train_lib.all_reduce_sum = timing("gradient all-reduce", saved[2],
                                      flat_bytes)

    def restore():
        mesh._gather, mesh._scatter_sum, train_lib.all_reduce_sum = saved
    return restore


def catch_gradients(trainer, caught):
    """Patch ``utils/train_lib.clip_by_global_norm`` to put the gradients
    the optimizer is given (by name, on the host) into ``caught`` once;
    returns the function that restores it."""
    from selfocc_tpu_torch.utils import train_lib
    clip = train_lib.clip_by_global_norm

    def catching(params, max_norm):
        if "grads" not in caught:
            caught["grads"] = {n: p.grad.detach().cpu().clone() for n, p in
                               trainer.model.named_parameters()
                               if p.grad is not None}
        return clip(params, max_norm)
    train_lib.clip_by_global_norm = catching

    def restore():
        train_lib.clip_by_global_norm = clip
    return restore


def mp_rank_run(group):
    """One rank of [mp]'s model-parallel step at ``nuscenes_occ``'s full
    width (run by ``parallel.mesh.spawn``): rank 0's weights broadcast as
    the driver does, synthetic item 0 and the plain step's generator on
    every rank; one step with the counts set to 0 just before it and read
    after, its summed gradients and updated parameters caught; one step
    with each collective timed; ``MP_STEPS`` timed steps; one profiled
    step; the ranks' parameters and statistics compared bit for bit."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.parallel.mesh import broadcast_, replicas_equal
    from selfocc_tpu_torch.train import build_trainer, step_seed
    from selfocc_tpu_torch.utils.runtime import (get_dataset, resolve_device,
                                                 to_device)
    device = resolve_device("cuda", group.device.index)
    cfg = get_config("nuscenes_occ")
    trainer = build_trainer(cfg, SEED, device, group=group,
                            model_parallel=True)
    replicated = list(trainer.model.parameters()) + trainer.running_stats()
    broadcast_(replicated, group)
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)

    def gen(step):
        return torch.Generator(device=device).manual_seed(
            step_seed(SEED, step))
    caught = {}
    restore = catch_gradients(trainer, caught)
    wrappers = dp_wrappers()
    try:
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        m = trainer.step(batch, gen(0), sync=torch.cuda.synchronize)
        launches = read_counts(wrappers, f"rank {group.rank}'s "
                               "model-parallel step", ("plane", "rows"))
    finally:
        restore()
    check_finite_metrics(m)
    res = {"launches": launches, "grads": caught["grads"],
           "first_step_peak_gb": torch.cuda.max_memory_allocated() / 2**30,
           "metrics": {k: float(v) for k, v in m.items() if k != "times"},
           "params": {n: p.detach().cpu().clone()
                      for n, p in trainer.model.named_parameters()},
           "rows": [r.count for r in trainer.shard.planes],
           "route": trainer.shard.route}
    records = []
    restore = timed_collectives(records)
    try:
        trainer.step(batch, gen(1), sync=torch.cuda.synchronize)
    finally:
        restore()
    res["collectives"] = records
    res["steps"], res["max_memory_gb"] = dp_step_times(
        trainer, batch, lambda i: gen(i + 2), MP_STEPS)
    step_s = spread([s["step_s"] for s in res["steps"]])["median"]
    res["profile"] = profile_step(trainer, batch, gen(MP_STEPS + 2), step_s)
    res["replicas_equal"] = replicas_equal(replicated, group)
    return res


def mp_reference(device, r0, r1):
    """The checks of [mp]'s two-rank step against one process's step on
    the same item, weights and generator: the ranks' parameters bit-equal,
    the losses and ``total`` rtol 1e-5, every gradient within 1e-4 of its
    max + 1e-7, ``grad_norm`` rtol 1e-4, the updated parameters within
    2e-5 + 1e-4 of their value. Returns the reference trainer (its step
    taken) and the errors."""
    import torch
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.train import build_trainer, step_seed
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    differ = [n for n in r0["params"]
              if not torch.equal(r0["params"][n], r1["params"][n])]
    if differ or set(r0["grads"]) != set(r1["grads"]):
        raise AssertionError(f"the ranks' parameters differ after the "
                             f"model-parallel step: {differ[:8]}")
    cfg = get_config("nuscenes_occ")
    trainer = build_trainer(cfg, SEED, device)
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)
    caught = {}
    restore = catch_gradients(trainer, caught)
    try:
        m = trainer.step(batch, torch.Generator(device=device).manual_seed(
            step_seed(SEED, 0)), sync=torch.cuda.synchronize)
    finally:
        restore()
    ref = {k: float(v) for k, v in m.items() if k != "times"}
    loss_err = max(abs(r0["metrics"][k] - v) / abs(v)
                   for k, v in ref.items() if k not in ("grad_norm", "lr"))
    norm_err = abs(r0["metrics"]["grad_norm"] - ref["grad_norm"]) / \
        ref["grad_norm"]
    if set(caught["grads"]) != set(r0["grads"]):
        raise AssertionError("the ranks' gradients are not one process's "
                             "parameters'")
    grad_ratio, worst = 0.0, None
    for n, g in caught["grads"].items():
        tol = 1e-4 * float(g.abs().max()) + 1e-7
        ratio = max_err(r0["grads"][n], g) / tol
        if ratio > grad_ratio:
            grad_ratio, worst = ratio, n
    param_ratio = 0.0
    for n, p in trainer.model.named_parameters():
        p = p.detach().cpu()
        excess = ((r0["params"][n].double() - p.double()).abs()
                  / (2e-5 + 1e-4 * p.double().abs())).max()
        param_ratio = max(param_ratio, float(excess))
    log(f"  two ranks against one process, one step on item 0: losses "
        f"{loss_err:.3e} (rtol 1e-5), grad_norm {norm_err:.3e} (rtol "
        f"1e-4), gradients at {grad_ratio:.3f} of their tolerance (worst "
        f"{worst}), updated parameters at {param_ratio:.3f} of theirs; "
        f"ranks bit-equal")
    if loss_err > 1e-5 or norm_err > 1e-4 or grad_ratio > 1 or \
            param_ratio > 1:
        raise AssertionError("the model-parallel step differs from one "
                             "process's beyond its tolerance")
    return trainer, batch, {
        "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
        "grad_err_over_tol": grad_ratio, "grad_worst": worst,
        "param_err_over_tol": param_ratio}


def mp_sync_check(trainer, batch, device):
    """A warm model-parallel step of ``trainer`` in a one-rank NCCL group
    (after one step that builds it) under ``set_sync_debug_mode("error")``;
    the trainer is the plain one again after."""
    import tempfile
    import torch
    from selfocc_tpu_torch.parallel.mesh import close, init_group
    from selfocc_tpu_torch.train import step_seed
    with tempfile.TemporaryDirectory() as tmp:
        group = init_group("nccl", 0, 1, device,
                           f"file://{os.path.join(tmp, 'store')}")
        trainer.group, trainer.model_parallel = group, True
        trainer.shard = trainer.model.model_shard(group)
        try:
            for step, checked in ((100, False), (101, True)):
                gen = torch.Generator(device=device).manual_seed(
                    step_seed(SEED, step))
                torch.cuda.synchronize()
                if checked:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    m = trainer.step(batch, gen)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                check_finite_metrics(m)
        finally:
            trainer.group, trainer.model_parallel = None, False
            trainer.shard = None
            close(group)
    log("  a one-rank NCCL group's warm model-parallel step under "
        "set_sync_debug_mode('error'): no synchronising call")


def mp_train_main(device):
    """``train.main --mp`` for 2 steps at ``nuscenes_occ``'s full width
    (synthetic): NCCL over every visible card, one a rank, every rank on
    the step's one item; with one card the plain step in this process,
    whose launches are counted. Fails unless the checkpoint counts 2 steps
    and 2 items and, with several cards, the ranks ended bit-equal."""
    import tempfile
    import torch
    from selfocc_tpu_torch import train
    n = torch.cuda.device_count()
    wrappers = dp_wrappers()
    with tempfile.TemporaryDirectory() as work:
        reset_counts(wrappers)
        t0 = time.time()
        out = train.main(["--py-config", "nuscenes_occ", "--synthetic",
                          "--mp", "--max-steps", "2", "--print-freq", "1",
                          "--work-dir", work])
        wall = time.time() - t0
        state = torch.load(os.path.join(work, "ckpts", "latest.pt"),
                           map_location="cpu")
        if state["step"] != 2 or state["last_iter"] != 2:
            raise AssertionError(f"--mp checkpoint: step {state['step']}, "
                                 f"item {state['last_iter']}")
        del state
    res = {"cards": n, "wall_s": wall, "step_s": out["step_s"]}
    if n == 1:
        res["launches"] = read_counts(wrappers, "train.main --mp run",
                                      ("plane", "rows"))
    elif out.get("replicas_equal") is not True:
        raise AssertionError(f"train.main --mp over {n} cards: ranks not "
                             "bit-equal")
    log(f"  train.main --mp: {n} card(s), "
        + ("the plain step (one card)" if n == 1 else
           f"{n} NCCL ranks, bit-equal at the end")
        + f"; 2 steps in {wall:.1f}s (build and items included)")
    torch.cuda.empty_cache()
    return res


def collective_summary(records):
    """Per kind of collective: calls, ms (median, spread, sum) and bytes
    (per call, sum) of one step."""
    out = {}
    for kind in sorted({r["kind"] for r in records}):
        rs = [r for r in records if r["kind"] == kind]
        out[kind] = {"calls": len(rs), "ms": spread([r["ms"] for r in rs]),
                     "ms_sum": sum(r["ms"] for r in rs),
                     "bytes": sorted({r["bytes"] for r in rs}),
                     "bytes_sum": sum(r["bytes"] for r in rs)}
    return out


def mp_phase(device):
    """[mp]: the model-parallel step at ``nuscenes_occ``'s full width. Two
    gloo ranks on the one card take one step on item 0 and are held to
    one process's (``mp_reference``), then time their collectives,
    ``MP_STEPS`` steps and a profiled one; the one-process step is timed
    beside them; ``msda_fwd`` / ``msda_bwd`` at rank 0's sharded shapes;
    the one-rank NCCL step under the sync check; ``train.main --mp``."""
    import torch
    from selfocc_tpu_torch.parallel.mesh import spawn
    from selfocc_tpu_torch.train import step_seed
    log(f"  card: {card_name()}; {torch.cuda.device_count()} visible")
    log("  backend: gloo (two ranks on one card; NCCL refuses two ranks on "
        "one device), gather_rows by its all-reduce route")
    torch.cuda.empty_cache()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.time()
    r0, r1 = spawn(mp_rank_run, 2, "gloo", [device, device])
    spawn_s = time.time() - t0
    log(f"  two ranks spawned, built, stepped {MP_STEPS + 3} times and "
        f"joined in {spawn_s:.1f}s; rows a rank (hw, zh, wz): "
        f"{r0['rows']} / {r1['rows']}, route {r0['route']}")
    if not (r0["replicas_equal"] and r1["replicas_equal"]):
        raise AssertionError("[mp] ranks not bit-equal after their steps")
    trainer, batch, checks = mp_reference(device, r0, r1)
    del r0["grads"], r0["params"], r1["grads"], r1["params"]

    def gen(step):
        return torch.Generator(device=device).manual_seed(
            step_seed(SEED, step))
    one, one_peak = dp_step_times(trainer, batch, lambda i: gen(i + 1),
                                  MP_STEPS)
    mp_sync_check(trainer, batch, device)
    del trainer, batch
    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(SEED)
    msda = {}
    for tag, args in mp_rank_shapes():
        fwd, bwd = msda_records(g, device, tag, args)
        msda[tag] = {"msda_fwd": fwd, "msda_bwd": bwd, "queries": args[1],
                     "cams": args[0]}
    two = [s for r in (r0, r1) for s in r["steps"]]
    res = {
        "backend_one_card": "gloo", "route": r0["route"],
        "cards": torch.cuda.device_count(), "spawn_wall_s": spawn_s,
        "rows_rank0": r0["rows"], "rows_rank1": r1["rows"],
        "checks": checks, "msda": msda,
        "one_process_step_s": spread([s["step_s"] for s in one]),
        "two_rank_step_s": spread([s["step_s"] for s in two]),
        "collectives_rank0": collective_summary(r0["collectives"]),
        "collectives_rank1": collective_summary(r1["collectives"]),
        "peak_gb": {"one_process": one_peak, "rank0": r0["max_memory_gb"],
                    "rank1": r1["max_memory_gb"],
                    "rank0_first_step": r0["first_step_peak_gb"],
                    "rank1_first_step": r1["first_step_peak_gb"]},
        "launches_rank0": r0["launches"], "launches_rank1": r1["launches"],
        "profile_rank0": r0["profile"], "profile_rank1": r1["profile"],
        "steps_one_process": one, "steps_two_ranks": two}
    coll = res["collectives_rank0"]
    log(f"  step s (median, min-max): one process "
        f"{res['one_process_step_s']['median']:.3f} "
        f"({res['one_process_step_s']['min']:.3f}-"
        f"{res['one_process_step_s']['max']:.3f}); two gloo ranks on one "
        f"card {res['two_rank_step_s']['median']:.3f} "
        f"({res['two_rank_step_s']['min']:.3f}-"
        f"{res['two_rank_step_s']['max']:.3f}); peak GiB: one process "
        f"{one_peak:.2f}, ranks {r0['max_memory_gb']:.2f} / "
        f"{r1['max_memory_gb']:.2f} (first step {r0['first_step_peak_gb']:.2f}"
        f" / {r1['first_step_peak_gb']:.2f})")
    for kind, c in coll.items():
        log(f"  rank 0, {kind}: {c['calls']} calls a step, "
            f"{c['ms']['median']:.1f} ms each ({c['ms']['min']:.1f}-"
            f"{c['ms']['max']:.1f}), {c['ms_sum']:.1f} ms and "
            f"{c['bytes_sum'] / 2**20:.1f} MiB a step (per call "
            f"{[round(b / 2**20, 2) for b in c['bytes']]} MiB)")
    res["train_main"] = mp_train_main(device)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="a checkout of another commit: [kernels] also times "
                    "its trilinear kernels at the main paths' points, "
                    "[frame] profiles its eval frame, [levers] times its "
                    "head-shared MSDA kernels and [head] its C = 1 point "
                    "instances of the trilinear backwards and its "
                    "neus_weights_bwd above 256 samples, in turns with "
                    "this checkout's")
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
    # the loaders' image decoder (selfocc_tpu_torch/native: g++ at first
    # import), built from the checkout's source as the kernels are; a
    # library another run left in the build directory goes first
    import os
    t0 = time.time()
    stale = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "selfocc_tpu_torch", "_build", "libselfocc_loader.so")
    if os.path.exists(stale):
        os.remove(stale)
    from selfocc_tpu_torch import native
    st = native.native_status()
    log(f"[build] image decoder: {st['decoder']} in {time.time() - t0:.1f}s"
        + (f" (cv2 because: {st['reason']})" if st["reason"] else ""))

    runs = {"kernels": lambda: dict(
                kernel_checks(device, args.baseline),
                weights_path_launches=weights_path(device)),
            "gather": lambda: gather_path(device),
            "frame": lambda: full_frame(device, args.baseline),
            "occ": lambda: occ_frame(device),
            "train-parity": lambda: train_parity(device),
            "train": lambda: dict(full_train(device),
                                  driver=train_driver_run(device)),
            "data": lambda: data_phase(device, phases.get("train")),
            "kitti": lambda: kitti_phase(device),
            "depth": lambda: depth_phase(device),
            "levers": lambda: levers_phase(device, args.baseline),
            "bev": lambda: bev_phase(device),
            "density": lambda: density_phase(device),
            "head": lambda: head_phase(device, args.baseline),
            "variants": lambda: variants_phase(device),
            "unet": lambda: unet_phase(device),
            "teacher": lambda: teacher_phase(device),
            "vis": lambda: vis_phase(device),
            "dp": lambda: dp_phase(device),
            "mp": lambda: mp_phase(device)}
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

    lres, bres, denres = phases["levers"], phases["bev"], phases["density"]
    hres, vres = phases["head"], phases["variants"]
    ures, teres = phases["unet"], phases["teacher"]
    kres = dict(phases["kernels"], gather_rows=phases["gather"],
                **lres["kernels"])
    # the alpha-input weights: the NeuS recipes' render is fused, so their
    # main path is the density head's; [kernels] holds the forward at the
    # eval chunk and weights_from_alpha's own path counts its launches
    kres["neus_weights_fwd"].update(
        launches_own_path=kres.pop("weights_path_launches"),
        **{f"density_{k}": v for k, v in
           denres["kernels"]["neus_weights_fwd"].items()})
    kres["neus_weights_bwd"] = denres["kernels"]["neus_weights_bwd"]
    recipe_launches = {
        "bev_steps": bres["train"]["launches"],
        "bev_eval_frame": bres["eval"]["frame"]["launches"],
        "bev_occ3d_frame": bres["eval"]["occ3d"]["launches"],
        "density_steps": denres["train"]["launches"],
        "density_eval_frame": denres["eval"]["frame"]["launches"],
        "density_occ3d_frame": denres["eval"]["occ3d"]["launches"],
        "variants_steps": vres["train"]["launches"],
        "variants_eval_frame": vres["eval"]["frame"]["launches"],
        "variants_occ3d_frame": vres["eval"]["occ3d"]["launches"],
        "variants_flow_head": vres["flow"]["launches"],
        "train_driver": phases["train"]["driver"]["launches"],
        "unet_steps": ures["train"]["launches"],
        "unet_eval_frame": ures["eval"]["frame"]["launches"],
        "teacher_train_driver": teres["train_main"]["launches"]}
    fres, tres, ores = phases["frame"], phases["train"], phases["occ"]
    dres, kires, depres = phases["data"], phases["kitti"], phases["depth"]
    data_launches = {
        "data_train": dres["train"]["launches"],
        "data_depth_frame": dres["eval"]["eval_depth"]["launches"],
        "data_occ_frame": dres["eval"]["eval_iou"]["launches"],
        "novel_raw": dres["novel"]["raw"]["launches"],
        "novel_max": dres["novel"]["max"]["launches"],
        "kitti_train": kires["train"]["launches"],
        "kitti_step": kires["train"]["launches_per_step"],
        "kitti_occ_frame": kires["occupancy"]["launches"],
        "kitti_novel_raw": kires["novel"]["raw"]["launches"],
        "kitti_novel_max": kires["novel"]["max"]["launches"],
        "kitti_raw_train": depres["kitti_raw_train"]["launches"],
        "kitti_raw_step": depres["kitti_raw_train"]["launches_per_step"],
        "kitti_raw_eval_raw": depres["kitti_raw_eval"]["raw"]["launches"],
        "kitti_raw_eval_flip": depres["kitti_raw_eval"]["flip"]["launches"],
        "kitti_raw_eval_max": depres["kitti_raw_eval"]["max"]["launches"],
        "nuscenes_depth_train":
            depres["nuscenes_depth_train"]["launches"]}
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
        "neus_weights_bwd": ("neus_weights.cu",
                             "selfocc_tpu/ops/render_pallas.py:76"),
        "trilinear_cf_with_grad_fwd": ("trilinear.cu",
                                       "selfocc_tpu/ops/interp.py:159"),
        "trilinear_bwd": ("trilinear.cu", "selfocc_tpu/ops/interp.py:159"),
        "trilinear_cf_fwd": ("trilinear.cu",
                             "selfocc_tpu/ops/interp.py:118"),
        "trilinear_cf_bwd": ("trilinear.cu",
                             "selfocc_tpu/ops/interp.py:118"),
        "msda_fwd": ("msda.cu", "selfocc_tpu/ops/msda.py:160"),
        "msda_bwd": ("msda.cu", "selfocc_tpu/ops/msda.py:160"),
        "msda_shared_fwd": ("msda_shared.cu",
                            "selfocc_tpu/ops/msda.py:275"),
        "msda_shared_bwd": ("msda_shared.cu",
                            "selfocc_tpu/ops/msda.py:275"),
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
            for kind in ("plane", "rows"):
                if f"{name}.{kind}" in counts:
                    entry[f"launches_{path}_{kind}"] = \
                        counts[f"{name}.{kind}"]
        if name in ("trilinear_cf_fwd", "trilinear_cf_bwd"):
            # the values-only kernels in the kitti_occ step: the compact
            # taps on the plane, the uniform grid in rows
            prefix = "values_" + name[len("trilinear_cf_"):] + "_"
            for kernel, k in kires["train"]["profile"][
                    "trilinear_kernels"].items():
                if kernel.startswith(prefix):
                    kind = kernel[len(prefix):-len("_kernel")]
                    entry[f"in_kitti_step_ms_per_call_{kind}"] = \
                        k["ms_per_call"]
                    entry[f"in_kitti_step_calls_{kind}"] = k["calls"]
        if name.startswith("msda_shared"):
            # their main path is the nuscenes_occ_fast recipe: its training
            # steps, and its eval frame for the forward
            fast = lres["fast_train"]
            entry["launches"] = fast["launches"][name]
            entry["launches_per_fast_step"] = \
                fast["launches_per_step"][name]
            entry["launches_fast_eval_frame"] = lres["frames"][
                "nuscenes_occ_fast"]["launches"].get(name, 0)
            in_step = fast["profile"]["msda_kernels"][name]
            entry["in_step_ms_per_call"] = in_step["ms_per_call"]
            entry["in_step_calls"] = in_step["calls"]
        for path, counts in recipe_launches.items():
            for key, n in counts.items():
                if key == name or key.startswith(name + "."):
                    entry["launches_" + path + key[len(name):].replace(
                        ".", "_")] = n
        if name in ("msda_fwd", "msda_bwd"):
            for tag, recs in list(bres["msda"].items()) + list(
                    ures["msda"].items()):
                for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                          "max_abs_err"):
                    entry[f"{tag}_{k}"] = recs[name][k]
        if name in ("trilinear_cf_fwd", "trilinear_cf_bwd"):
            # the values-only pair's other calls (the flow lookup, C = 3,
            # has its narrow instances' lines)
            for tag, recs in (("bev_uniform", bres["values"]),
                              ("density_query", denres["values"])):
                rec = recs[name]
                for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                          "library_ms", "library_device_ms", "max_abs_err",
                          "points"):
                    if k in rec:
                        entry[f"{tag}_{k}"] = rec[k]
        if name in ("neus_weights_fwd", "neus_weights_bwd"):
            # their main path: nuscenes_occ_density training
            entry["launches"] = denres["train"]["launches"][name]
            in_step = denres["train"]["profile"]["neus_render_kernels"][name]
            entry["in_density_step_ms_per_call"] = in_step["ms_per_call"]
            entry["in_density_step_calls"] = in_step["calls"]
        if name == "trilinear_cf_bwd":
            # its main path is kitti_occ training (values-only gradients)
            entry["launches"] = kires["train"]["launches"][name]
        if name == "trilinear_cf_fwd":
            # its main path is the occupancy eval: the Occ3D gather frame
            occ_l = {t: ores[t]["launches"] for t in
                     ("occ3d_gather", "occ3d_separable", "openocc")}
            entry["launches"] = occ_l["occ3d_gather"][name]
            entry.update({f"launches_{t}": v for t, v in occ_l.items()},
                         frame_checks=ores["kernel_vs_plain"])
        kernels.append(entry)
    # the instances of [head]: their main path is the importance recipe's
    # step (launches by instance in its 3 measured steps); the point
    # instance of trilinear_bwd at C > 1 (points_walk) has a line of its
    # own, trilinear_bwd.points holds the plane's
    imp_launches = hres["importance_train"]["launches"]
    opt_launches = hres["options_train"]["launches"]
    imp_step = hres["importance_train"]["profile"]["trilinear_kernels"]
    for name, inst, src, replaces, main, cases in (
            ("neus_weights_bwd", "tiled", "neus_weights.cu",
             "selfocc_tpu/ops/render_pallas.py:76", "4096x320", None),
            ("trilinear_bwd", "points", "trilinear.cu",
             "selfocc_tpu/ops/interp.py:159", "plane_step",
             ("plane", "plane_step")),
            ("trilinear_bwd", "points_walk", "trilinear.cu",
             "selfocc_tpu/ops/interp.py:159", "rows", ("rows",)),
            ("trilinear_cf_bwd", "points", "trilinear.cu",
             "selfocc_tpu/ops/interp.py:118", "288_step", None)):
        recs = {k: r for k, r in hres["kernels"][name].items()
                if isinstance(r, dict) and (cases is None or k in cases)}
        entry = {"name": f"{name}.{inst}", "route": "cuda",
                 "source": f"selfocc_tpu_torch/csrc/{src}",
                 "replaces": replaces,
                 "launches": imp_launches[f"{name}.{inst}"]}
        entry.update(recs[main])
        entry["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
        entry["cases"] = recs
        if f"{name}.{inst}" in opt_launches:
            entry["launches_options_steps"] = opt_launches[f"{name}.{inst}"]
        # the instance's kernel in the profiled importance step (the C = 1
        # point instances also launch the fold, which both share)
        step_kernel = {"points_walk": "trilinear_bwd_rows_points_kernel",
                       "points": name.replace("trilinear_cf", "values")
                       + "_plane_points_kernel"}.get(inst)
        if step_kernel in imp_step:
            entry["in_step_ms_per_call"] = imp_step[step_kernel]["ms_per_call"]
            entry["in_step_calls"] = imp_step[step_kernel]["calls"]
        if inst == "points" and "trilinear_plane_fold_kernel" in imp_step:
            fold = imp_step["trilinear_plane_fold_kernel"]
            entry["in_step_fold_ms_per_call"] = fold["ms_per_call"]
            entry["in_step_fold_calls"] = fold["calls"]
        kernels.append(entry)
    # trilinear_cf_bwd's walk instance (C = 25 here): its main path is the
    # density step's one query; the BEV step's uniform sdf grid and the
    # options step's chunks launch it too
    walk = {"name": "trilinear_cf_bwd.walk", "route": "cuda",
            "source": "selfocc_tpu_torch/csrc/trilinear.cu",
            "replaces": "selfocc_tpu/ops/interp.py:118",
            "launches": denres["train"]["launches"]["trilinear_cf_bwd.walk"],
            "launches_bev_steps": bres["train"]["launches"][
                "trilinear_cf_bwd.walk"],
            "launches_options_steps": opt_launches["trilinear_cf_bwd.walk"]}
    walk.update(denres["values"]["trilinear_cf_bwd"])
    walk["cases"] = {
        "density_query": denres["values"]["trilinear_cf_bwd"],
        "bev_uniform": bres["values"]["trilinear_cf_bwd"],
        "options_chunk": kres["trilinear_cf_bwd"]["options_chunk"]}
    walk["max_abs_err"] = max(r["max_abs_err"]
                              for r in walk["cases"].values())
    for path, r in (("density", denres["train"]), ("bev", bres["train"]),
                    ("options", hres["options_train"])):
        k = r["profile"]["trilinear_kernels"].get("values_bwd_walk_kernel")
        if k is not None:
            walk[f"in_{path}_step_ms_per_call"] = k["ms_per_call"]
            walk[f"in_{path}_step_calls"] = k["calls"]
    kernels.append(walk)
    # the values-only pair's narrow instances (C <= 3, "border" padding in
    # the kernel): their main path is the flow head's step ([variants]);
    # beside each, the walk it replaced at C = 3 in the same call, and the
    # backward's point instance on stand-ins of the step's points
    flow = vres["flow"]
    for name in ("trilinear_cf_fwd", "trilinear_cf_bwd"):
        entry = {"name": f"{name}.narrow", "route": "cuda",
                 "source": "selfocc_tpu_torch/csrc/trilinear.cu",
                 "replaces": "selfocc_tpu/ops/interp.py:118",
                 "launches": flow["launches"][f"{name}.narrow"]}
        entry.update(flow[name])
        in_step = flow["profile"][
            name.replace("trilinear_cf", "values") + "_narrow"]
        entry["in_step_ms_per_call"] = in_step["ms_per_call"]
        entry["in_step_calls"] = in_step["calls"]
        kernels.append(entry)
    # the vis tools' launches ([vis]) on every entry, and the [vis] records
    # of its kernels at the vis paths' own inputs
    visres = phases["vis"]
    for entry in kernels:
        key = {"gather_rows": "gather_rows_fwd"}.get(entry["name"],
                                                      entry["name"])
        for path in ("vis_pics", "vis_3d", "vis_3d_scene"):
            counts = visres[path]["launches"]
            entry[f"launches_{path}"] = counts.get(key, 0)
            for kind in ("plane", "rows"):
                if f"{key}.{kind}" in counts:
                    entry[f"launches_{path}_{kind}"] = counts[f"{key}.{kind}"]
        vis_recs = {
            "msda_fwd": visres["vis_pics"]["msda_fwd"],
            "trilinear_cf_with_grad_fwd": {
                "c25_chunk": visres["vis_pics"]["trilinear_c25"]},
            "trilinear_cf_fwd": {"grid": visres["vis_3d"]["trilinear_cf_fwd"]},
        }.get(entry["name"], {})
        for tag, rec in vis_recs.items():
            for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                      "max_abs_err", "points"):
                if k in rec:
                    entry[f"vis_{tag}_{k}"] = rec[k]
        if entry["name"] == "neus_render_fwd":
            entry["vis_subset_max_abs_err"] = visres["vis_pics"]["subset_err"]
    # [dp]: each rank's data-parallel step, train.main --dp (one card: in
    # this process) and the sharded eval frame on [cuda:0, cuda:0]
    dpres = phases["dp"]
    for entry in kernels:
        for path, counts in (
                ("dp_rank0", dpres["launches_rank0"]),
                ("dp_rank1", dpres["launches_rank1"]),
                ("dp_train_main", dpres["train_main"].get("launches", {})),
                ("dp_sharded_frame",
                 dpres["eval"]["cuda0_twice"]["launches"])):
            if entry["name"] in counts:
                entry[f"launches_{path}"] = counts[entry["name"]]
    # [mp]: each rank's model-parallel step, its profiled MSDA calls at the
    # sharded shapes, train.main --mp (one card: in this process) and the
    # MSDA records at rank 0's sharded shapes
    mpres = phases["mp"]
    for entry in kernels:
        for path, counts in (
                ("mp_rank0", mpres["launches_rank0"]),
                ("mp_rank1", mpres["launches_rank1"]),
                ("mp_train_main", mpres["train_main"].get("launches", {}))):
            if entry["name"] in counts:
                entry[f"launches_{path}"] = counts[entry["name"]]
        name = entry["name"]
        in_step = mpres["profile_rank0"]["msda_kernels"].get(name)
        if in_step is not None:
            entry["in_mp_step_ms_per_call"] = in_step["ms_per_call"]
            entry["in_mp_step_calls"] = in_step["calls"]
        for tag, recs in mpres["msda"].items():
            if name in recs:
                for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                          "max_abs_err"):
                    entry[f"{tag}_{k}"] = recs[name][k]
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
        "data": dres, "kitti": kires, "depth": depres,
        "levers": {k: v for k, v in lres.items() if k != "kernels"},
        "bev": bres, "density": {k: v for k, v in denres.items()
                                 if k != "kernels"},
        "head": {k: v for k, v in hres.items() if k != "kernels"},
        "variants": vres, "unet": ures, "teacher": teres, "vis": visres,
        "dp": dpres, "mp": mpres}),
        flush=True)
    print(card_name(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
