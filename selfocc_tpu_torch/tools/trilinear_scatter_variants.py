"""Build variants of ``csrc/trilinear.cu`` on the card and time the two
C = 25 cotangent scatters, the C = 1 point instances and the narrow
backward (C = 3, the flow head's border lookup) beside the shipped
kernels, at their main-path points.

The scatters are ``trilinear_cf_bwd`` at C = 25 (the values-only backward's
walk: the density step's one query, the options step's training chunks,
the BEV step's uniform sdf grid, with a random cotangent and with the
step's, whose sdf channel alone is live) and ``trilinear_bwd``'s point
instance at
C = 25 (the importance recipe's merged render, 4096 x 320 points). This
script rebuilds the source with one design choice undone at a time:

- ``shipped``: the source as it is;
- ``vector_flush``: the values-only walk flushes its corner rows through
  shared memory, each row a scalar head up to its first 16-byte boundary,
  float4 atomics and a scalar tail, shared by all 32 lanes (2 vector and 2
  scalar atomic instructions for 8 rows), in place of one scalar atomic a
  lane per row;
- ``pairs_without_runs``: a warp whose 32 points make 30 runs of one cell
  or more (a ballot) takes its (point, channel) pairs, 8 scalar atomics
  each, in place of the walk;
- ``unstaged``: the rows point instance loads each point's cotangent row
  at its step of the walk, not all 32 before it;
- ``fp32_chain``: no cell hot: the point instances' flushes from crowded
  cells as fp32 atomics on the gradient, like every other flush;
- ``hot_points_32``, ``hot_points_512``: a cell hot from 32 or 512
  points (kHotPoints; shipped: 128);
- ``plane_chains``: ``trilinear_bwd``'s C = 1 point instance by the
  point-free plane kernel's chains (``trilinear_bwd_plane_kernel<true>``,
  one lane walking each voxel's chain, flushed into the same fp64 plane) in
  place of the segments;
- ``shared_corners``: in the C = 1 point instances a segment's first lane
  loads the 8 corners and shuffles them to the rest, in place of each lane
  loading its own;
- ``occupancy_tiles``: the C = 1 point instances' blocks sized to one wave
  of resident blocks (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
  each taking as many tiles of 256 points as that leaves it, in place of
  kSegTiles (4) a block;
- ``tiles_1``, ``tiles_2``, ``tiles_8``: 1, 2 or 8 tiles a block (the
  table flushed after each 4);
- ``no_table``: the segments' sums as fp64 atomics straight into the
  plane, without the block's table in shared memory;
- ``narrow_walk``: no narrow instance (``kNarrowMax`` 0), so that C = 2
  and 3 with zeros padding take the walks (the gradient zeroed before the
  backward's, as the wrapper's fill did), as before the narrow instances
  (``chip_smoke.py [variants]`` times them on the flow lookup's clipped
  points with this library);
- ``narrow_scalar``: the narrow backward's segments flush each corner row
  as C scalar atomics straight into the (H, W, D, C) gradient (zeroed by
  the launcher; no scratch, no fold), in place of one float4 atomic into
  the (H, W, D, 4) scratch;
- ``narrow_float2``: the same, each row as one float2 atomic on its
  8-byte-aligned pair of channels and one scalar atomic;
- ``narrow_chains``: the narrow backward's segments flush by chains of
  consecutive segments that share a voxel (a warp's table of segment rows
  in shared memory; each chain's first segment sums it and makes its one
  float4 atomic), in place of 8 rows a segment;
- ``narrow_noscan``: no segments: every lane makes its own point's 8
  float4 atomics;
- ``narrow_noflush``, a timing probe and no design (its results are
  wrong and go unchecked): the narrow backward without its atomics, what
  the kernel costs besides them;
- ``narrow_table``: the narrow backward's segments flush into the block's
  hash table in shared memory (1024 slots of float4 sums, 8 probes, then
  a global atomic), as the C = 1 segments do, one block of 256 points; the
  block flushes its table with one float4 atomic a slot into the scratch.

The narrow variants are timed on the flow head's step (``chip_smoke.py``'s
``flow_head_setup`` and ``flow_lookup_inputs``: 7,372,800 unclipped ray
samples of a (257, 257, 25, 3) flow, border padding, a random cotangent),
the other variants at the cases above and below, not there.
The C = 1 point instances (the shipped segments into an fp64 plane, and the
variants above) are timed on the uniform stand-ins of ``chip_smoke.py``'s
``head_points`` and on the importance step's own points
(``chip_smoke.importance_step_points``): the plane instance at 4096 x 320
taps, the values-only one at the rounds' 4096 x 288 sdf queries (the sdf
channel read at row stride 25).

Each variant is swapped in for the port's own library, so the public
wrappers of ``ops/interp.py`` call it; each call is held against its plain
version (GRAD_RTOL of ``chip_smoke.py``) and timed by device time
(``chip_smoke.device_ms``) in two rounds, the variants in one order and
then the other; the point instances' cotangents are also held against
their plain versions in float64 (``chip_smoke.float64_check``'s distances;
the C = 1 instances at the importance points, the values-only one at the
six taps of 4096 x 320 samples). Results go to ``OUT/variants.json``.

    python3 selfocc_tpu_torch/tools/trilinear_scatter_variants.py [OUT [CASES]]

Run from the repository root on a machine with a CUDA card and ``nvcc``;
OUT defaults to ``work_dirs/trilinear_scatter_variants`` (git-ignored);
CASES, comma-separated prefixes of the cases' names (``points_c1``,
``values_points_c1``, ``values_c25``, ``values_c3_flow``, ...), times only
those.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, "selfocc_tpu_torch", "csrc", "trilinear.cu")

# the values-only walk's point-free flush, and the shared-memory float4
# flush that replaces it in ``vector_flush``
SCALAR_FLUSH = """              else
                atomicAdd(grad + static_cast<int64_t>(
                                     cur.base + corner_offset(k, W, D)) *
                                     C +
                              ch,
                          acc[k]);
            }
        }"""
VECTOR_FLUSH = """              else
                out |= 1u << k;
            }
        }
        if constexpr (!kPoints)
          if (cur.key != -1 && __any_sync(0xffffffffu, out != 0))
            flush_rows(flush[warp], grad, acc, out, cur.base, W, D, C, c0,
                       C - c0 < kWarp ? C - c0 : kWarp, lane);"""
FLUSH_DECL = """        if (cur.key != -1 && ch < C) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (((cur.mask >> k) & 1) && fresh(k, bit, !up) &&
                acc[k] != 0.f) {
              if constexpr (kPoints)
                hot_add(hot, cur_hot, grad, cur.base + corner_offset(k, W, D),
                        C, ch, acc[k]);"""
FLUSH_ROWS = r"""
struct alignas(16) FlushRows {
  float v[8][36];  // a row at its offset mod 4 in grad: < 4 + 32 floats
};

__device__ __forceinline__ void flush_rows(FlushRows& f,
                                           float* __restrict__ grad,
                                           const float (&acc)[8],
                                           unsigned rows, int base, int W,
                                           int D, int C, int c0, int width,
                                           int lane) {
  rows = __reduce_or_sync(0xffffffffu, rows);
  const int64_t g0 = static_cast<int64_t>(
      (reinterpret_cast<uintptr_t>(grad) >> 2) & 3);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (((rows >> k) & 1) && lane < width) {
      const int64_t first =
          static_cast<int64_t>(base + corner_offset(k, W, D)) * C + c0;
      f.v[k][static_cast<int>((g0 + first) & 3) + lane] = acc[k];
    }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 64; i += kWarp) {
    const int k = i >> 3, q = i & 7;
    if (!((rows >> k) & 1)) continue;
    const int64_t first =
        static_cast<int64_t>(base + corner_offset(k, W, D)) * C + c0;
    const int o = static_cast<int>((g0 + first) & 3);
    const int lead = (4 - o) & 3;
    const int head = lead < width ? lead : width;
    const int body = (width - head) >> 2;
    const int tail = width - head - 4 * body;
    if (q < body)
      atomicAdd(reinterpret_cast<float4*>(grad + first + head + 4 * q),
                *reinterpret_cast<const float4*>(&f.v[k][o + head + 4 * q]));
    const int ch = q < head ? q : q - head < tail ? head + 4 * body + q - head
                                                  : -1;
    if (ch >= 0) atomicAdd(grad + first + ch, f.v[k][o + ch]);
  }
  __syncwarp();
}

constexpr int kHotPoints"""
# the warp's walk, and a path that takes a warp without runs (30 or more
# runs of one cell in its 32 points) by its (point, channel) pairs instead
WALK = """  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int ch = c0 + lane;
    float acc[8], rowv[8];"""
PAIRS = """  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  if constexpr (!kPoints) {
    const int key = recs[warp][lane].key;
    const int prev = __shfl_up_sync(0xffffffffu, key, 1);
    const int runs = __popc(__ballot_sync(
        0xffffffffu, lane < count && (lane == 0 || key != prev)));
    if (runs >= 30) {
      int off[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) off[k] = corner_offset(k, W, D) * C;
      const int dp = kWarp / C, dc = kWarp - dp * C;
      int p = lane / C, ch = lane - p * C;
      for (int i = lane; i < count * C; i += kWarp) {
        const PointRec r = recs[warp][p];
        if (r.key != -1) {
          const float g = __ldg(gv + tile * C + i);
          const float4 w0 = wts[warp][p][0], w1 = wts[warp][p][1];
          const float w[8] = {w0.x, w0.y, w0.z, w0.w,
                              w1.x, w1.y, w1.z, w1.w};
          const int64_t first = static_cast<int64_t>(r.base) * C + ch;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if ((r.mask >> k) & 1)
              atomicAdd(grad + (first + off[k]), w[k] * g);
        }
        p += dp;
        ch += dc;
        if (ch >= C) {
          ch -= C;
          ++p;
        }
      }
      return;
    }
  }
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int ch = c0 + lane;
    float acc[8], rowv[8];"""
STAGED = "        g = stage[p * kWarp + lane];"
UNSTAGED = ("        g = gv != nullptr && ch < C ? __ldg(gv + (tile + p) * C"
            " + ch) : 0.f;")
HOT = "__ldg(hot.counts + base) > kHotPoints;"
SEGMENTS = """    if (gg != nullptr)
      trilinear_bwd_plane_points_kernel<<<blocks, kThreads, 0, s>>>(
          hwd, gv, gg, acc, num_points, H, W, D, vol, gpts, tiles);"""
CHAINS = """    if (gg != nullptr)
      trilinear_bwd_plane_kernel<true><<<blocks_for(num_points), kThreads, 0,
                                         s>>>(hwd, gv, gg, nullptr,
                                              num_points, H, W, D, vol, gpts,
                                              acc);"""
OWN_LOAD = """          v[k] = in_volume(c, k, H, W, D)
                     ? __ldg(vol + static_cast<int64_t>(voxel(c, k, W, D)) *
                                       row)
                     : 0.f;
"""
SHARED_LOAD = """          v[k] = lane == start && in_volume(c, k, H, W, D)
                     ? __ldg(vol + static_cast<int64_t>(voxel(c, k, W, D)) *
                                       row)
                     : 0.f;
          v[k] = __shfl_sync(kFull, v[k], start);
"""
TILES = "    const int tiles = kSegTiles;\n"
# one wave of resident blocks (the occupancy calculator), each taking as
# many tiles as that leaves it
RESIDENT = r"""// The blocks of `kernel` (kThreads threads, static shared memory only) that
// the card holds at once: SMs times resident blocks per SM, from the
// occupancy calculator, remembered by (device, slot): it costs host time.
int resident_blocks(const void* kernel, int slot, int* blocks) {
  constexpr int kDevices = 64, kSlotsCached = 2;
  static int known[kDevices][kSlotsCached] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kDevices && known[dev][slot] > 0) {
    *blocks = known[dev][slot];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kDevices) known[dev][slot] = *blocks;
  return 0;
}
"""
OCCUPANCY_TILES = """    int slots = 0;
    const int err =
        gg != nullptr
            ? resident_blocks(reinterpret_cast<const void*>(
                                  trilinear_bwd_plane_points_kernel),
                              0, &slots)
            : resident_blocks(reinterpret_cast<const void*>(
                                  values_bwd_plane_points_kernel),
                              1, &slots);
    if (err) return err;
    const int64_t count = (num_points + kThreads - 1) / kThreads;
    const int tiles = static_cast<int>((count + slots - 1) / slots);
"""
TABLE_ADD = "            table_add(keys, sums, voxel(c, k, W, D), x[k], out);"
DIRECT_ADD = ("            atomicAdd(out + voxel(c, k, W, D), "
              "static_cast<T>(x[k]));")
# the narrow backward's flush of a segment's corner rows (float4 atomics
# into the scratch), its launcher, and the walk's launch at C % 4 != 0
NARROW_MAX = "constexpr int kNarrowMax = 3;"
NARROW_FLUSH = """      float4 v = make_float4(x[k][0], 0.f, 0.f, 0.f);
      if constexpr (C > 1) v.y = x[k][C > 1 ? 1 : 0];
      if constexpr (C > 2) v.z = x[k][C > 2 ? 2 : 0];
      if (vox >= 0 && (v.x != 0.f || v.y != 0.f || v.z != 0.f))
        atomicAdd(acc + vox, v);"""
NARROW_SCRATCH = """  float4* rows = reinterpret_cast<float4*>(acc);"""
NARROW_FOLD = """  if (voxels > 0)
    narrow_fold_kernel<<<blocks_for(voxels * C), kThreads, 0, s>>>(
        rows, grad, voxels, C);"""
WALK_LAUNCH = """    else
      values_bwd_walk_kernel<false><<<blocks_for(num_points), kThreads, 0,
                                      s>>>(hwd, gv, grad, num_points, C, H,"""
# straight into the gradient's 12-byte rows, zeroed by the launcher (the
# wrapper leaves a narrow instance's gradient unfilled): C scalar atomics,
# or a float2 on the 8-byte-aligned pair of channels and a scalar
IN_PLACE = """  cudaMemsetAsync(grad, 0, static_cast<size_t>(H) * W * D * C * 4, s);
  float4* rows = reinterpret_cast<float4*>(grad);"""
NO_FOLD = "  (void)voxels;"
SCALAR_FLUSH_ROWS = """      float* r = reinterpret_cast<float*>(acc) +
                 static_cast<int64_t>(vox) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (vox >= 0 && x[k][ch] != 0.f) atomicAdd(r + ch, x[k][ch]);"""
FLOAT2_FLUSH = """      float* r = reinterpret_cast<float*>(acc) +
                 static_cast<int64_t>(vox) * C;
      if (vox < 0) {
      } else if constexpr (C == 1) {
        if (x[k][0] != 0.f) atomicAdd(r, x[k][0]);
      } else if constexpr (C == 2) {
        atomicAdd(reinterpret_cast<float2*>(r), make_float2(x[k][0], x[k][1]));
      } else if ((reinterpret_cast<uintptr_t>(r) & 7) == 0) {
        atomicAdd(reinterpret_cast<float2*>(r),
                  make_float2(x[k][0], x[k][C > 1 ? 1 : 0]));
        if (x[k][C > 2 ? 2 : 0] != 0.f) atomicAdd(r + 2, x[k][C > 2 ? 2 : 0]);
      } else {
        if (x[k][0] != 0.f) atomicAdd(r, x[k][0]);
        atomicAdd(reinterpret_cast<float2*>(r + 1),
                  make_float2(x[k][C > 1 ? 1 : 0], x[k][C > 2 ? 2 : 0]));
      }"""
# the block's table: 256 points a block, the segments' sums into 1024
# slots of float4 sums in shared memory, flushed as float4 atomics into
# the scratch
TABLE_KERNEL = r"""template <int C, bool kBorder>
__global__ void __launch_bounds__(kThreads)
    values_bwd_narrow_table_kernel(const float* __restrict__ hwd,
                                   const float* __restrict__ gv,
                                   float4* __restrict__ acc,
                                   int64_t num_points, int H, int W, int D) {
  __shared__ int keys[kSlots];
  __shared__ float4 sums[kSlots];
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    keys[i] = kEmpty;
    sums[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const unsigned upto = (2u << lane) - 1u;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  float g[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) g[ch] = 0.f;
  if (live) {
    c = narrow_cell<kBorder>(hwd, n, H, W, D);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) g[ch] = gv[n * C + ch];
  }
  const int ph = __shfl_up_sync(kFull, c.h0, 1);
  const int pw = __shfl_up_sync(kFull, c.w0, 1);
  const int pd = __shfl_up_sync(kFull, c.d0, 1);
  const unsigned heads = __ballot_sync(
      kFull, lane == 0 || c.h0 != ph || c.w0 != pw || c.d0 != pd);
  const int start = 31 - __clz(heads & upto);
  const unsigned later = heads & ~upto;
  const bool last = later ? __ffs(later) - 2 == lane : lane == kWarp - 1;
  const int longest = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(lane - start)));
  float x[8][C];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = weight(c, k);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) x[k][ch] = w * g[ch];
  }
  for (int d = 1; d <= longest; d <<= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float y = __shfl_up_sync(kFull, x[k][ch], d);
        if (lane - d >= start) x[k][ch] += y;
      }
    }
  }
  if (last && live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int vox = narrow_voxel<kBorder>(c, k, H, W, D);
      if (vox < 0) continue;
      unsigned h = (static_cast<unsigned>(vox) * 2654435761u) >>
                   (32 - kSlotBits);
      int probe = 0;
      for (; probe < kProbes; ++probe) {
        int key = *reinterpret_cast<volatile int*>(keys + h);
        if (key == kEmpty) key = atomicCAS(keys + h, kEmpty, vox);
        if (key == kEmpty || key == vox) break;
        h = (h + 1) & (kSlots - 1);
      }
      float4 v = make_float4(x[k][0], 0.f, 0.f, 0.f);
      if constexpr (C > 1) v.y = x[k][C > 1 ? 1 : 0];
      if constexpr (C > 2) v.z = x[k][C > 2 ? 2 : 0];
      if (probe < kProbes) {
        float* slot = reinterpret_cast<float*>(sums + h);
        if (v.x != 0.f) atomicAdd(slot, v.x);
        if (v.y != 0.f) atomicAdd(slot + 1, v.y);
        if (v.z != 0.f) atomicAdd(slot + 2, v.z);
      } else if (v.x != 0.f || v.y != 0.f || v.z != 0.f) {
        atomicAdd(acc + vox, v);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += kThreads)
    if (keys[i] != kEmpty) atomicAdd(acc + keys[i], sums[i]);
}

"""
TABLE_LAUNCH = """  if constexpr (!kPoints) {
    if (num_points > 0) {
      if (C == 1)
        values_bwd_narrow_table_kernel<1, kBorder>
            <<<blocks, kThreads, 0, s>>>(hwd, gv, rows, num_points, H, W, D);
      else if (C == 2)
        values_bwd_narrow_table_kernel<2, kBorder>
            <<<blocks, kThreads, 0, s>>>(hwd, gv, rows, num_points, H, W, D);
      else
        values_bwd_narrow_table_kernel<3, kBorder>
            <<<blocks, kThreads, 0, s>>>(hwd, gv, rows, num_points, H, W, D);
    }
    const int64_t voxels = static_cast<int64_t>(H) * W * D;
""" + NARROW_FOLD + """
    return;
  }"""
NARROW_LAUNCHER = "template <bool kBorder, bool kPoints>\nvoid narrow_bwd("
# the segments' last lanes and their flush; the scan's length
NARROW_LAST = """  if (last && live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int vox = narrow_voxel<kBorder>(c, k, H, W, D);"""
NARROW_LONGEST = """  const int longest = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(lane - start)));"""
# chains of consecutive segments that share a voxel: each segment's last
# lane puts its 8 rows into the warp's table in shared memory (a border
# corner clamped onto a lower corner's row, weight 0, left out); the first
# segment of each chain sums the chain and makes its one float4 atomic
CHAINS_FLUSH = """  __shared__ int seg_vox[kWarps][kWarp][8];
  __shared__ float4 seg_sum[kWarps][kWarp][8];
  const int seg = __popc(heads & upto) - 1, nseg = __popc(heads);
  if (last) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int vox = live ? narrow_voxel<kBorder>(c, k, H, W, D) : -1;
#pragma unroll
      for (int j = 0; j < k; ++j)
        if (vox >= 0 && vox == narrow_voxel<kBorder>(c, j, H, W, D)) vox = -1;
      float4 v = make_float4(x[k][0], 0.f, 0.f, 0.f);
      if constexpr (C > 1) v.y = x[k][C > 1 ? 1 : 0];
      if constexpr (C > 2) v.z = x[k][C > 2 ? 2 : 0];
      seg_vox[warp][seg][k] = vox;
      seg_sum[warp][seg][k] = v;
    }
  }
  __syncwarp();
  if (last && live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int vox = seg_vox[warp][seg][k];
      bool head = vox >= 0;
      if (seg > 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          head = head && seg_vox[warp][seg - 1][j] != vox;
      }
      if (!head) continue;
      float4 v = seg_sum[warp][seg][k];
      for (int t = seg + 1; t < nseg; ++t) {
        int hit = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (seg_vox[warp][t][j] == vox) hit = j;
        if (hit < 0) break;
        const float4 y = seg_sum[warp][t][hit];
        v.x += y.x;
        v.y += y.y;
        v.z += y.z;
      }
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f) atomicAdd(acc + vox, v);
    }
  }
}"""
# timing probes, not designs: their results are wrong and not checked
PROBES = ("narrow_noflush",)
# which variants each case runs: the narrow ones at the flow lookup alone
NARROW_VARIANTS = ("shipped", "narrow_scalar", "narrow_float2",
                   "narrow_table", "narrow_chains", "narrow_noscan",
                   "narrow_noflush")


def narrow_chains(src: str) -> str:
    """The narrow backward with CHAINS_FLUSH in place of each segment's
    own flush (the block from NARROW_LAST to the kernel's end)."""
    at = src.index(NARROW_LAST)
    end = src.index("\n}\n", at) + 2
    return src[:at] + CHAINS_FLUSH + src[end:]


def variants(src: str) -> dict:
    for s, n in ((FLUSH_DECL, 1), (STAGED, 1), (HOT, 1), (WALK, 1),
                 (SEGMENTS, 1), (OWN_LOAD, 1), (TILES, 1), (TABLE_ADD, 1),
                 ("}  // namespace", 1), (NARROW_MAX, 1), (NARROW_FLUSH, 1),
                 (NARROW_SCRATCH, 1), (NARROW_FOLD, 1), (WALK_LAUNCH, 1),
                 (NARROW_LAUNCHER, 1), (NARROW_LAST, 1), (NARROW_LONGEST, 1),
                 ("constexpr int kHotPoints = 128;", 1),
                 ("  __shared__ float dots[kPoints ? kWarps : 1][kWarp][8];\n"
                  "  const int lane", 2)):
        assert src.count(s) == n, f"source changed: {s!r}"
    # the walk's flush: the first scalar flush after its declaration (the
    # rows kernel before it flushes with the same lines)
    at = src.index(FLUSH_DECL)
    assert src.find(SCALAR_FLUSH, at) == at + len(FLUSH_DECL) + 1, \
        "source changed: the walk's flush"
    vec = (src[:at] + "        unsigned out = 0;\n" + FLUSH_DECL + "\n"
           + VECTOR_FLUSH + src[at + len(FLUSH_DECL) + 1
                                + len(SCALAR_FLUSH):])
    vec = vec.replace("\nconstexpr int kHotPoints", FLUSH_ROWS, 1)
    # the walk kernel's declarations come second in the source
    head, sep, tail = vec.rpartition(
        "  __shared__ float dots[kPoints ? kWarps : 1][kWarp][8];\n"
        "  const int lane")
    vec = head + "  __shared__ FlushRows flush[kWarps];\n" + sep + tail
    return {"shipped": src,
            "vector_flush": vec,
            "pairs_without_runs": src.replace(WALK, PAIRS),
            "unstaged": src.replace(STAGED, UNSTAGED),
            "fp32_chain": src.replace(HOT, "__ldg(hot.counts + base) < 0;"),
            **{f"hot_points_{t}": src.replace(
                "constexpr int kHotPoints = 128;",
                f"constexpr int kHotPoints = {t};") for t in (32, 512)},
            "plane_chains": src.replace(SEGMENTS, CHAINS),
            "shared_corners": src.replace(OWN_LOAD, SHARED_LOAD),
            "occupancy_tiles": src.replace(
                "}  // namespace", RESIDENT + "\n}  // namespace").replace(
                TILES, OCCUPANCY_TILES),
            **{f"tiles_{t}": src.replace(
                TILES, f"    const int tiles = {t};\n") for t in (1, 2, 8)},
            "no_table": src.replace(TABLE_ADD, DIRECT_ADD),
            "narrow_walk": src.replace(
                NARROW_MAX, "constexpr int kNarrowMax = 0;").replace(
                WALK_LAUNCH, WALK_LAUNCH.replace(
                    "    else\n", "    else if (cudaMemsetAsync(grad, 0, "
                    "static_cast<size_t>(H) * W * D * C * 4, s) == "
                    "cudaSuccess)\n")),
            **{name: src.replace(NARROW_FLUSH, flush).replace(
                NARROW_SCRATCH, IN_PLACE).replace(NARROW_FOLD, NO_FOLD)
               for name, flush in (("narrow_scalar", SCALAR_FLUSH_ROWS),
                                   ("narrow_float2", FLOAT2_FLUSH))},
            "narrow_chains": narrow_chains(src),
            "narrow_noscan": src.replace(
                NARROW_LONGEST, "  const int longest = 0;").replace(
                NARROW_LAST, NARROW_LAST.replace("last && live", "live")),
            "narrow_noflush": src.replace(
                "        atomicAdd(acc + vox, v);",
                "        if (v.x == 1234.5f) acc[0] = v;"),
            "narrow_table": src.replace(
                NARROW_LAUNCHER, TABLE_KERNEL + NARROW_LAUNCHER).replace(
                NARROW_SCRATCH, NARROW_SCRATCH + "\n" + TABLE_LAUNCH)}


def build(out_dir: str, names=None) -> dict:
    """The variants (all, or those in ``names``) built into ``out_dir`` and
    loaded, their entry points typed as the port's: {name: library}."""
    from selfocc_tpu_torch import _build
    from selfocc_tpu_torch.ops import interp
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in variants(open(SOURCE).read()).items():
        if names is not None and name not in names:
            continue
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir,
                                                       f"{name}.so")))
        for fn, argt in interp._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argt)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from selfocc_tpu_torch import _build
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.ops import interp
    if not torch.cuda.is_available():
        sys.exit("trilinear_scatter_variants: needs a CUDA card")
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "work_dirs", "trilinear_scatter_variants")
    os.makedirs(out_dir, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(out_dir, [name for name in variants(open(SOURCE).read())
                           if name != "narrow_walk"])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    seeded = lambda: torch.Generator(device=dev).manual_seed(cs.SEED)
    shape = (257, 257, 25)
    vshape = (25,) + shape
    vol = torch.randn(shape + (25,), generator=g,
                      device=dev).permute(3, 0, 1, 2)
    head = cs.head_points(dev, (cs.HEAD_SAMPLES,))[cs.HEAD_SAMPLES]
    n = head.shape[0]
    taps = (head[:, None, :] + 0.05 * torch.randn(
        (n, 6, 3), generator=g, device=dev)).reshape(-1, 3)
    cases = {}
    for tag, pts in (
            ("density", cs.density_step_points(
                get_config("nuscenes_occ_density"), dev, seeded())),
            ("options", cs.step_points(dev)[0]),
            ("bev", cs.uniform_sdf_points(get_config("nuscenes_occ_bev"),
                                          dev, seeded()))):
        gv = torch.randn((pts.shape[0], 25), generator=g, device=dev)
        cases[f"values_c25_{tag}"] = (
            (lambda p=pts, v=gv: interp.trilinear_cf_bwd(vshape, p, v)),
            (lambda p=pts, v=gv: interp.trilinear_cf_bwd_plain(
                torch.zeros(vshape, device=dev), p, v)), None)
        if tag == "bev":  # the step's cotangent: the sdf channel alone
            sdf = torch.cat([gv[:, :1], torch.zeros_like(gv[:, 1:])], 1)
            cases["values_c25_bev_sdf"] = (
                lambda p=pts, v=sdf: interp.trilinear_cf_bwd(vshape, p, v),
                lambda p=pts, v=sdf: interp.trilinear_cf_bwd_plain(
                    torch.zeros(vshape, device=dev), p, v), None)
    vol1 = interp.first_channel(vol)
    sdf_view = interp.channel0_view(vol)
    step = cs.importance_step_points(dev)
    rounds = cs.head_points(dev, (288,))[288]
    for tag, v, p in (("c25_head", vol, head), ("c1_head", vol1, head),
                      ("c1_step", vol1, step["taps"][0])):
        C = v.shape[0]
        gv = torch.randn((p.shape[0], C), generator=g, device=dev)
        gg = torch.randn((p.shape[0], 3), generator=g, device=dev)
        cases[f"points_{tag}"] = (
            (lambda v=v, p=p, a=gv, b=gg: interp.trilinear_bwd(
                v, p, a, b, points=True)),
            (lambda v=v, p=p, a=gv, b=gg: interp.trilinear_bwd_plain(
                v, p, a, b, points=True)),
            (lambda v=v, p=p, a=gv, b=gg: interp.trilinear_bwd_plain(
                v.double(), p.double(), a.double(), b.double(),
                points=True)))
    for tag, p in (("288", rounds), ("288_step", step["rounds"][288])):
        gr = torch.randn((p.shape[0], 1), generator=g, device=dev)
        cases[f"values_points_c1_{tag}"] = (
            lambda p=p, a=gr: interp.trilinear_cf_bwd(
                tuple(sdf_view.shape), p, a, sdf_view),
            lambda p=p, a=gr: interp.trilinear_cf_bwd_plain(
                sdf_view, p, a, points=True),
            lambda p=p, a=gr: interp.trilinear_cf_bwd_plain(
                sdf_view.double(), p.double(), a.double(), points=True))
    gt = torch.randn((taps.shape[0], 1), generator=g, device=dev)
    cases["values_points_c1_taps"] = (
        lambda: interp.trilinear_cf_bwd(tuple(vol1.shape), taps, gt, vol1),
        lambda: interp.trilinear_cf_bwd_plain(vol1, taps, gt, points=True),
        lambda: interp.trilinear_cf_bwd_plain(vol1.double(), taps.double(),
                                              gt.double(), points=True))
    # the narrow backward at the flow head's step: its unclipped samples of
    # the curr2prev flow, border padding
    _, fhead, _, reps, img2lidar, fg = cs.flow_head_setup(dev)
    out = fhead(reps[0], img2lidar, train=True, generator=fg,
                prev_rep=reps[1], next_rep=reps[2])
    fpts, fvol = cs.flow_lookup_inputs(fhead, out, img2lidar)[2:]
    del out, fhead, reps
    fshape = tuple(fvol.permute(3, 0, 1, 2).shape)
    fgv = torch.randn((fpts.shape[0], 3), generator=g, device=dev)
    cases["values_c3_flow"] = (
        lambda: interp.trilinear_cf_bwd(fshape, fpts, fgv, padding="border"),
        lambda: interp.trilinear_cf_bwd_plain(
            torch.zeros(fshape, device=dev), fpts, fgv, padding="border"),
        None)
    if len(sys.argv) > 2:
        wanted = tuple(sys.argv[2].split(","))
        cases = {k: v for k, v in cases.items() if k.startswith(wanted)}
    res = {name: {} for name in libs}
    for tag, (kern, plain, f64) in cases.items():
        ran = [name for name in libs
               if (name in NARROW_VARIANTS if tag.startswith("values_c3")
                   else not name.startswith("narrow_"))]
        order = ran + ran[::-1]
        ref = plain()
        ref64 = f64() if f64 is not None else None
        refs = ref if isinstance(ref, tuple) else (ref,)
        for name in order:
            _build._LIBS["trilinear"] = libs[name]
            rec = res[name].setdefault(tag, {"device_ms": []})
            if "max_abs_err" not in rec and name in PROBES:
                rec["max_abs_err"] = None   # a probe: results not checked
            if "max_abs_err" not in rec:
                got = kern()
                got = got if isinstance(got, tuple) else (got,)
                errs = [cs.max_err(a, b) for a, b in zip(got, refs)]
                tols = [cs.GRAD_RTOL * float(b.abs().max()) + 1e-7
                        for b in refs]
                if any(e > t for e, t in zip(errs, tols)):
                    raise AssertionError(f"{name} {tag}: {errs} > {tols}")
                rec["max_abs_err"] = max(errs)
                if ref64 is not None:
                    rec["float64"] = {
                        which: {"kernel": cs.max_err(a, r),
                                "plain_fp32": cs.max_err(b, r)}
                        for which, a, b, r in zip(("volume", "points"), got,
                                                  refs, ref64)}
                del got
            rec["device_ms"].append(cs.device_ms(kern, 10))
        del ref, ref64, refs
        torch.cuda.empty_cache()
        print(f"{tag}: " + ", ".join(
            f"{name} {sorted(res[name][tag]['device_ms'])}"
            + (f" float64 {res[name][tag]['float64']}"
               if "float64" in res[name][tag] else "")
            for name in ran), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    with open(os.path.join(out_dir, "variants.json"), "w") as f:
        json.dump({"card": card, "device_ms": res}, f, indent=1)


if __name__ == "__main__":
    start = time.time()
    main()
    print(f"done in {time.time() - start:.1f} s")
