// Trilinear sampling of a volume with the analytic gradient of channel 0:
// forward (trilinear_cf_with_grad_fwd) and the volume's cotangent
// (trilinear_bwd); and the values alone (trilinear_cf_fwd), for the
// occupancy eval.
//
// Replaces: selfocc_tpu/ops/interp.py::trilinear_sample_cf_with_grad
// (interp.py:159), which XLA lowers on the TPU to 8 corner gathers over a
// flattened (C, H*W*D) volume, and its JAX autodiff cotangent; and, values
// only, interp.py::trilinear_sample_cf (:118, the dense occupancy query)
// and interp.py::trilinear_sample (:73, the Occ3D resample of the dense
// sdf and logits grids). Semantics:
// align_corners=True fractional (h, w, d) indices, zeros padding; vals
// (N, C) = sum over the 8 corners of weight * value; grad0 (N, 3) =
// d(channel 0)/d(h, w, d), the bilinear interpolation over the other two
// axes of the corner differences along each axis. The backward adds, for
// every in-volume corner k of a point, gv[c] * w_k to channel c and
// sum_j gg[j] * dw_k/dx_j to channel 0 (the derivative of the closed-form
// gradient with respect to the corner value). The points get no cotangent.
//
// Layout. The kernels read a channel-last volume, (H, W, D, C) in memory:
// a corner's C channels are one contiguous row (100 bytes at C = 25). The
// public op keeps the JAX package's (C, H, W, D) shape and takes this
// layout as a permuted view, which is what the field's decode produces;
// with C = 1 it is the plain (H, W, D) plane.
//
// What bounds them on the H100. The render calls them on the samples of
// whole rays, ray-major: 256 samples per ray about 0.2 cells apart, so runs
// of about five consecutive points share one cell and all 8 of its corners.
// Per training chunk (4096 rays, 1M points) there is one call at C = 25 on
// the 165 MB decoded volume and six at C = 1 on the 6.6 MB sdf plane, which
// stays in L2; the eval frame calls C = 1 on 8.4M points per chunk.
// - The C = 25 backward was bound by its atomics: one scalar atomic per
//   (point, corner, channel), 200 per point, each on its own cache line of
//   a channel-first gradient.
// - The C = 25 forward read 200 scattered 4-byte words per point, one
//   sector each, from a volume larger than L2.
// - Once those go, the function's own bytes are a few tens of MB per call
//   and most corner rows are hits in L1 or L2; the design then counts load,
//   shared-memory and atomic requests per point, not HBM bytes.
//
// Design. Each kernel has two instances: "plane" for C = 1, "rows" for
// C > 1. A warp takes 32 consecutive points; a run is a stretch of
// consecutive points in one cell. Nothing assumes that points come in
// runs: uniform, shuffled or padded points make runs of one point, and
// the result is the same.
// - Rows forward: each point's own lane computes its cell, its corner
//   mask and grad0 (from channel 0 of its corners); then lanes over
//   channels walk the warp's points in order and keep the 8 corner rows of
//   the current cell in registers, loaded again only when the cell
//   changes. A corner row is one coalesced warp load (100 bytes at
//   C = 25); vals (N, C) are written as contiguous rows.
// - Rows backward: lanes over channels walk the points in order and sum a
//   run's contributions to each of the cell's 8 corners in registers;
//   when the cell changes, each corner row it leaves takes one atomic per
//   lane (4 on a step into a neighbouring cell, whose 4 shared corners
//   carry their sums over), so a run costs about 4 row updates of 4-5
//   sectors, against 200 scattered atomics per point before. The gradient
//   is accumulated channel-last and needs no transpose (decode's permute
//   takes it as it is).
// - Plane backward: one lane per point. A voxel's contributions from
//   consecutive points are chained through shared memory (each point
//   notes the voxel's slot in the next point, if that point's cell
//   touches it), and the chain's first lane sums it and makes one scalar
//   atomic into the L2-resident plane. Chains, unlike runs, go on across
//   steps into neighbouring cells.
// - Plane forward: one lane per point and 8 scalar loads, which hit L2.
// Tried on the card and dropped, slower at the training chunk's points: an
// 8-byte load of the two corners adjacent along d in the plane forward
// (lanes of one warp differ in alignment, and the two paths serialise);
// carrying 4 rows across a step in the rows forward (the register moves
// cost more than the 4 loads, which hit L1); runs with a segmented shuffle
// reduction in the plane backward (a run flushes all 8 corners, a chain
// one per voxel); chains in the rows kernels.
// - Both forwards stage grad0 through shared memory, so the warp writes its
//   32 x 3 floats with three coalesced stores.
// - Values only (trilinear_cf_fwd): the same two forward kernels with
//   kGrad = false, which drops grad0's arithmetic, loads, staging and
//   stores. It takes a row stride: the occupancy eval resamples the sdf
//   and logit channels of its dense query's (N, 25) values where they lie,
//   without copying them out (881 MB of logits at 512 x 512 x 40). At the
//   dense query's 10.5M points the rows kernel is bound by its 1.05 GB of
//   vals stores (one 100-byte row per point): 0.38 ms over HBM, 0.89-0.99
//   ms measured on an NVIDIA H100 80GB HBM3 at 700 W, where F.grid_sample
//   takes 1.02-1.13 ms on a channel-first copy.
// Sums are taken in another order than the plain version's (per run or
// chain, then atomics in any order); the fp32 results agree within the
// tolerances chip_smoke.py states.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarp * kWarps;

// A point's cell: its base corner (the floor of each index) and fractions.
struct Cell {
  int h0, w0, d0;
  float fh, fw, fd;
};

__device__ __forceinline__ Cell locate(const float* __restrict__ hwd,
                                       int64_t n) {
  const float h = hwd[3 * n], w = hwd[3 * n + 1], d = hwd[3 * n + 2];
  Cell c;
  c.h0 = __float2int_rd(h);
  c.w0 = __float2int_rd(w);
  c.d0 = __float2int_rd(d);
  c.fh = h - floorf(h);
  c.fw = w - floorf(w);
  c.fd = d - floorf(d);
  return c;
}

// Corner k = (ih, iw, id) = (k >> 2, (k >> 1) & 1, k & 1), the reference's
// order. Unsigned compares keep far-away points (saturated indices) out.
__device__ __forceinline__ bool in_volume(const Cell& c, int k, int H, int W,
                                          int D) {
  return static_cast<unsigned>(c.h0) + (k >> 2) < static_cast<unsigned>(H) &&
         static_cast<unsigned>(c.w0) + ((k >> 1) & 1) <
             static_cast<unsigned>(W) &&
         static_cast<unsigned>(c.d0) + (k & 1) < static_cast<unsigned>(D);
}

__device__ __forceinline__ int voxel(const Cell& c, int k, int W, int D) {
  return ((c.h0 + (k >> 2)) * W + c.w0 + ((k >> 1) & 1)) * D + c.d0 + (k & 1);
}

__device__ __forceinline__ float weight(const Cell& c, int k) {
  const float wh = (k & 4) ? c.fh : 1.f - c.fh;
  const float ww = (k & 2) ? c.fw : 1.f - c.fw;
  const float wd = (k & 1) ? c.fd : 1.f - c.fd;
  return wh * ww * wd;
}

// d(weight_k)/d(h, w, d) dotted with (gh, gw, gd): channel 0's cotangent
// from grad0 at corner k.
__device__ __forceinline__ float grad0_term(const Cell& c, int k, float gh,
                                            float gw, float gd) {
  const float wh = (k & 4) ? c.fh : 1.f - c.fh;
  const float ww = (k & 2) ? c.fw : 1.f - c.fw;
  const float wd = (k & 1) ? c.fd : 1.f - c.fd;
  return ((k & 4) ? 1.f : -1.f) * ww * wd * gh +
         ((k & 2) ? 1.f : -1.f) * wh * wd * gw +
         ((k & 1) ? 1.f : -1.f) * wh * ww * gd;
}

// grad0 += corner k's value g times d(weight_k)/d(h, w, d)
__device__ __forceinline__ void add_grad0(const Cell& c, int k, float g,
                                          float (&g0)[3]) {
  const float wh = (k & 4) ? c.fh : 1.f - c.fh;
  const float ww = (k & 2) ? c.fw : 1.f - c.fw;
  const float wd = (k & 1) ? c.fd : 1.f - c.fd;
  g0[0] += ((k & 4) ? 1.f : -1.f) * ww * wd * g;
  g0[1] += ((k & 2) ? 1.f : -1.f) * wh * wd * g;
  g0[2] += ((k & 1) ? 1.f : -1.f) * wh * ww * g;
}

// Writes each lane's 3 floats to out[3 * (tile + lane) + j] through the
// warp's staging buffer, as three coalesced stores of 32 floats.
__device__ __forceinline__ void store_rows3(float* stage, float* out,
                                            int64_t tile, int64_t num_points,
                                            int lane, const float (&v)[3]) {
  stage[3 * lane] = v[0];
  stage[3 * lane + 1] = v[1];
  stage[3 * lane + 2] = v[2];
  __syncwarp();
  const int64_t limit = 3 * (num_points - tile);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = j * kWarp + lane;
    if (i < limit) out[3 * tile + i] = stage[i];
  }
}

// A point as the lanes over channels read it from shared memory: its cell
// (key: -1 when no corner is in the volume, else unique per base cell),
// the flat voxel of its base corner, the mask of its in-volume corners and
// its fractions.
struct alignas(16) PointRec {
  int key, base, mask, pad;
  float fh, fw, fd, pad2;
};

__device__ __forceinline__ PointRec point_rec(const Cell& c, bool live,
                                              int H, int W, int D) {
  PointRec r;
  r.mask = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (live && in_volume(c, k, H, W, D)) r.mask |= 1 << k;
  // with a corner inside, each base index lies in [-1, size - 1]
  r.key = r.mask ? ((c.h0 + 1) * (W + 1) + c.w0 + 1) * (D + 1) + c.d0 + 1
                 : -1;
  r.base = r.mask ? (c.h0 * W + c.w0) * D + c.d0 : 0;
  r.pad = 0;
  r.fh = c.fh;
  r.fw = c.fw;
  r.fd = c.fd;
  r.pad2 = 0.f;
  return r;
}

__device__ __forceinline__ Cell rec_cell(const PointRec& r) {
  Cell c;
  c.h0 = c.w0 = c.d0 = 0;  // only the fractions are read
  c.fh = r.fh;
  c.fw = r.fw;
  c.fd = r.fd;
  return c;
}

// offset of corner k's voxel from the base corner's
__device__ __forceinline__ int corner_offset(int k, int W, int D) {
  return (k >> 2) * W * D + ((k >> 1) & 1) * D + (k & 1);
}

// ---------------------------------------------------------------- forward

// C = 1: vol is the (H, W, D) plane, one value every `row` floats (1 for a
// contiguous plane). One lane per point. kGrad: also grad0; without it
// (the values-only entry) grad0's arithmetic, staging and stores go.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
    trilinear_fwd_plane_kernel(const float* __restrict__ vol,
                               const float* __restrict__ hwd,
                               float* __restrict__ vals,
                               float* __restrict__ grad0, int64_t num_points,
                               int H, int W, int D, int64_t row) {
  __shared__ float stage[kGrad ? kWarps : 1][3 * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  float g0[3] = {0.f, 0.f, 0.f};
  if (n < num_points) {
    const Cell c = locate(hwd, n);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v =
          in_volume(c, k, H, W, D)
              ? __ldg(vol + static_cast<int64_t>(voxel(c, k, W, D)) * row)
              : 0.f;
      acc += weight(c, k) * v;
      if constexpr (kGrad) add_grad0(c, k, v, g0);
    }
    vals[n] = acc;
  }
  if constexpr (kGrad)
    store_rows3(stage[warp], grad0, tile, num_points, lane, g0);
}

// C > 1: vol is (H, W, D, C) with `row` >= C floats from one voxel's row to
// the next (C for a contiguous volume). grad0 (kGrad only) from the
// point's own lane (channel 0 of its corners), vals from lanes over
// channels walking the points in order and keeping the 8 corner rows of
// the current cell in registers: a point in the same cell as the one
// before it loads nothing.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
    trilinear_fwd_rows_kernel(const float* __restrict__ vol,
                              const float* __restrict__ hwd,
                              float* __restrict__ vals,
                              float* __restrict__ grad0, int64_t num_points,
                              int C, int H, int W, int D, int64_t row) {
  __shared__ PointRec recs[kWarps][kWarp];
  __shared__ float stage[kGrad ? kWarps : 1][3 * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  if (live) c = locate(hwd, n);
  const PointRec mine = point_rec(c, live, H, W, D);
  recs[warp][lane] = mine;
  if constexpr (kGrad) {
    float g0[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      add_grad0(c, k,
                (mine.mask >> k) & 1
                    ? __ldg(vol + static_cast<int64_t>(
                                      mine.base + corner_offset(k, W, D)) *
                                      row)
                    : 0.f,
                g0);
    store_rows3(stage[warp], grad0, tile, num_points, lane, g0);
  }
  __syncwarp();

  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int ch = c0 + lane;
    float rowv[8];
    int key = -2;  // no cell loaded yet
    for (int p = 0; p < count; ++p) {  // warp-uniform
      const PointRec r = recs[warp][p];
      if (r.key != key) {
        key = r.key;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          rowv[k] = ((r.mask >> k) & 1) && ch < C
                        ? __ldg(vol +
                                static_cast<int64_t>(r.base +
                                                     corner_offset(k, W, D)) *
                                    row +
                                ch)
                        : 0.f;
      }
      const Cell rc = rec_cell(r);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += weight(rc, k) * rowv[k];
      if (ch < C) vals[(tile + p) * C + ch] = acc;
    }
  }
}

// --------------------------------------------------------------- backward

// Per-warp tables of the plane backward: for 32 consecutive points and
// their 8 corners, the corner's voxel (-1 outside the volume or past the
// last point), its contribution (weight * gv + the grad0 term), and the
// slot of the same voxel in the next point (-1: the chain ends).
struct ChainTables {
  int h0[kWarp], w0[kWarp], d0[kWarp];
  int vox[8][kWarp];
  float con[8][kWarp];
  signed char next[8][kWarp];
};

// C = 1: grad is the (H, W, D) plane. One lane per point. A voxel's
// contributions from consecutive points form a chain (each point notes the
// slot of the voxel in the next point, if the next point's cell touches
// it); the chain's first lane, whose previous lane does not touch the
// voxel, sums it and makes the voxel's one atomic. Unlike a run of one
// cell, a chain goes on across a step into a neighbouring cell.
__global__ void __launch_bounds__(kThreads)
    trilinear_bwd_plane_kernel(const float* __restrict__ hwd,
                               const float* __restrict__ gv,
                               const float* __restrict__ gg,
                               float* __restrict__ grad, int64_t num_points,
                               int H, int W, int D) {
  __shared__ ChainTables tables[kWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  ChainTables& t = tables[warp];
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = INT32_MIN;  // a base no valid voxel is next to
  c.fh = c.fw = c.fd = 0.f;
  float gh = 0.f, gw = 0.f, gd = 0.f, g = 0.f;
  if (live) {
    c = locate(hwd, n);
    if (gg != nullptr) {
      gh = gg[3 * n];
      gw = gg[3 * n + 1];
      gd = gg[3 * n + 2];
    }
    if (gv != nullptr) g = gv[n];
  }
  t.h0[lane] = c.h0;
  t.w0[lane] = c.w0;
  t.d0[lane] = c.d0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t.vox[k][lane] = live && in_volume(c, k, H, W, D) ? voxel(c, k, W, D)
                                                      : -1;
    t.con[k][lane] = weight(c, k) * g + grad0_term(c, k, gh, gw, gd);
  }
  __syncwarp();

  // a point at base b touches voxel v as its corner v - b when every axis
  // of v - b is 0 or 1
  unsigned heads = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int nxt = -1;
    if (t.vox[k][lane] >= 0) {
      const unsigned vh = c.h0 + (k >> 2), vw = c.w0 + ((k >> 1) & 1),
                     vd = c.d0 + (k & 1);
      if (lane + 1 < kWarp) {
        const unsigned dh = vh - t.h0[lane + 1], dw = vw - t.w0[lane + 1],
                       dd = vd - t.d0[lane + 1];
        if (dh <= 1u && dw <= 1u && dd <= 1u)
          nxt = static_cast<int>(dh * 4 + dw * 2 + dd);
      }
      bool head = true;
      if (lane > 0) {
        const unsigned dh = vh - t.h0[lane - 1], dw = vw - t.w0[lane - 1],
                       dd = vd - t.d0[lane - 1];
        head = !(dh <= 1u && dw <= 1u && dd <= 1u);
      }
      if (head) heads |= 1u << k;
    }
    t.next[k][lane] = static_cast<signed char>(nxt);
  }
  __syncwarp();
  while (heads) {
    const int k = __ffs(heads) - 1;
    heads &= heads - 1;
    float acc = 0.f;
    int q = lane, kk = k;
    do {
      acc += t.con[kk][q];
      kk = t.next[kk][q];
      ++q;
    } while (kk >= 0);
    atomicAdd(grad + t.vox[k][lane], acc);
  }
}

// The corner bit along which two cells one unit step apart differ (4: h,
// 2: w, 1: d), or 0; up: the new cell is the old one plus that step. Keys
// that differ by one step of an axis may also come from that axis's index
// wrapping into the next coarser axis; then the corners that would carry
// over lie at index -1 or size along that axis, outside the volume in both
// cells, and carrying them moves zeros or unflushed sums.
__device__ __forceinline__ int unit_step(int from, int to, int W, int D,
                                         bool& up) {
  up = to > from;
  if (from < 0 || to < 0) return 0;
  const int d = up ? to - from : from - to;
  return d == 1 ? 1 : d == D + 1 ? 2 : d == (W + 1) * (D + 1) ? 4 : 0;
}

// The 4 corners two cells one step apart along kBit share: up, new corner
// k = old corner k | kBit; down, new corner k | kBit = old corner k (k
// without kBit).
template <int kBit>
__device__ __forceinline__ void carry(float (&v)[8], bool up) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (!(k & kBit)) {
      if (up)
        v[k] = v[k | kBit];
      else
        v[k | kBit] = v[k];
    }
}

__device__ __forceinline__ void carry(float (&v)[8], int bit, bool up) {
  if (bit == 1)
    carry<1>(v, up);
  else if (bit == 2)
    carry<2>(v, up);
  else if (bit == 4)
    carry<4>(v, up);
}

// corner k of the new cell is one the old cell did not have (with !up:
// corner k of the old cell is one the new cell does not have)
__device__ __forceinline__ bool fresh(int k, int bit, bool up) {
  return bit == 0 || ((k & bit) != 0) == up;
}

// C > 1: grad is (H, W, D, C). Lanes over channels walk the points in
// order and sum each run of points in one cell into 8 registers (one per
// corner); when the cell changes, the corner rows the next cell does not
// share take one atomic per lane each (all 8 unless it is a unit step
// away), and the shared ones carry their sums over.
__global__ void __launch_bounds__(kThreads)
    trilinear_bwd_rows_kernel(const float* __restrict__ hwd,
                              const float* __restrict__ gv,
                              const float* __restrict__ gg,
                              float* __restrict__ grad, int64_t num_points,
                              int C, int H, int W, int D) {
  __shared__ PointRec recs[kWarps][kWarp];
  __shared__ float4 exts[kWarps][kWarp][2];  // channel 0's grad0 terms
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t tile =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  if (tile >= num_points) return;  // the whole warp
  const int64_t n = tile + lane;
  const bool live = n < num_points;
  Cell c;
  c.h0 = c.w0 = c.d0 = -2;
  c.fh = c.fw = c.fd = 0.f;
  float gh = 0.f, gw = 0.f, gd = 0.f;
  if (live) {
    c = locate(hwd, n);
    if (gg != nullptr) {
      gh = gg[3 * n];
      gw = gg[3 * n + 1];
      gd = gg[3 * n + 2];
    }
  }
  recs[warp][lane] = point_rec(c, live, H, W, D);
  exts[warp][lane][0] =
      make_float4(grad0_term(c, 0, gh, gw, gd), grad0_term(c, 1, gh, gw, gd),
                  grad0_term(c, 2, gh, gw, gd), grad0_term(c, 3, gh, gw, gd));
  exts[warp][lane][1] =
      make_float4(grad0_term(c, 4, gh, gw, gd), grad0_term(c, 5, gh, gw, gd),
                  grad0_term(c, 6, gh, gw, gd), grad0_term(c, 7, gh, gw, gd));
  __syncwarp();

  const int count = static_cast<int>(
      num_points - tile < kWarp ? num_points - tile : kWarp);
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int ch = c0 + lane;
    // this lane's channel takes updates: every channel from grad_vals,
    // channel 0 also from grad_grad0
    const bool active = ch < C && (gv != nullptr || ch == 0);
    float acc[8];
    PointRec cur;
    cur.key = -1;
    cur.base = cur.mask = 0;
    for (int p = 0; p <= count; ++p) {  // warp-uniform; p == count flushes
      const PointRec r = recs[warp][p < count ? p : 0];
      const int key = p < count ? r.key : -2;
      if (key != cur.key) {
        bool up;
        const int bit = unit_step(cur.key, key, W, D, up);
        if (cur.key != -1 && active) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (((cur.mask >> k) & 1) && fresh(k, bit, !up))
              atomicAdd(grad + static_cast<int64_t>(
                                   cur.base + corner_offset(k, W, D)) *
                                   C +
                            ch,
                        acc[k]);
        }
        carry(acc, bit, up);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (fresh(k, bit, up)) acc[k] = 0.f;
        cur = r;
        cur.key = key;
      }
      if (p == count || key == -1) continue;
      const float g =
          gv != nullptr && ch < C ? __ldg(gv + (tile + p) * C + ch) : 0.f;
      const Cell rc = rec_cell(r);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += weight(rc, k) * g;
      if (ch == 0) {
        const float4 e0 = exts[warp][p][0], e1 = exts[warp][p][1];
        acc[0] += e0.x;
        acc[1] += e0.y;
        acc[2] += e0.z;
        acc[3] += e0.w;
        acc[4] += e1.x;
        acc[5] += e1.y;
        acc[6] += e1.z;
        acc[7] += e1.w;
      }
    }
  }
}

unsigned blocks_for(int64_t num_points) {
  return static_cast<unsigned>((num_points + kThreads - 1) / kThreads);
}

template <bool kGrad>
int trilinear_fwd(const float* vol, const float* hwd, float* vals,
                  float* grad0, int64_t num_points, int C, int H, int W,
                  int D, int64_t row, void* stream) {
  if (num_points > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C == 1)
      trilinear_fwd_plane_kernel<kGrad>
          <<<blocks_for(num_points), kThreads, 0, s>>>(
              vol, hwd, vals, grad0, num_points, H, W, D, row);
    else
      trilinear_fwd_rows_kernel<kGrad>
          <<<blocks_for(num_points), kThreads, 0, s>>>(
              vol, hwd, vals, grad0, num_points, C, H, W, D, row);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vol: (H, W, D, C) channel-last (the (H, W, D) plane when C = 1); hwd
// (N, 3); vals (N, C) and grad0 (N, 3) written.
extern "C" int trilinear_cf_with_grad_fwd(const float* vol, const float* hwd,
                                          float* vals, float* grad0,
                                          int64_t num_points, int C, int H,
                                          int W, int D, void* stream) {
  return trilinear_fwd<true>(vol, hwd, vals, grad0, num_points, C, H, W, D, C,
                             stream);
}

// The values-only entry: vals (N, C) written, no grad0. vol: (H, W, D, C)
// with channels contiguous and `row` >= C floats between consecutive
// voxels, so that a slice of channels of a wider channel-last tensor (the
// occupancy query's sdf or logits out of its (N, 25) values) is read in
// place.
extern "C" int trilinear_cf_fwd(const float* vol, const float* hwd,
                                float* vals, int64_t num_points, int C, int H,
                                int W, int D, int64_t row, void* stream) {
  return trilinear_fwd<false>(vol, hwd, vals, nullptr, num_points, C, H, W, D,
                              row, stream);
}

// gv (N, C) or null, gg (N, 3) or null; grad (H, W, D, C) channel-last,
// zeroed by the caller.
extern "C" int trilinear_bwd(const float* hwd, const float* gv,
                             const float* gg, float* grad, int64_t num_points,
                             int C, int H, int W, int D, void* stream) {
  if (num_points > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C == 1)
      trilinear_bwd_plane_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
          hwd, gv, gg, grad, num_points, H, W, D);
    else
      trilinear_bwd_rows_kernel<<<blocks_for(num_points), kThreads, 0, s>>>(
          hwd, gv, gg, grad, num_points, C, H, W, D);
  }
  return static_cast<int>(cudaGetLastError());
}
