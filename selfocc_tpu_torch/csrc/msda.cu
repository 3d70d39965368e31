// Multi-scale deformable attention, per-head sampling locations: forward
// (msda_fwd) and backward (msda_bwd).
//
// Replaces: selfocc_tpu/ops/msda.py::_msda_dense (pure XLA on the TPU: per
// level, 4 corner gathers over a channel-first (B*H, D, h*w) value, then an
// einsum with the attention weights) and its autodiff. The reference ran
// mmcv's CUDA ms_deformable_im2col / col2im; the semantics are mmcv's
// pytorch fallback: grid_sample with align_corners=False and zeros padding,
// i.e. fractional pixel = loc * size - 0.5, reduced with the softmaxed
// attention weights and accumulated in fp32.
//
// What bounds it on the H100. Every (batch, query, head, level, point) reads
// 4 corner rows of D contiguous floats (64 bytes at D = 16). The flagship
// hw-plane cross-attention (6 x 66049 queries x 6 heads x 4 levels x 8
// points = 76M points) pulls about 19.5 GB of corner rows through L2 and L1
// against 1.1 GB that the call must move to and from HBM. So the limit is
// not HBM bytes but the rate at which L2 serves scattered 64-byte rows, which
// takes many loads in flight and few instructions per loaded byte; the
// backward adds one atomic per corner and channel into grad_value, which
// many queries share.
//
// Design, against each of those:
// - A lane owns VEC = 4 channels (one float4) of a head, not one channel:
//   a head's D = 16 channels are 4 lanes that read a corner row with 16-byte
//   loads. The other lanes of the warp are point slots: a warp holds S
//   slots of one (query, head), each walking its own subset of the points
//   (S = 8 at D = 16: 32 corner rows in flight per warp instead of 8), and
//   sums its channels in registers. The slots' partial sums are reduced
//   with shuffles once per (query, head), not per point.
// - Per-point terms (floor, fractions, the bounds tests, the four corner
//   weights) are computed by the lanes of one slot, i.e. D / 4 times per
//   point instead of D times, from the 8 slots' contiguous location and
//   weight loads. They are not staged through shared memory: that would
//   cost a barrier per tile to save a few instructions per corner row, and
//   the instruction rate is not the limit.
// - A block of 256 threads walks kQueryTile consecutive queries
//   (query-major within a camera, as the callers lay them out), so the
//   SM's resident blocks cover neighbouring queries, whose points land on
//   neighbouring pixels and share corner rows in L1.
// - The forward is held to 32 registers so that 2048 threads per SM keep
//   their loads in flight.
// - Backward: the same mapping. Per corner a lane dots its float4 of the
//   cotangent with the corner's float4 (the location and weight gradients
//   need only those dots) and adds a * w_corner * g to grad_value with one
//   vector atomic (atomicAdd(float4*), which sm_90 has for global memory):
//   D / 4 atomics per corner instead of D. The three per-point sums over a
//   head's channels are log2(D / 4) shuffle steps, then one store each. A
//   shared-memory accumulator for the smallest level (12 x 25 pixels x 96
//   channels, 115 KB) is left out: on the hw call a block's flush would be
//   7200 vector atomics against the 6144 its 8 queries make there, and on
//   the zh / wz calls, where it would save atomics, it leaves one block per
//   SM.
// - Other widths are instances of the same kernels: VEC = 1 when D is not a
//   multiple of 4 or a pointer is not 16-byte aligned; lanes per slot are
//   the next power of two of D / VEC up to 32 (surplus lanes idle), and
//   channel chunks of 32 * VEC loop when a head is wider than that (the
//   backward then adds each chunk's per-point sums to the first chunk's, in
//   the same thread). Any H and D are taken.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueryTile = 8;  // consecutive queries per block
// The forward is held to 32 registers (8 blocks, 2048 threads per SM): its
// corner loads need threads in flight more than registers. The backward
// keeps the registers it asks for: capping it spills and runs slower.
constexpr int kFwdMinBlocks = 8;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static void fma(float4& acc, float w, float4 v) {
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  __device__ static float dot(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  __device__ static void atomic_add_scaled(float* p, float s, float4 g) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(s * g.x, s * g.y, s * g.z, s * g.w));
  }
  __device__ static void shfl_add(float4& v, int o) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static float zero() { return 0.f; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void fma(float& acc, float w, float v) { acc += w * v; }
  __device__ static float dot(float a, float b) { return a * b; }
  __device__ static void atomic_add_scaled(float* p, float s, float g) {
    atomicAdd(p, s * g);
  }
  __device__ static void shfl_add(float& v, int o) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
};

// How the threads of a block map onto the work; the same in both kernels.
// A unit is one (batch * Q + query, head); a group of `lanes` lanes is one
// point slot; `slots` slots (an aligned group of lanes * slots <= 32 lanes)
// share a unit; a block walks units_per_block consecutive units in `iters`
// iterations. Loop counts are uniform across a warp, so the shuffles always
// see every lane; Unit::ok and a lane's channel test mask what it must not
// touch.
struct Unit {
  bool ok;
  int64_t bq, b;  // batch * Q + query, batch
  int h;
};

struct Layout {
  int lane_c, slot;   // channel group within the chunk, point slot
  int unit_in_iter;   // which unit of an iteration this thread serves
  int units_per_iter, iters, units_per_block, H, Q;
  int64_t first, units;
  __device__ Layout(int lanes_log2, int slots_log2, int units_per_block_,
                    int64_t units_, int H_, int Q_)
      : units_per_block(units_per_block_), H(H_), Q(Q_), units(units_) {
    const int t = threadIdx.x;
    lane_c = t & ((1 << lanes_log2) - 1);
    slot = (t >> lanes_log2) & ((1 << slots_log2) - 1);
    unit_in_iter = t >> (lanes_log2 + slots_log2);
    units_per_iter = blockDim.x >> (lanes_log2 + slots_log2);
    iters = (units_per_block + units_per_iter - 1) / units_per_iter;
    first = static_cast<int64_t>(blockIdx.x) * units_per_block;
  }
  // This thread's unit in iteration `it`.
  __device__ Unit unit(int it) const {
    const int u_local = it * units_per_iter + unit_in_iter;
    const int64_t u = first + u_local;
    Unit r;
    r.ok = u_local < units_per_block && u < units;
    r.bq = r.ok ? u / H : 0;
    r.h = r.ok ? static_cast<int>(u - r.bq * H) : 0;
    r.b = r.bq / Q;
    return r;
  }
};

// The per-point terms: four corner row offsets (in rows of the level) and
// their bilinear weights, zero and offset 0 for corners outside the level.
struct Corners {
  int off[4];
  float w[4];
  float fx, fy;
  bool in[4];
  __device__ Corners(float lx, float ly, int lh, int lw) {
    const float x = lx * lw - 0.5f, y = ly * lh - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    fx = x - x0, fy = y - y0;
    const int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yi = y0i + (k >> 1), xi = x0i + (k & 1);
      in[k] = yi >= 0 && yi < lh && xi >= 0 && xi < lw;
      off[k] = in[k] ? yi * lw + xi : 0;
      const float wy = (k >> 1) ? fy : 1.f - fy;
      const float wx = (k & 1) ? fx : 1.f - fx;
      w[k] = in[k] ? wy * wx : 0.f;
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
    msda_fwd_kernel(const float* __restrict__ value,
                    const int* __restrict__ level_table,
                    const float* __restrict__ loc,
                    const float* __restrict__ attn, float* __restrict__ out,
                    int L, int H, int D, int Q, int Lv, int P, int lanes_log2,
                    int slots_log2, int units_per_block, int64_t units) {
  using V = Vec<VEC>;
  const Layout ly(lanes_log2, slots_log2, units_per_block, units, H, Q);
  const int lanes = 1 << lanes_log2, slots = 1 << slots_log2;
  const int HD = H * D, DG = D / VEC;
  const int chunks = (DG + lanes - 1) / lanes;
  const int p_iters = (P + slots - 1) / slots;
  for (int it = 0; it < ly.iters; ++it) {
    const Unit u = ly.unit(it);
    const float* v_b = value + u.b * L * HD + u.h * D;
    const int64_t pt0 = (u.bq * H + u.h) * Lv * P;  // the unit's 1st point
    for (int ck = 0; ck < chunks; ++ck) {
      const int cg = ck * lanes + ly.lane_c;  // channel group of this lane
      const bool ch_ok = u.ok && cg < DG;
      const float* v_c = v_b + cg * VEC;
      typename V::T acc = V::zero();
      for (int l = 0; l < Lv; ++l) {
        const int lh = __ldg(level_table + 3 * l);
        const int lw = __ldg(level_table + 3 * l + 1);
        const float* v_l =
            v_c + static_cast<int64_t>(__ldg(level_table + 3 * l + 2)) * HD;
        for (int pi = 0; pi < p_iters; ++pi) {
          const int p = pi * slots + ly.slot;
          if (!ch_ok || p >= P) continue;
          const int64_t pt = pt0 + l * P + p;
          const float a = __ldg(attn + pt);
          const Corners cr(__ldg(loc + 2 * pt), __ldg(loc + 2 * pt + 1), lh,
                           lw);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (cr.in[k])
              V::fma(acc, a * cr.w[k],
                     V::load(v_l + static_cast<int64_t>(cr.off[k]) * HD));
          }
        }
      }
      for (int o = lanes; o < (lanes << slots_log2); o <<= 1)
        V::shfl_add(acc, o);
      if (ch_ok && ly.slot == 0)
        V::store(out + u.bq * HD + u.h * D + cg * VEC, acc);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    msda_bwd_kernel(const float* __restrict__ value,
                    const int* __restrict__ level_table,
                    const float* __restrict__ loc,
                    const float* __restrict__ attn,
                    const float* __restrict__ grad_out,
                    float* __restrict__ grad_value,
                    float* __restrict__ grad_loc,
                    float* __restrict__ grad_attn, int L, int H, int D, int Q,
                    int Lv, int P, int lanes_log2, int slots_log2,
                    int units_per_block, int64_t units) {
  using V = Vec<VEC>;
  const Layout ly(lanes_log2, slots_log2, units_per_block, units, H, Q);
  const int lanes = 1 << lanes_log2, slots = 1 << slots_log2;
  const int HD = H * D, DG = D / VEC;
  const int chunks = (DG + lanes - 1) / lanes;
  const int p_iters = (P + slots - 1) / slots;
  for (int it = 0; it < ly.iters; ++it) {
    const Unit u = ly.unit(it);
    const int64_t row0 = u.b * L * HD + u.h * D;
    const int64_t pt0 = (u.bq * H + u.h) * Lv * P;
    for (int ck = 0; ck < chunks; ++ck) {
      const int cg = ck * lanes + ly.lane_c;
      const bool ch_ok = u.ok && cg < DG;
      const typename V::T g =
          ch_ok ? V::load(grad_out + u.bq * HD + u.h * D + cg * VEC)
                : V::zero();
      for (int l = 0; l < Lv; ++l) {
        const int lh = __ldg(level_table + 3 * l);
        const int lw = __ldg(level_table + 3 * l + 1);
        const int64_t start = __ldg(level_table + 3 * l + 2);
        const float* v_l = value + row0 + cg * VEC + start * HD;
        float* gv_l = grad_value + row0 + cg * VEC + start * HD;
        for (int pi = 0; pi < p_iters; ++pi) {
          const int p = pi * slots + ly.slot;
          const bool ok = ch_ok && p < P;  // uniform across a slot's lanes
          const int64_t pt = pt0 + l * P + p;
          float ga = 0.f, gx = 0.f, gy = 0.f, a = 0.f;
          if (ok) {
            a = __ldg(attn + pt);
            const Corners cr(__ldg(loc + 2 * pt), __ldg(loc + 2 * pt + 1), lh,
                             lw);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (!cr.in[k]) continue;
              const int64_t off = static_cast<int64_t>(cr.off[k]) * HD;
              // the location and weight gradients need only <g, corner>
              const float t = V::dot(g, V::load(v_l + off));
              V::atomic_add_scaled(gv_l + off, a * cr.w[k], g);
              const float wy = (k >> 1) ? cr.fy : 1.f - cr.fy;
              const float wx = (k & 1) ? cr.fx : 1.f - cr.fx;
              ga += cr.w[k] * t;
              gx += ((k & 1) ? wy : -wy) * t;
              gy += ((k >> 1) ? wx : -wx) * t;
            }
          }
          // sums over the head's channels: the slot's lanes, in every chunk
          for (int o = 1; o < lanes; o <<= 1) {
            ga += __shfl_xor_sync(0xffffffffu, ga, o);
            gx += __shfl_xor_sync(0xffffffffu, gx, o);
            gy += __shfl_xor_sync(0xffffffffu, gy, o);
          }
          // lane 0 of the slot stores; wider heads add their later chunks
          // to it (same thread, so no atomics and no zeroed outputs)
          if (ok && ly.lane_c == 0) {
            gx *= a * lw;
            gy *= a * lh;
            if (ck > 0) {
              ga += grad_attn[pt];
              gx += grad_loc[2 * pt];
              gy += grad_loc[2 * pt + 1];
            }
            grad_attn[pt] = ga;
            grad_loc[2 * pt] = gx;
            grad_loc[2 * pt + 1] = gy;
          }
        }
      }
    }
  }
}

struct Launch {
  int vec, lanes_log2, slots_log2, units_per_block;
  unsigned blocks;
};

int log2_ceil(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The layout for a call: float4 lanes where D and the pointers allow; lanes
// per slot the next power of two of D / vec (at most 32); slots per unit
// the power of two that wastes the fewest lane-iterations on P points, the
// larger on a tie; kQueryTile queries of units per block (rounded up to
// whole iterations of the block).
Launch plan(int64_t B, int H, int D, int Q, int P, bool vec4_ok) {
  Launch lc;
  lc.vec = (D % 4 == 0 && vec4_ok) ? 4 : 1;
  const int DG = D / lc.vec;
  lc.lanes_log2 = log2_ceil(DG < 32 ? DG : 32);
  int best = 0, best_cost = P;
  for (int s = 1; s <= 5 - lc.lanes_log2; ++s) {
    const int slots = 1 << s;
    const int cost = ((P + slots - 1) / slots) * slots;
    if (cost <= best_cost) best = s, best_cost = cost;
  }
  lc.slots_log2 = best;
  const int64_t units = B * Q * H;
  const int per_iter = kThreads >> (lc.lanes_log2 + lc.slots_log2);
  lc.units_per_block =
      (kQueryTile * H + per_iter - 1) / per_iter * per_iter;
  lc.blocks = static_cast<unsigned>((units + lc.units_per_block - 1) /
                                    lc.units_per_block);
  return lc;
}

}  // namespace

// level_table: device int32 (Lv, 3) rows of (h, w, start offset into L).
extern "C" int msda_fwd(const float* value, const int* level_table,
                        const float* loc, const float* attn, float* out,
                        int64_t B, int L, int H, int D, int Q, int Lv, int P,
                        void* stream) {
  const int64_t units = B * Q * H;
  if (units > 0 && D > 0) {
    const Launch lc = plan(B, H, D, Q, P, aligned16(value) && aligned16(out));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lc.vec == 4)
      msda_fwd_kernel<4><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, out, L, H, D, Q, Lv, P,
          lc.lanes_log2, lc.slots_log2, lc.units_per_block, units);
    else
      msda_fwd_kernel<1><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, out, L, H, D, Q, Lv, P,
          lc.lanes_log2, lc.slots_log2, lc.units_per_block, units);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_value must be zeroed by the caller (the kernel accumulates into it);
// grad_loc and grad_attn are written in full.
extern "C" int msda_bwd(const float* value, const int* level_table,
                        const float* loc, const float* attn,
                        const float* grad_out, float* grad_value,
                        float* grad_loc, float* grad_attn, int64_t B, int L,
                        int H, int D, int Q, int Lv, int P, void* stream) {
  const int64_t units = B * Q * H;
  if (units > 0 && D > 0) {
    const Launch lc =
        plan(B, H, D, Q, P,
             aligned16(value) && aligned16(grad_out) && aligned16(grad_value));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lc.vec == 4)
      msda_bwd_kernel<4><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, grad_out, grad_value, grad_loc,
          grad_attn, L, H, D, Q, Lv, P, lc.lanes_log2, lc.slots_log2,
          lc.units_per_block, units);
    else
      msda_bwd_kernel<1><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, grad_out, grad_value, grad_loc,
          grad_attn, L, H, D, Q, Lv, P, lc.lanes_log2, lc.slots_log2,
          lc.units_per_block, units);
  }
  return static_cast<int>(cudaGetLastError());
}
