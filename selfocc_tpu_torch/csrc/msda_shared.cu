// Multi-scale deformable attention with head-shared sampling locations:
// forward (msda_shared_fwd) and backward (msda_shared_bwd).
//
// Replaces: selfocc_tpu/ops/msda.py::_msda_dense_shared (pure XLA on the
// TPU: per level and per point, one gather of the (B, H*D, Q) channel-first
// payload at head 0's locations, bf16 payloads unless corner-bundled, an
// fp32 reduction with each head's attention weight, and a jax.checkpoint
// per point) and its autodiff. Semantics as the per-head op (msda.cu):
// grid_sample with align_corners=False and zeros padding, i.e. fractional
// pixel = loc * size - 0.5; every head samples the same (query, level,
// point) location with its own weight; accumulation in fp32, payloads fp32.
//
// What a shared location changes on this card. A corner of a point is one
// contiguous H*D row of the value, all heads together (96 floats, 384
// bytes at H = 6, D = 16), not H rows of D floats at H places; and the
// point's floor, fractions, bounds tests and four corner weights serve all
// heads at once. What bounds it: as for the per-head op, not HBM bytes (the
// compacted hw call must move about 226 MB: value 59, locations 31,
// weights 91, output 46) but the rate at which L2 serves the corner rows,
// here 4 x 384 bytes per point, and in the backward the float4 atomics
// into grad_value.
//
// Design (the per-head kernel's mapping, msda.cu, with the heads moved
// into the lanes):
// - A unit is one (batch, query). A lane owns VEC = 4 channels (one
//   float4) of one head: lanes_c lanes cover a head's D channels and
//   hslots head slots sit side by side, so at H = 6, D = 16 the unit's 24
//   working lanes read each corner row as one coalesced 384-byte load
//   (8 lanes of the warp idle: head slots are a power of two). Each lane
//   applies its own head's weight. Remaining lanes of a warp, where a unit
//   takes fewer than 32, are point slots that walk their own subset of the
//   points, reduced with shuffles once per unit.
// - Every lane of a point computes the point's corner terms itself: one
//   warp-wide instruction sequence per point serves all its heads (the
//   per-head kernel runs it once per head).
// - Backward: per corner a lane dots its float4 of the cotangent with the
//   corner's and adds a_h * w_corner * g to grad_value with one vector
//   atomic (atomicAdd(float4*)). The weight gradient is summed over each
//   head's lanes, the location gradient (each lane's slopes scaled by its
//   head's weight) over all lanes of the point, with shuffles; the location
//   gradient is thereby the sum over heads.
// - Other widths are instances of the same kernels: VEC = 1 when D is not a
//   multiple of 4 or a pointer is not 16-byte aligned (chosen by the
//   launcher, not per lane); lanes per head the next power of two of
//   D / VEC up to 32, channel chunks when a head is wider; head passes when
//   H does not fit the lanes left. Later chunks and passes of a point are
//   added by the same thread, so no atomics and no zeroed outputs there.
//   Any H and D are taken.
//
// First times (chip_smoke.py [levers], NVIDIA H100 80GB HBM3, 700.00 W;
// device ms, random locations; the per-head msda_fwd / msda_bwd on the same
// locations broadcast to every head in brackets): forward at the compacted
// hw call (6 x 19,840 queries, P 8) 0.687 (0.713), bound 0.068; zh (6 x
// 4,864, P 48) 0.980 (0.900); TPV self (78,899, P 12) 0.669 (0.569).
// Backward 2.015 (1.924), bound 0.1215; 2.826 (2.985); 1.683 (1.829). In the
// nuscenes_occ_fast step 0.730 / 1.784 per call, the per-head pair 0.637 /
// 1.527 on the same compacted queries. So this mapping gains nothing from
// the contiguous rows: a warp walks one point at a time with 8 of its 32
// lanes idle (head slots are a power of two), where the per-head kernel
// keeps 8 points in flight on every lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueryTile = 8;  // (batch, query) units per block

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
// Bits of threadIdx.x from the lowest: the channel lane within a head
// (lc_log2), the head slot (hs_log2), the point slot (sl_log2), then the
// unit of an iteration. Loop counts are uniform across a warp, so the
// shuffles always see every lane; ok flags mask what a lane must not touch.
struct Layout {
  int lane_c, hslot, slot, group_log2;
  int units_per_iter, iters, units_per_block, unit_in_iter;
  int64_t first, units;
  __device__ Layout(int lc_log2, int hs_log2, int sl_log2,
                    int units_per_block_, int64_t units_)
      : units_per_block(units_per_block_), units(units_) {
    const int t = threadIdx.x;
    lane_c = t & ((1 << lc_log2) - 1);
    hslot = (t >> lc_log2) & ((1 << hs_log2) - 1);
    slot = (t >> (lc_log2 + hs_log2)) & ((1 << sl_log2) - 1);
    group_log2 = lc_log2 + hs_log2 + sl_log2;
    unit_in_iter = t >> group_log2;
    units_per_iter = blockDim.x >> group_log2;
    iters = (units_per_block + units_per_iter - 1) / units_per_iter;
    first = static_cast<int64_t>(blockIdx.x) * units_per_block;
  }
  // This thread's unit (batch * Q + query) in iteration `it`; ok if real.
  __device__ int64_t unit(int it, bool& ok) const {
    const int u_local = it * units_per_iter + unit_in_iter;
    const int64_t u = first + u_local;
    ok = u_local < units_per_block && u < units;
    return ok ? u : 0;
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
__global__ void __launch_bounds__(kThreads)
    msda_shared_fwd_kernel(const float* __restrict__ value,
                           const int* __restrict__ level_table,
                           const float* __restrict__ loc,
                           const float* __restrict__ attn,
                           float* __restrict__ out, int L, int H, int D,
                           int Q, int Lv, int P, int lc_log2, int hs_log2,
                           int sl_log2, int units_per_block, int64_t units) {
  using V = Vec<VEC>;
  const Layout ly(lc_log2, hs_log2, sl_log2, units_per_block, units);
  const int lanes_c = 1 << lc_log2, hslots = 1 << hs_log2;
  const int slots = 1 << sl_log2;
  const int HD = H * D, DG = D / VEC, LP = Lv * P;
  const int chunks = (DG + lanes_c - 1) / lanes_c;
  const int passes = (H + hslots - 1) / hslots;
  const int p_iters = (P + slots - 1) / slots;
  for (int it = 0; it < ly.iters; ++it) {
    bool u_ok;
    const int64_t bq = ly.unit(it, u_ok);
    const float* v_b = value + (bq / Q) * L * HD;
    const float* loc_u = loc + bq * LP * 2;
    for (int pass = 0; pass < passes; ++pass) {
      const int h = pass * hslots + ly.hslot;
      const float* attn_h = attn + (bq * H + h) * LP;
      for (int ck = 0; ck < chunks; ++ck) {
        const int cg = ck * lanes_c + ly.lane_c;  // channel group in head
        const bool ch_ok = u_ok && h < H && cg < DG;
        const float* v_c = v_b + h * D + cg * VEC;
        typename V::T acc = V::zero();
        for (int l = 0; l < Lv; ++l) {
          const int lh = __ldg(level_table + 3 * l);
          const int lw = __ldg(level_table + 3 * l + 1);
          const float* v_l =
              v_c + static_cast<int64_t>(__ldg(level_table + 3 * l + 2)) * HD;
          for (int pi = 0; pi < p_iters; ++pi) {
            const int p = pi * slots + ly.slot;
            if (!ch_ok || p >= P) continue;
            const int lp = l * P + p;
            const float a = __ldg(attn_h + lp);
            const Corners cr(__ldg(loc_u + 2 * lp), __ldg(loc_u + 2 * lp + 1),
                             lh, lw);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (cr.in[k])
                V::fma(acc, a * cr.w[k],
                       V::load(v_l + static_cast<int64_t>(cr.off[k]) * HD));
            }
          }
        }
        // sum over the point slots
        for (int o = lanes_c << hs_log2; o < (1 << ly.group_log2); o <<= 1)
          V::shfl_add(acc, o);
        if (ch_ok && ly.slot == 0)
          V::store(out + bq * HD + h * D + cg * VEC, acc);
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    msda_shared_bwd_kernel(const float* __restrict__ value,
                           const int* __restrict__ level_table,
                           const float* __restrict__ loc,
                           const float* __restrict__ attn,
                           const float* __restrict__ grad_out,
                           float* __restrict__ grad_value,
                           float* __restrict__ grad_loc,
                           float* __restrict__ grad_attn, int L, int H,
                           int D, int Q, int Lv, int P, int lc_log2,
                           int hs_log2, int sl_log2, int units_per_block,
                           int64_t units) {
  using V = Vec<VEC>;
  const Layout ly(lc_log2, hs_log2, sl_log2, units_per_block, units);
  const int lanes_c = 1 << lc_log2, hslots = 1 << hs_log2;
  const int slots = 1 << sl_log2;
  const int HD = H * D, DG = D / VEC, LP = Lv * P;
  const int chunks = (DG + lanes_c - 1) / lanes_c;
  const int passes = (H + hslots - 1) / hslots;
  const int p_iters = (P + slots - 1) / slots;
  const int point_lanes = lanes_c << hs_log2;  // a point's lanes
  for (int it = 0; it < ly.iters; ++it) {
    bool u_ok;
    const int64_t bq = ly.unit(it, u_ok);
    const int64_t row0 = (bq / Q) * L * HD;
    const float* loc_u = loc + bq * LP * 2;
    float* gloc_u = grad_loc + bq * LP * 2;
    for (int pass = 0; pass < passes; ++pass) {
      const int h = pass * hslots + ly.hslot;
      const float* attn_h = attn + (bq * H + h) * LP;
      float* gattn_h = grad_attn + (bq * H + h) * LP;
      for (int ck = 0; ck < chunks; ++ck) {
        const int cg = ck * lanes_c + ly.lane_c;
        const bool ch_ok = u_ok && h < H && cg < DG;
        const int64_t c0 = row0 + h * D + cg * VEC;
        const typename V::T g =
            ch_ok ? V::load(grad_out + bq * HD + h * D + cg * VEC)
                  : V::zero();
        const bool first = pass == 0 && ck == 0;
        for (int l = 0; l < Lv; ++l) {
          const int lh = __ldg(level_table + 3 * l);
          const int lw = __ldg(level_table + 3 * l + 1);
          const int64_t start = __ldg(level_table + 3 * l + 2);
          const float* v_l = value + c0 + start * HD;
          float* gv_l = grad_value + c0 + start * HD;
          for (int pi = 0; pi < p_iters; ++pi) {
            const int p = pi * slots + ly.slot;
            const bool ok = u_ok && p < P;  // uniform across a point's lanes
            const bool lane_ok = ok && ch_ok;
            const int lp = l * P + p;
            float ga = 0.f, gx = 0.f, gy = 0.f, a = 0.f;
            if (lane_ok) {
              a = __ldg(attn_h + lp);
              const Corners cr(__ldg(loc_u + 2 * lp),
                               __ldg(loc_u + 2 * lp + 1), lh, lw);
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
              gx *= a * lw;
              gy *= a * lh;
            }
            // the weight gradient: a sum over the head's lanes
            for (int o = 1; o < lanes_c; o <<= 1)
              ga += __shfl_xor_sync(0xffffffffu, ga, o);
            // the location gradient: a sum over every head's lanes
            for (int o = 1; o < point_lanes; o <<= 1) {
              gx += __shfl_xor_sync(0xffffffffu, gx, o);
              gy += __shfl_xor_sync(0xffffffffu, gy, o);
            }
            if (lane_ok && ly.lane_c == 0)
              gattn_h[lp] = ck == 0 ? ga : gattn_h[lp] + ga;
            if (ok && ly.lane_c == 0 && ly.hslot == 0) {
              if (!first) {
                gx += gloc_u[2 * lp];
                gy += gloc_u[2 * lp + 1];
              }
              gloc_u[2 * lp] = gx;
              gloc_u[2 * lp + 1] = gy;
            }
          }
        }
      }
    }
  }
}

struct Launch {
  int vec, lc_log2, hs_log2, sl_log2, units_per_block;
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
// per head the next power of two of D / vec (at most 32); head slots the
// next power of two of H in the lanes left; point slots in the lanes left
// after that, the power of two that wastes the fewest lane-iterations on P
// points (the larger on a tie); kQueryTile units per block, rounded up to
// whole iterations of the block.
Launch plan(int64_t units, int H, int D, int P, bool vec4_ok) {
  Launch lc;
  lc.vec = (D % 4 == 0 && vec4_ok) ? 4 : 1;
  const int DG = D / lc.vec;
  lc.lc_log2 = log2_ceil(DG < 32 ? DG : 32);
  const int hs = log2_ceil(H);
  lc.hs_log2 = hs < 5 - lc.lc_log2 ? hs : 5 - lc.lc_log2;
  int best = 0, best_cost = P;
  for (int s = 1; s <= 5 - lc.lc_log2 - lc.hs_log2; ++s) {
    const int slots = 1 << s;
    const int cost = ((P + slots - 1) / slots) * slots;
    if (cost <= best_cost) best = s, best_cost = cost;
  }
  lc.sl_log2 = best;
  const int per_iter = kThreads >> (lc.lc_log2 + lc.hs_log2 + lc.sl_log2);
  lc.units_per_block = (kQueryTile + per_iter - 1) / per_iter * per_iter;
  lc.blocks = static_cast<unsigned>((units + lc.units_per_block - 1) /
                                    lc.units_per_block);
  return lc;
}

}  // namespace

// value (B, L, H, D); loc (B, Q, Lv, P, 2); attn (B, Q, H, Lv, P);
// out (B, Q, H * D); level_table: device int32 (Lv, 3) rows of (h, w, start
// offset into L).
extern "C" int msda_shared_fwd(const float* value, const int* level_table,
                               const float* loc, const float* attn,
                               float* out, int64_t B, int L, int H, int D,
                               int Q, int Lv, int P, void* stream) {
  const int64_t units = B * Q;
  if (units > 0 && H > 0 && D > 0) {
    const Launch lc = plan(units, H, D, P, aligned16(value) && aligned16(out));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lc.vec == 4)
      msda_shared_fwd_kernel<4><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, out, L, H, D, Q, Lv, P, lc.lc_log2,
          lc.hs_log2, lc.sl_log2, lc.units_per_block, units);
    else
      msda_shared_fwd_kernel<1><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, out, L, H, D, Q, Lv, P, lc.lc_log2,
          lc.hs_log2, lc.sl_log2, lc.units_per_block, units);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_value must be zeroed by the caller (the kernel accumulates into it);
// grad_loc and grad_attn are written in full.
extern "C" int msda_shared_bwd(const float* value, const int* level_table,
                               const float* loc, const float* attn,
                               const float* grad_out, float* grad_value,
                               float* grad_loc, float* grad_attn, int64_t B,
                               int L, int H, int D, int Q, int Lv, int P,
                               void* stream) {
  const int64_t units = B * Q;
  if (units > 0 && H > 0 && D > 0) {
    const Launch lc =
        plan(units, H, D, P,
             aligned16(value) && aligned16(grad_out) && aligned16(grad_value));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lc.vec == 4)
      msda_shared_bwd_kernel<4><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, grad_out, grad_value, grad_loc,
          grad_attn, L, H, D, Q, Lv, P, lc.lc_log2, lc.hs_log2, lc.sl_log2,
          lc.units_per_block, units);
    else
      msda_shared_bwd_kernel<1><<<lc.blocks, kThreads, 0, st>>>(
          value, level_table, loc, attn, grad_out, grad_value, grad_loc,
          grad_attn, L, H, D, Q, Lv, P, lc.lc_log2, lc.hs_log2, lc.sl_log2,
          lc.units_per_block, units);
  }
  return static_cast<int>(cudaGetLastError());
}
