// Multi-scale deformable attention with head-shared sampling locations:
// forward (msda_shared_fwd) and backward (msda_shared_bwd).
//
// Replaces: selfocc_tpu/ops/msda.py::_msda_dense_shared (:275; pure XLA on
// the TPU: per level and per point, one gather of the (B, H*D, Q)
// channel-first payload at head 0's locations, an fp32 reduction with each
// head's attention weight, a jax.checkpoint per point) and its autodiff.
// Semantics as the per-head op (msda.cu): grid_sample with
// align_corners=False and zeros padding, i.e. fractional pixel = loc * size
// - 0.5; every head samples the same (query, level, point) location with its
// own weight; payloads and accumulation fp32.
//
// What bounds it on the H100. A corner of a point is one contiguous H*D row
// of the value, all heads together (384 bytes at H = 6, D = 16). The
// compacted hw call (6 x 19,840 queries, 4 levels x 8 points) must move
// about 226 MB to and from HBM (value 59, locations 31, weights 91, output
// 46): 0.068 ms at 3.35 TB/s. Its corner rows are 119,040 x 32 x 4 x 384 B
// = 5.85 GB, and one camera's value (9.8 MB) stays in the 50 MB L2, so the
// rows come from L2 and L1, not HBM: at the L1 line rate (128 B per clock
// per SM, about 30 TB/s over 132 SMs) the forward would take about 0.2 ms.
// On random locations only the smallest level (115 KB a camera) is reused
// in L1; the forward pulls its rows at ~10 TB/s, from L2 for the most. The
// backward reads the same rows and sends 4.06 GB of float4 REDs (one per
// in-bounds corner and row float4) into grad_value: two thirds of its time
// is its excess over the forward, about 3.7 TB/s of REDs at hw.
//
// Design:
// - Lane groups on a point's row. A group of G lanes reads one point's
//   row; lane j owns R float4s of it, j, j + G, j + 2G, ... (at H*D = 96:
//   G = 8, R = 3). A warp-wide load then reads 128 contiguous bytes of each
//   of 32 / G points, and every lane works. Since D % 4 == 0 a float4 lies
//   in one head; a lane applies its float4's head weight. Each lane
//   computes its point's floor, fractions, bounds tests and corner weights
//   once for all heads. A group has one point (12 float4 loads a lane) in
//   flight. The forward is held to 64 registers (4 blocks of 256 per SM),
//   the backward to 128 (it uses 94: 5 blocks of 128).
// - Tiles staged in shared memory. A block takes tiles of T consecutive
//   (batch, query) units. A tile's locations and weights are contiguous in
//   global memory and come in by 1-D TMA bulk copies completed on an
//   mbarrier; lanes read their heads' weights from shared memory. The S
//   groups of a unit split its points; the forward sums their rows with
//   shuffles, once per unit. The forward takes one tile a block. The
//   backward's blocks are persistent, with a grid stride over the tiles,
//   and double-buffer the copies where that costs no resident threads
//   (tile t + 1's copy runs under tile t's corner walk). The launcher picks
//   the block size, the buffers and (backward) whether the gradients go
//   through the tile by the resident threads the occupancy calculator
//   gives each.
// - Backward: grad_out's R float4s per lane stay in registers for the
//   unit. Per corner a lane dots its float4s with the corner's and sends R
//   float4 REDs (atomicAdd(float4*), result unused) into grad_value,
//   coalesced over the group. The weight gradient per (point, head) is a
//   sum over the head's D / 4 lanes, the location gradient (each lane's
//   slopes scaled by its float4s' head weights) over the G lanes, for the
//   warp's 32 / G points at once; each element is written once, through
//   the tile in shared memory and out with coalesced stores where staged.
// - Other widths are instances of the same kernels, chosen by the launcher,
//   never per lane: G = 8 and R from {2, 3, 4, 6, 8} when the row has more
//   than 8 float4s (a masked tail where it is not a multiple of G), G the
//   next power of two of the row and R = 1 when it has fewer, channel
//   chunks of G * R float4s beyond 64; VEC = 1 (floats for float4s) when D
//   % 4 != 0 or a row pointer is not 16-byte aligned; a segmented scan for
//   the weight gradient when a head's lanes are not an aligned power of two
//   of the group. Tiles whose copies cannot be bulk (a location or weight
//   block not a multiple of 16 bytes, or an unaligned pointer) are staged
//   by plain loads; tiles that fit no shared memory (a unit of ~7,300
//   points or more at H = 6) are read in place. Any H, D, Lv and P are
//   taken.
//
// Device ms (chip_smoke.py [levers] and its shared_ab with --baseline: the
// previous design, a lane per head's float4 and a point per warp step,
// from commit 7f058fc timed in turns in the same call, in brackets; NVIDIA
// H100 80GB HBM3, 700.00 W): forward at the compacted hw call 0.542-0.558
// (0.692), bound 0.068; zh (6 x 4,864, P 48) 0.837-0.843 (0.980-0.985);
// TPV self (78,899, P 12) 0.432 (0.548-0.552). Backward 1.650-1.668
// (1.873-1.909), bound 0.122; zh 2.624-2.665 (2.833-2.837); self
// 1.625-1.679 (1.640-1.646). In the nuscenes_occ_fast step 0.541-0.545 /
// 1.466-1.478 per call (0.733-0.734 / 1.790-1.791, an earlier call).
// Measured and removed (times in PERF.md): two points in flight per group;
// the last level's value gradient added in shared memory (shared fp32
// atomics are compare-and-swap loops; 2.79 ms at hw); a persistent
// forward (+3%); a one-tile backward (faster alone, +6% in the step, where
// locations cluster and a block's copy wait shows); plain-load staging
// (+4-11%); reading tiles in place (backward +1-6%; forward -10% at zh
// alone, a tie in the step).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGroupMax = 8;       // lanes on a point's row, at most
constexpr int kSmemMax = 227 << 10;     // a block's staging, at most
// Blocks of kMaxThreads per SM that the register budget must allow: the
// forward at 64 registers, the backward at 128 (each the fastest on the
// H100 of the counts tried: 1, 4 and 5 for the forward, 1 to 4 for the
// backward).
constexpr int kFwdMinBlocks = 4;
constexpr int kBwdMinBlocks = 2;
// The forward's tile a warp, at most, when a unit can take fewer groups.
constexpr int kFwdWarpBytes = 4 << 10;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kBulk = 0, kCopy = 1, kDirect = 2 };

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
  __device__ static void red_scaled(float* p, float s, float4 g) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(s * g.x, s * g.y, s * g.z, s * g.w));
  }
  __device__ static void shfl_add(float4& v, int o) {
    v.x += __shfl_xor_sync(kFull, v.x, o);
    v.y += __shfl_xor_sync(kFull, v.y, o);
    v.z += __shfl_xor_sync(kFull, v.z, o);
    v.w += __shfl_xor_sync(kFull, v.w, o);
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
  __device__ static void red_scaled(float* p, float s, float g) {
    atomicAdd(p, s * g);
  }
  __device__ static void shfl_add(float& v, int o) {
    v += __shfl_xor_sync(kFull, v, o);
  }
};

// Shared-memory addresses and the sm_90 asynchronous copies.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's (and, after a barrier, the block's) earlier
// shared-memory accesses before later bulk copies into the same memory.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One launch's shapes, pointers and plan; the same struct for both kernels.
struct Params {
  const float* value;
  const int* level_table;  // (Lv, 3): h, w, start row
  const float* loc;        // (units, Lv * P, 2)
  const float* attn;       // (units, H, Lv * P)
  const float* grad_out;   // (units, H * D); backward
  float* out;              // (units, H * D); forward
  float* grad_value;       // backward, zeroed by the caller
  float* grad_loc;
  float* grad_attn;
  int64_t units, tiles;
  int L, H, D, Q, Lv, P, LP, HD;
  int F;                   // row width in vectors, H * D / VEC
  int g_log2, s_log2;      // lanes per group, groups per unit
  int chunks;              // passes over a row, G * R vectors each
  int T;                   // units per tile
  int mode;                // kBulk, kCopy or kDirect
  int bufs;                // tile buffers: 2 double-buffers the bulk copies
  int head_aligned;        // D / VEC a power of two no wider than G
  int loc_bytes, attn_bytes;      // a tile's staged blocks, 16-byte padded
  int buf_bytes, grads_offset;    // a buffer, the backward's gradient tile
  int grads_staged;               // gradients through the tile
};

// The dynamic shared memory: two mbarriers and the level table, then the
// tile buffers (none read in place, two double-buffering bulk copies),
// then the backward's gradient tile (laid out as a buffer) where it is
// staged.
constexpr int kHeadBytes = 16;

__host__ __device__ inline int pad16(int bytes) { return (bytes + 15) & ~15; }

__host__ __device__ inline int level_bytes(int Lv) {
  return pad16(3 * Lv * 4);
}

// Which lanes do what. A group of G lanes is one point slot; S groups
// (consecutive in the warp) share a unit; a warp holds 32 / (G * S) units
// of the tile, a block T.
struct Lanes {
  int j, s, unit;
  __device__ explicit Lanes(const Params& p) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int grp = lane >> p.g_log2;
    j = lane & ((1 << p.g_log2) - 1);
    s = grp & ((1 << p.s_log2) - 1);
    unit = warp * (32 >> (p.g_log2 + p.s_log2)) + (grp >> p.s_log2);
  }
};

// A tile's locations and weights as the block reads them, and where its
// location and weight gradients go: shared memory, or global memory in
// kDirect mode.
struct TileView {
  const float* loc;
  const float* attn;
  float* gloc;
  float* gattn;
  int n;  // real units in the tile
};

// Copies n floats with the whole block, float4 at a time where allowed.
__device__ void block_copy(float* dst, const float* src, int n, bool vec4) {
  if (vec4) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    for (int i = (n & ~3) + threadIdx.x; i < n; i += blockDim.x)
      dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// A block's walk over its tiles (one in the forward, a grid stride in the
// backward): staging in, the view, and for the backward the gradient tile
// out.
class Stage {
 public:
  __device__ Stage(const Params& p, unsigned char* smem, bool grads)
      : p_(p), smem_(smem), grads_(grads) {
    bar_ = reinterpret_cast<uint64_t*>(smem);
    lvl_ = reinterpret_cast<int*>(smem + kHeadBytes);
    for (int i = threadIdx.x; i < 3 * p.Lv; i += blockDim.x)
      lvl_[i] = __ldg(p.level_table + i);
    if (p.mode == kBulk && threadIdx.x == 0) {
      mbar_init(&bar_[0]);
      mbar_init(&bar_[1]);
      issue(0, blockIdx.x);
    }
    __syncthreads();
  }

  __device__ const int* levels() const { return lvl_; }

  // Waits for (or copies in) tile `tile`, the block's i-th; with two
  // buffers, first starts the copy of the block's next tile into the other.
  __device__ TileView begin(int i, int64_t tile) {
    TileView v;
    const int64_t u0 = tile * p_.T;
    v.n = static_cast<int>(min(static_cast<int64_t>(p_.T), p_.units - u0));
    const int64_t loc0 = u0 * p_.LP * 2, attn0 = u0 * p_.H * p_.LP;
    if (p_.mode == kDirect) {
      v.loc = p_.loc + loc0;
      v.attn = p_.attn + attn0;
      v.gloc = p_.grad_loc + loc0;
      v.gattn = p_.grad_attn + attn0;
    } else {
      int buf = 0;
      if (p_.mode == kBulk) {
        if (p_.bufs == 2) {
          buf = i & 1;
          const int64_t next = tile + gridDim.x;
          if (threadIdx.x == 0 && next < p_.tiles) {
            fence_async_smem();
            issue(buf ^ 1, next);
          }
          mbar_wait(&bar_[buf], (i >> 1) & 1);
        } else {
          if (threadIdx.x == 0 && i > 0) {
            fence_async_smem();
            issue(0, tile);
          }
          mbar_wait(&bar_[0], i & 1);
        }
      } else {
        block_copy(buffer_loc(0), p_.loc + loc0, v.n * p_.LP * 2, false);
        block_copy(buffer_attn(0), p_.attn + attn0, v.n * p_.H * p_.LP,
                   false);
        __syncthreads();
      }
      v.loc = buffer_loc(buf);
      v.attn = buffer_attn(buf);
      v.gloc = p_.grads_staged ? grads_loc() : p_.grad_loc + loc0;
      v.gattn = p_.grads_staged ? grads_attn() : p_.grad_attn + attn0;
    }
    if (grads_ && !p_.head_aligned) {
      // the segmented weight-gradient sums add into a zeroed tile
      for (int k = threadIdx.x; k < v.n * p_.H * p_.LP; k += blockDim.x)
        v.gattn[k] = 0.f;
      __syncthreads();
    }
    return v;
  }

  // Writes the tile's gradients out; the block is done with the buffer.
  __device__ void end(const TileView& v, int64_t tile) {
    if (grads_ && p_.grads_staged) {
      __syncthreads();
      const int64_t u0 = tile * p_.T;
      const bool vec4 = p_.mode == kBulk;
      block_copy(p_.grad_loc + u0 * p_.LP * 2, v.gloc, v.n * p_.LP * 2,
                 vec4);
      block_copy(p_.grad_attn + u0 * p_.H * p_.LP, v.gattn,
                 v.n * p_.H * p_.LP, vec4);
    }
    __syncthreads();
  }

 private:
  __device__ float* buffer_loc(int b) const {
    return reinterpret_cast<float*>(smem_ + kHeadBytes + level_bytes(p_.Lv) +
                                    b * p_.buf_bytes);
  }
  __device__ float* buffer_attn(int b) const {
    return buffer_loc(b) + p_.loc_bytes / 4;
  }
  __device__ float* grads_loc() const {
    return reinterpret_cast<float*>(smem_ + p_.grads_offset);
  }
  __device__ float* grads_attn() const {
    return grads_loc() + p_.loc_bytes / 4;
  }
  // One thread: the bulk copies of tile `tile` into buffer b.
  __device__ void issue(int b, int64_t tile) {
    const int64_t u0 = tile * p_.T;
    const int n = static_cast<int>(
        min(static_cast<int64_t>(p_.T), p_.units - u0));
    const uint32_t lb = n * p_.LP * 8, ab = n * p_.H * p_.LP * 4;
    mbar_expect(&bar_[b], lb + ab);
    bulk_load(buffer_loc(b), p_.loc + u0 * p_.LP * 2, lb, &bar_[b]);
    bulk_load(buffer_attn(b), p_.attn + u0 * p_.H * p_.LP, ab, &bar_[b]);
  }

  const Params& p_;
  unsigned char* smem_;
  bool grads_;
  uint64_t* bar_;
  int* lvl_;
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

// A point of a unit: its level, the level's size and first row.
struct Point {
  int lw, lh;
  int64_t start;
  __device__ Point(const int* lvl, int lp, int P) {
    const int l = lp / P;
    lh = lvl[3 * l];
    lw = lvl[3 * l + 1];
    start = lvl[3 * l + 2];
  }
};

// This lane's R vectors of chunk c: offsets into a row, whether they are
// real, and their heads.
template <int VEC, int R>
struct RowSlice {
  int off[R];
  int head[R];
  bool ok[R];
  __device__ RowSlice(const Params& p, int c, int j, bool unit_ok) {
    const int G = 1 << p.g_log2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int f = (c * R + r) * G + j;
      ok[r] = unit_ok && f < p.F;
      off[r] = ok[r] ? f * VEC : 0;
      head[r] = ok[r] ? f * VEC / p.D : p.H;
    }
  }
};

template <int VEC, int R>
__global__ void __launch_bounds__(kMaxThreads, kFwdMinBlocks)
    msda_shared_fwd_kernel(const Params p) {
  using V = Vec<VEC>;
  extern __shared__ __align__(128) unsigned char smem[];
  Stage stage(p, smem, false);
  const Lanes ln(p);
  const int* lvl = stage.levels();
  const int G = 1 << p.g_log2, S = 1 << p.s_log2;
  int i = 0;
  for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++i) {
    const TileView tv = stage.begin(i, tile);
    const bool ok = ln.unit < tv.n;
    const int64_t u = tile * p.T + ln.unit;
    const float* v_b = p.value + (ok ? u / p.Q : 0) * p.L * p.HD;
    const float* loc_u = tv.loc + ln.unit * p.LP * 2;
    const float* attn_u = tv.attn + ln.unit * p.H * p.LP;
    for (int c = 0; c < p.chunks; ++c) {
      const RowSlice<VEC, R> rs(p, c, ln.j, ok);
      typename V::T acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = V::zero();
      for (int base = 0; base < p.LP; base += S) {
        const int lp = base + ln.s;
        typename V::T val[4][R];
        float wa[4][R];
        const bool pok = ok && lp < p.LP;
        const Point pt(lvl, pok ? lp : 0, p.P);
        const Corners cr(pok ? loc_u[2 * lp] : 0.f,
                         pok ? loc_u[2 * lp + 1] : 0.f, pt.lh, pt.lw);
        const float* v_l = v_b + pt.start * p.HD;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool use = pok && rs.ok[r];
          const float a = use ? attn_u[rs.head[r] * p.LP + lp] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            wa[k][r] = a * cr.w[k];
            val[k][r] =
                use && cr.in[k]
                    ? V::load(v_l + static_cast<int64_t>(cr.off[k]) * p.HD +
                              rs.off[r])
                    : V::zero();
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < R; ++r) V::fma(acc[r], wa[k][r], val[k][r]);
      }
      // the unit's S groups: one row
      for (int o = G; o < G * S; o <<= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) V::shfl_add(acc[r], o);
      if (ln.s == 0)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (rs.ok[r]) V::store(p.out + u * p.HD + rs.off[r], acc[r]);
    }
    stage.end(tv, tile);
  }
}

template <int VEC, int R>
__global__ void __launch_bounds__(kMaxThreads, kBwdMinBlocks)
    msda_shared_bwd_kernel(const Params p) {
  using V = Vec<VEC>;
  extern __shared__ __align__(128) unsigned char smem[];
  Stage stage(p, smem, true);
  const Lanes ln(p);
  const int* lvl = stage.levels();
  const int G = 1 << p.g_log2, S = 1 << p.s_log2;
  const int DG = p.D / VEC;  // a head's vectors
  int i = 0;
  for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++i) {
    const TileView tv = stage.begin(i, tile);
    const bool ok = ln.unit < tv.n;
    const int64_t u = tile * p.T + ln.unit;
    const int64_t row0 = (ok ? u / p.Q : 0) * p.L * p.HD;
    const float* loc_u = tv.loc + ln.unit * p.LP * 2;
    const float* attn_u = tv.attn + ln.unit * p.H * p.LP;
    float* gloc_u = tv.gloc + ln.unit * p.LP * 2;
    float* gattn_u = tv.gattn + ln.unit * p.H * p.LP;
    for (int c = 0; c < p.chunks; ++c) {
      const RowSlice<VEC, R> rs(p, c, ln.j, ok);
      typename V::T g[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        g[r] = rs.ok[r] ? V::load(p.grad_out + u * p.HD + rs.off[r])
                        : V::zero();
      for (int base = 0; base < p.LP; base += S) {
        const int lp = base + ln.s;
        const bool pok = ok && lp < p.LP;
        const Point pt(lvl, pok ? lp : 0, p.P);
        const Corners cr(pok ? loc_u[2 * lp] : 0.f,
                         pok ? loc_u[2 * lp + 1] : 0.f, pt.lh, pt.lw);
        const int64_t start = row0 + pt.start * p.HD;
        float t[4][R], a[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool use = pok && rs.ok[r];
          a[r] = use ? attn_u[rs.head[r] * p.LP + lp] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int64_t at =
                start + static_cast<int64_t>(cr.off[k]) * p.HD + rs.off[r];
            // the location and weight gradients need only <g, corner>
            t[k][r] = use && cr.in[k] ? V::dot(g[r], V::load(p.value + at))
                                      : 0.f;
            if (use && cr.in[k])
              V::red_scaled(p.grad_value + at, a[r] * cr.w[k], g[r]);
          }
        }
        float ga[R], gx = 0.f, gy = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float sx = 0.f, sy = 0.f;
          ga[r] = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wy = (k >> 1) ? cr.fy : 1.f - cr.fy;
            const float wx = (k & 1) ? cr.fx : 1.f - cr.fx;
            ga[r] += wy * wx * t[k][r];
            sx += ((k & 1) ? wy : -wy) * t[k][r];
            sy += ((k >> 1) ? wx : -wx) * t[k][r];
          }
          gx += a[r] * sx;
          gy += a[r] * sy;
        }
        // the location gradient: a sum over the group
        for (int o = 1; o < G; o <<= 1) {
          gx += __shfl_xor_sync(kFull, gx, o);
          gy += __shfl_xor_sync(kFull, gy, o);
        }
        if (pok && ln.j == 0) {
          float* d = gloc_u + 2 * lp;
          gx *= pt.lw;
          gy *= pt.lh;
          d[0] = c == 0 ? gx : d[0] + gx;
          d[1] = c == 0 ? gy : d[1] + gy;
        }
        // the weight gradient: a sum over each head's lanes
        if (p.head_aligned) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            for (int o = 1; o < DG; o <<= 1)
              ga[r] += __shfl_xor_sync(kFull, ga[r], o);
            if (pok && rs.ok[r] && (ln.j & (DG - 1)) == 0)
              gattn_u[rs.head[r] * p.LP + lp] = ga[r];
          }
        } else {
          // a head's lanes are consecutive for each r: a segmented
          // inclusive scan, each segment's last lane adds its sum
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int h = rs.head[r];
            for (int o = 1; o < G; o <<= 1) {
              const float v = __shfl_up_sync(kFull, ga[r], o);
              const int hv = __shfl_up_sync(kFull, h, o);
              if (ln.j >= o && hv == h) ga[r] += v;
            }
            const int hn = __shfl_down_sync(kFull, h, 1);
            if (pok && rs.ok[r] && (ln.j == G - 1 || hn != h))
              gattn_u[h * p.LP + lp] += ga[r];
            __syncwarp();
          }
        }
      }
    }
    stage.end(tv, tile);
  }
}

using Kernel = void (*)(Params);

constexpr int kRs[] = {1, 2, 3, 4, 6, 8};

Kernel pick(bool bwd, int vec, int r) {
#define MSDA_SHARED_INSTANCE(V_, R_)                                   \
  if (vec == V_ && r == R_)                                            \
    return bwd ? msda_shared_bwd_kernel<V_, R_>                        \
               : msda_shared_fwd_kernel<V_, R_>;
#define MSDA_SHARED_RS(V_)                                             \
  MSDA_SHARED_INSTANCE(V_, 1) MSDA_SHARED_INSTANCE(V_, 2)              \
  MSDA_SHARED_INSTANCE(V_, 3) MSDA_SHARED_INSTANCE(V_, 4)              \
  MSDA_SHARED_INSTANCE(V_, 6) MSDA_SHARED_INSTANCE(V_, 8)
  MSDA_SHARED_RS(4)
  MSDA_SHARED_RS(1)
#undef MSDA_SHARED_RS
#undef MSDA_SHARED_INSTANCE
  return nullptr;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int log2_ceil(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// The device's SM count, read once per device.
int multiprocessors(int* sms) {
  static int known[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!known[dev]) {
    err = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = known[dev];
  return 0;
}

// Resident blocks per SM of a kernel at a block size and dynamic shared
// memory, remembered: the occupancy calculator costs host time per call.
int occupancy(int* blocks, Kernel k, int threads, int smem) {
  struct Entry {
    Kernel k;
    int threads, smem, blocks;
  };
  static Entry cache[256];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].k == k && cache[i].threads == threads &&
        cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return 0;
    }
  // allow the most dynamic shared memory once per kernel; the calculator
  // reports 0 blocks above the kernel's limit
  bool seen = false;
  for (int i = 0; i < used && !seen; ++i) seen = cache[i].k == k;
  cudaError_t err = cudaSuccess;
  if (!seen)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (used < 256) cache[used++] = Entry{k, threads, smem, *blocks};
  return 0;
}

struct Plan {
  Params p;
  Kernel kernel;
  int vec, r, threads;
  size_t smem;
  unsigned blocks;
};

// The launch for a call. vec4_ok: the row pointers (value, out or grad_out
// and grad_value) are 16-byte aligned; bulk_ok: the tile pointers are.
int make_plan(Plan& pl, bool bwd, bool vec4_ok, bool bulk_ptrs_ok) {
  Params& p = pl.p;
  p.LP = p.Lv * p.P;
  p.HD = p.H * p.D;
  pl.vec = (p.D % 4 == 0 && vec4_ok) ? 4 : 1;
  p.F = p.HD / pl.vec;
  if (p.F <= kGroupMax) {
    p.g_log2 = log2_ceil(p.F);
    pl.r = 1;
    p.chunks = 1;
  } else {
    p.g_log2 = 3;
    p.chunks = (p.F + 8 * kGroupMax - 1) / (8 * kGroupMax);
    const int need = (p.F + kGroupMax * p.chunks - 1) / (kGroupMax * p.chunks);
    pl.r = 8;
    for (int r : kRs)
      if (r >= need) {
        pl.r = r;
        break;
      }
  }
  const int G = 1 << p.g_log2;
  const int DG = p.D / pl.vec;
  p.head_aligned = (DG & (DG - 1)) == 0 && DG <= G;
  // groups per unit: the fewest padded point slots; on a tie the backward
  // takes the most groups (smaller tiles), the forward the fewest whose
  // tile stays within kFwdWarpBytes a warp (fewer, longer walks)
  int best_cost = 1 << 30;
  for (int s = 0; s <= 5 - p.g_log2; ++s) {
    const int span = 1 << s;
    best_cost = min(best_cost, (p.LP + span - 1) / span * span);
  }
  p.s_log2 = -1;
  for (int s = 5 - p.g_log2; s >= 0; --s) {
    const int span = 1 << s;
    if ((p.LP + span - 1) / span * span != best_cost) continue;
    const int64_t warp_bytes = (32 >> (p.g_log2 + s)) *
                               (static_cast<int64_t>(p.LP) * (8 + 4 * p.H));
    if (p.s_log2 < 0 || (!bwd && warp_bytes <= kFwdWarpBytes)) p.s_log2 = s;
  }
  const bool bulk_ok = bulk_ptrs_ok && p.LP > 0 && p.LP % 2 == 0 &&
                       (p.H * p.LP) % 4 == 0;
  pl.kernel = pick(bwd, pl.vec, pl.r);
  if (!pl.kernel) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int err = multiprocessors(&sms);
  if (err) return err;
  // staging: the block size, buffer count and (backward) gradient tile
  // that keep the most threads resident (the larger block, staged
  // gradients, two buffers on a tie); the tile is read in place only where
  // no staging fits in shared memory
  const int units_per_warp = 32 >> (p.g_log2 + p.s_log2);
  const int head = kHeadBytes + level_bytes(p.Lv);
  int resident = 0, per_sm = 0;
  for (int in_place = 0; in_place < 2 && resident == 0; ++in_place)
    for (int threads = kMaxThreads; threads >= 32; threads /= 2) {
      const int T = threads / 32 * units_per_warp;
      const int64_t buf = pad16(T * p.LP * 8) + pad16(T * p.H * p.LP * 4);
      for (int staged = bwd && !in_place; staged >= 0; --staged)
        for (int bufs = in_place ? 0 : bulk_ok && bwd ? 2 : 1;
             bufs >= (in_place ? 0 : 1); --bufs) {
          const int64_t smem = head + buf * (bufs + staged);
          if (smem > kSmemMax) continue;
          int n = 0;
          err = occupancy(&n, pl.kernel, threads, static_cast<int>(smem));
          if (err) return err;
          if (n * threads > resident) {
            resident = n * threads, per_sm = n;
            pl.threads = threads, p.bufs = bufs, p.grads_staged = staged;
            pl.smem = static_cast<size_t>(smem);
            p.mode = in_place ? kDirect : bulk_ok ? kBulk : kCopy;
          }
        }
    }
  if (resident == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.T = pl.threads / 32 * units_per_warp;
  p.loc_bytes = pad16(p.T * p.LP * 8);
  p.attn_bytes = pad16(p.T * p.H * p.LP * 4);
  p.buf_bytes = p.loc_bytes + p.attn_bytes;
  p.grads_offset = head + p.bufs * p.buf_bytes;
  p.tiles = (p.units + p.T - 1) / p.T;
  // the backward's blocks are persistent; the forward takes one tile a
  // block
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  pl.blocks = static_cast<unsigned>(bwd && most < p.tiles ? most : p.tiles);
  return 0;
}

void set_shapes(Params& p, const float* value, const int* level_table,
                const float* loc, const float* attn, int64_t B, int L, int H,
                int D, int Q, int Lv, int P) {
  p = Params{};
  p.value = value;
  p.level_table = level_table;
  p.loc = loc;
  p.attn = attn;
  p.units = B * Q;
  p.L = L, p.H = H, p.D = D, p.Q = Q, p.Lv = Lv, p.P = P;
}

int plan_fwd(Plan& pl, const float* value, const int* level_table,
             const float* loc, const float* attn, float* out, int64_t B,
             int L, int H, int D, int Q, int Lv, int P) {
  set_shapes(pl.p, value, level_table, loc, attn, B, L, H, D, Q, Lv, P);
  pl.p.out = out;
  return make_plan(pl, false, aligned16(value) && aligned16(out),
                   aligned16(loc) && aligned16(attn));
}

int plan_bwd(Plan& pl, const float* value, const int* level_table,
             const float* loc, const float* attn, const float* grad_out,
             float* grad_value, float* grad_loc, float* grad_attn, int64_t B,
             int L, int H, int D, int Q, int Lv, int P) {
  set_shapes(pl.p, value, level_table, loc, attn, B, L, H, D, Q, Lv, P);
  pl.p.grad_out = grad_out;
  pl.p.grad_value = grad_value;
  pl.p.grad_loc = grad_loc;
  pl.p.grad_attn = grad_attn;
  return make_plan(pl, true,
                   aligned16(value) && aligned16(grad_out) &&
                       aligned16(grad_value),
                   aligned16(loc) && aligned16(attn) && aligned16(grad_loc) &&
                       aligned16(grad_attn));
}

int launch(const Plan& pl, void* stream) {
  if (pl.p.units > 0 && pl.p.H > 0 && pl.p.D > 0) {
    const Kernel k = pl.kernel;
    k<<<pl.blocks, pl.threads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
        pl.p);
  }
  return static_cast<int>(cudaGetLastError());
}

bool empty(int64_t B, int H, int D, int Q) {
  return B * Q <= 0 || H <= 0 || D <= 0;
}

}  // namespace

// value (B, L, H, D); loc (B, Q, Lv, P, 2); attn (B, Q, H, Lv, P);
// out (B, Q, H * D); level_table: device int32 (Lv, 3) rows of (h, w, start
// offset into L).
extern "C" int msda_shared_fwd(const float* value, const int* level_table,
                               const float* loc, const float* attn,
                               float* out, int64_t B, int L, int H, int D,
                               int Q, int Lv, int P, void* stream) {
  if (empty(B, H, D, Q)) return static_cast<int>(cudaGetLastError());
  Plan pl;
  const int err =
      plan_fwd(pl, value, level_table, loc, attn, out, B, L, H, D, Q, Lv, P);
  return err ? err : launch(pl, stream);
}

// grad_value must be zeroed by the caller (the kernel accumulates into it);
// grad_loc and grad_attn are written in full.
extern "C" int msda_shared_bwd(const float* value, const int* level_table,
                               const float* loc, const float* attn,
                               const float* grad_out, float* grad_value,
                               float* grad_loc, float* grad_attn, int64_t B,
                               int L, int H, int D, int Q, int Lv, int P,
                               void* stream) {
  if (empty(B, H, D, Q)) return static_cast<int>(cudaGetLastError());
  Plan pl;
  const int err = plan_bwd(pl, value, level_table, loc, attn, grad_out,
                           grad_value, grad_loc, grad_attn, B, L, H, D, Q,
                           Lv, P);
  return err ? err : launch(pl, stream);
}

// The instance a call takes, for logs and measurements: info[0..15] =
// VEC, G, R, S (groups per unit), chunks, T (units per tile), threads,
// mode (0 bulk copies, 1 plain staging, 2 in place), head-aligned weight
// sums, dynamic shared bytes, blocks, registers per thread, local (spill)
// bytes per thread, the kernel's static shared bytes, tile buffers,
// gradients through the tile. bwd: 0 forward (row pointer `rows` is out),
// 1 backward (rows is grad_out).
extern "C" int msda_shared_describe(int bwd, const float* value,
                                    const float* loc, const float* attn,
                                    const float* rows, const float* grad_value,
                                    const float* grad_loc,
                                    const float* grad_attn, int64_t B, int L,
                                    int H, int D, int Q, int Lv, int P,
                                    int* info) {
  Plan pl;
  int err = bwd ? plan_bwd(pl, value, nullptr, loc, attn, rows,
                           const_cast<float*>(grad_value),
                           const_cast<float*>(grad_loc),
                           const_cast<float*>(grad_attn), B, L, H, D, Q, Lv,
                           P)
                : plan_fwd(pl, value, nullptr, loc, attn,
                           const_cast<float*>(rows), B, L, H, D, Q, Lv, P);
  if (err) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, pl.kernel));
  if (err) return err;
  const int vals[] = {pl.vec, 1 << pl.p.g_log2, pl.r, 1 << pl.p.s_log2,
                      pl.p.chunks, pl.p.T, pl.threads, pl.p.mode,
                      pl.p.head_aligned,
                      static_cast<int>(pl.smem), static_cast<int>(pl.blocks),
                      attr.numRegs, static_cast<int>(attr.localSizeBytes),
                      static_cast<int>(attr.sharedSizeBytes), pl.p.bufs,
                      pl.p.grads_staged};
  for (int k = 0; k < 16; ++k) info[k] = vals[k];
  return 0;
}
