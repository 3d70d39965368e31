// The NeuS render of one ray, fused: sdf -> alpha -> weights -> composites,
// forward (neus_render_fwd) and backward (neus_render_bwd), plus the
// alpha-input entry of the same forward template (neus_weights_fwd) and its
// backward (neus_weights_bwd), which the density head's render runs.
//
// Replaces: selfocc_tpu/ops/render_pallas.py::_weights_kernel (the Pallas
// TPU kernel behind weights_from_alpha_pallas, render_pallas.py:33/54) and
// its closed-form custom_vjp (render_pallas.py:71-84), together with the
// elementwise chain the JAX head runs around it (models/heads.py:316-336,
// 360-362): neus.neus_alpha with cos_anneal_ratio = 1, the weights
//   w_i = a_i * exp(sum_{j<i} log(1 - a_j + 1e-7)),
// acc = sum w, depth = sum w * mid / |d|, ts = mid / |d|, deltas = delta / |d|
// and normal_vis = sum w * (g^ + 1) / 2 with g^ = g / max(|g|, 1e-6). On
// the TPU the exclusive log-sum is one (S, S) triangular MXU matmul per
// 256-ray block, and XLA fuses the chain around it when the Pallas kernel is
// off (selfocc_tpu/configs/base.py:115-119). Eager PyTorch fuses nothing, so
// the chain was 34 launches per eval render chunk, most streaming (R, S)
// fp32 tensors.
//
// What bounds it on the H100, counting bytes: memory. Per ray the forward
// reads sdf (S), the metric sdf gradient (3 S), the bin edges (S + 1), the
// unit direction and |d| (16 bytes), and writes acc, depth, normal_vis (20
// bytes) plus, when the caller wants them, weights, ts and deltas (S
// each). At the eval chunk (32768 x 256) that is 169 MB read: ~0.05 ms at
// 3.35 TB/s. Measured, the forward takes about three times that: per
// sample it runs IEEE divisions and full-precision expf / logf, and at
// ~100 registers two blocks fit on an SM, so it is likely bound by
// instruction issue. The backward reads the same inputs and the weights'
// cotangent and writes g_sdf and g_grad (4 S): it recomputes alpha and the
// transmittance in registers rather than reading saved weights (the
// render chunk is checkpointed in training, so nothing is saved across
// the step anyway).
//
// Design: one warp per ray, 8 rays per 256-thread block. Lane l owns the
// contiguous run of samples [l K, (l + 1) K), K = 8 at S = 256, and issues
// all of its loads before any arithmetic: two float4 of sdf, six of grad,
// K + 1 scalar edges (the edge row has stride S + 1, so its alignment varies
// by ray). So the warp has its whole ray (~6 KB) in flight at once; the
// earlier kernel walked 32-sample tiles with one 128-byte load in flight
// per warp and ran at a third of its bound. Each lane scans its own
// log-transmittance serially, one 5-step shuffle scan joins the 32 lane
// totals, and the per-lane partial composites are reduced with shuffles.
// The backward adds a reverse per-lane scan and one __shfl_down_sync scan
// for the suffix sums of the closed form (a linear recurrence: each lane's
// samples compose to one affine map, and the scan joins the maps). Rows
// that are not 16-byte aligned, an S that is no multiple of 32 K (then
// every lane: see load_run) and a strided sdf take scalar loads and
// stores, and the backward stores sample by sample; any ray count works.
//
// sdf layout: the training render's sdf is vals[..., 0] of the (R, S, 25)
// trilinear result, so the kernel takes an element stride (sdf_step) and a
// ray stride instead of a contiguous copy. A copy would read the same
// sectors (one per sample, 100 bytes apart) and add a launch and a 4 MB
// write; the geo-only eval render passes stride 1 and gets float4 loads.
//
// Forward samples per ray: any S, in tiles of 32 K samples with the
// log-transmittance and the composites carried across tiles (K <= 8). The
// fused backward keeps a whole ray in registers: S <= 256 (K <= 8; a K = 16
// instance spilled at 255 registers and came out wrong on the card). The
// alpha-input backward does too up to 256 samples. Above, it stages each
// row through shared memory (neus_weights_bwd_staged_kernel): one pass over
// a ray up to 512 samples (the importance render's 320 and its up-sample
// rounds' 271 to 303), tiles of 512 above (..._staged_tiles_kernel).
//
// The earlier neus_weights_bwd_tiled_kernel, which these replace, walked tiles
// of 256 in two passes with the register kernel's loads: at S = 320 and the
// rounds' S, no multiple of 256, every lane took 8 scalar loads 32 bytes
// from its neighbour's, so each warp-wide load used 4 bytes of each of its
// 32 sectors, and pass 2 loaded alpha and took its logs again. On an H100
// at 700 W it took 0.0135 ms (device) at 4096 x 320, 0.0125-0.0139 at the
// rounds' 4096 x 271 / 287 / 303 and 0.0864 at 32768 x 320, 31-44% of the
// byte bound (PERF.md section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-7f;       // log(1 - a + eps) of the weights
constexpr float kCdfEps = 1e-5f;    // neus_alpha's section estimate
constexpr float kNormEps = 1e-6f;   // normal_vis's clamp of |grad|
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

struct FwdArgs {
  const float* alpha;      // (R, S): the alpha-input entry only
  const float* sdf;        // sdf[r * sdf_ray_stride + i * sdf_step]
  int64_t sdf_ray_stride;
  int64_t sdf_step;
  const float* grad;       // (R, S, 3) metric sdf gradient
  const float* dir;        // (R, 3) unit direction
  const float* edges;      // (R, S + 1) bin edges
  const float* dnorm;      // (R,) |direction|
  const float* inv_s;      // 0-dim, on the device
  float* weights;          // (R, S), or null: not written
  float* acc;              // (R,)
  float* depth;            // (R,)
  float* normal_vis;       // (R, 3)
  float* ts;               // (R, S), or null (then deltas is null too)
  float* deltas;           // (R, S), or null
  int64_t num_rays;
  int num_samples;
  bool whole_runs;  // set by the launcher: S a multiple of 32 K
};

struct BwdArgs {
  const float* sdf;
  int64_t sdf_ray_stride;
  int64_t sdf_step;
  const float* grad;
  const float* dir;
  const float* edges;
  const float* dnorm;
  const float* inv_s;
  const float* g_weights;     // (R, S) cotangents, each may be null
  const float* g_acc;         // (R,)
  const float* g_depth;       // (R,)
  const float* g_normal_vis;  // (R, 3)
  float* g_sdf;               // (R, S)
  float* g_grad;              // (R, S, 3)
  float* g_inv_s;             // (R,) per-ray partial sums
  int64_t num_rays;
  int num_samples;
  bool whole_runs;  // set by the launcher: S a multiple of 32 K
};

// The vector paths below are taken when every lane's run is whole
// (``whole``: S a multiple of 32 K, decided on the host) and p is 16-byte
// aligned, never by testing n == N on the lane. With n = max(0, min(K, S -
// i0)), ptxas for sm_90a folded n == K into the predicate output of the
// VIMNMX.RELU that computes n, in the sense "S - i0 < K": lanes holding
// part of a run took the vector path and stored (or loaded) a whole run,
// into the next ray's row, while whole lanes took the scalar path. The
// PTX tested n == 8; the SASS of the backward showed the fold
// (tools/neus_store_variants.py rebuilds that version).

// N contiguous floats from p, of which the first n exist (zeros after).
template <int N>
__device__ __forceinline__ void load_run(const float* p, int n, bool whole,
                                         float (&v)[N]) {
  if (N % 4 == 0 && whole && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = j < n ? __ldg(p + j) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void load_strided(const float* p, int64_t step,
                                             int n, bool whole,
                                             float (&v)[N]) {
  if (step == 1) {
    load_run<N>(p, n, whole, v);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = j < n ? __ldg(p + j * step) : 0.f;
  }
}

// The first n of N floats to p. A lane past the ray's end (n = 0) stores
// nothing: its p is the next ray's row.
template <int N>
__device__ __forceinline__ void store_run(float* p, int n, bool whole,
                                          const float (&v)[N]) {
  if (n <= 0) return;
  if (N % 4 == 0 && whole && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) p[j] = v[j];
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Exclusive prefix over the lanes of the warp of each lane's x.
__device__ __forceinline__ float lane_prefix(float x, int lane,
                                             float* total) {
  float incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  *total = __shfl_sync(kFull, incl, 31);
  const float excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.f : excl;
}

// The lanes' affine maps v -> a + b v composed from the top lane down:
// returns, for each lane, the composition of the maps of the lanes above it
// applied to 0 (0 for lane 31).
__device__ __forceinline__ float lane_affine_suffix(float a, float b,
                                                    int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float a_up = __shfl_down_sync(kFull, a, off);
    const float b_up = __shfl_down_sync(kFull, b, off);
    if (lane + off < 32) {
      a += b * a_up;
      b *= b_up;
    }
  }
  const float above = __shfl_down_sync(kFull, a, 1);
  return lane == 31 ? 0.f : above;
}

// The NeuS section estimate of one sample (neus.neus_alpha, ratio 1):
// cosine with the ray, the two logistic CDFs and the unclamped alpha.
struct Section {
  float cos, est_prev, est_next, prev_cdf, next_cdf, raw;
};

__device__ __forceinline__ Section section(float sdf, float gx, float gy,
                                           float gz, const float (&d)[3],
                                           float delta, float inv_s) {
  Section s;
  s.cos = d[0] * gx + d[1] * gy + d[2] * gz;
  const float iter_cos = -fmaxf(-s.cos, 0.f);
  const float half = iter_cos * delta * 0.5f;
  s.est_next = sdf + half;
  s.est_prev = sdf - half;
  s.prev_cdf = sigmoid(s.est_prev * inv_s);
  s.next_cdf = sigmoid(s.est_next * inv_s);
  s.raw = (s.prev_cdf - s.next_cdf + kCdfEps) / (s.prev_cdf + kCdfEps);
  return s;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// The NeuS weights of one ray, and in the fused instance the composites.
// kFused = false: alpha (R, S) in, weights out (neus_weights_fwd).
template <int K, bool kFused>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    neus_render_fwd_kernel(const FwdArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (ray >= a.num_rays) return;  // uniform per warp: the shuffles stay full
  const int S = a.num_samples;
  float d[3] = {0.f, 0.f, 0.f};
  float dn = 1.f, inv_s = 0.f;
  if (kFused) {
    d[0] = __ldg(a.dir + ray * 3);
    d[1] = __ldg(a.dir + ray * 3 + 1);
    d[2] = __ldg(a.dir + ray * 3 + 2);
    dn = __ldg(a.dnorm + ray);
    inv_s = __ldg(a.inv_s);
  }
  float carry = 0.f;  // log-transmittance of every sample before this tile
  float acc = 0.f, dep = 0.f, nv[3] = {0.f, 0.f, 0.f};
  for (int base = 0; base < S; base += 32 * K) {
    const int i0 = base + lane * K;
    const int n = max(0, min(K, S - i0));
    float alpha[K], la[K], mid[K], delta[K], g[3 * K];
    if constexpr (kFused) {
      float sdf[K], e[K + 1];
      load_strided<K>(a.sdf + ray * a.sdf_ray_stride + i0 * a.sdf_step,
                      a.sdf_step, n, a.whole_runs, sdf);
      load_run<3 * K>(a.grad + (ray * S + i0) * 3, 3 * n, a.whole_runs, g);
      load_run<K + 1>(a.edges + ray * (S + 1) + i0, n > 0 ? n + 1 : 0,
                      false, e);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        mid[j] = (e[j] + e[j + 1]) * 0.5f;
        delta[j] = e[j + 1] - e[j];
        const Section s = section(sdf[j], g[3 * j], g[3 * j + 1],
                                  g[3 * j + 2], d, delta[j], inv_s);
        alpha[j] = j < n ? clamp01(s.raw) : 0.f;
      }
    } else {
      load_run<K>(a.alpha + ray * S + i0, n, a.whole_runs, alpha);
    }
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      la[j] = j < n ? logf(1.f - alpha[j] + kEps) : 0.f;
      run += la[j];
    }
    float tile_total;
    float prefix = carry + lane_prefix(run, lane, &tile_total);
    carry += tile_total;
    float w[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = alpha[j] * expf(prefix);
      prefix += la[j];
    }
    if (a.weights != nullptr)
      store_run<K>(a.weights + ray * S + i0, n, a.whole_runs, w);
    if (kFused) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        acc += w[j];
        dep += w[j] * mid[j];
        const float gx = g[3 * j], gy = g[3 * j + 1], gz = g[3 * j + 2];
        const float nrm = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), kNormEps);
        nv[0] += w[j] * ((gx / nrm + 1.f) * 0.5f);
        nv[1] += w[j] * ((gy / nrm + 1.f) * 0.5f);
        nv[2] += w[j] * ((gz / nrm + 1.f) * 0.5f);
      }
      if (a.ts != nullptr) {
        float ts[K], dl[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          ts[j] = mid[j] / dn;
          dl[j] = delta[j] / dn;
        }
        store_run<K>(a.ts + ray * S + i0, n, a.whole_runs, ts);
        store_run<K>(a.deltas + ray * S + i0, n, a.whole_runs, dl);
      }
    }
  }
  if (kFused) {
    acc = warp_sum(acc);
    dep = warp_sum(dep);
    nv[0] = warp_sum(nv[0]);
    nv[1] = warp_sum(nv[1]);
    nv[2] = warp_sum(nv[2]);
    if (lane == 0) {
      a.acc[ray] = acc;
      a.depth[ray] = dep / dn;
      a.normal_vis[ray * 3] = nv[0];
      a.normal_vis[ray * 3 + 1] = nv[1];
      a.normal_vis[ray * 3 + 2] = nv[2];
    }
  }
}

// Cotangents of sdf, grad and inv_s (per-ray partials) from those of
// weights, acc, depth and normal_vis. With G_i = gw_i + g_acc
// + g_depth mid_i / |d| + g_nv . (g^_i + 1) / 2, the closed form of
// render_pallas.py:76-84 gives
//   g_alpha_k = G_k T_k - (sum_{i>k} G_i w_i) / (1 - alpha_k + 1e-7),
// taken here as T_k D_k (see D below); then the chain goes back
// through torch's clamp rule (the gradient passes where 0 <= raw alpha
// <= 1), the two sigmoids and relu(-cos).
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    neus_render_bwd_kernel(const BwdArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (ray >= a.num_rays) return;
  const int S = a.num_samples;
  const int i0 = lane * K;
  const int n = max(0, min(K, S - i0));
  float sdf[K], g[3 * K], e[K + 1], gw[K];
  load_strided<K>(a.sdf + ray * a.sdf_ray_stride + i0 * a.sdf_step,
                  a.sdf_step, n, a.whole_runs, sdf);
  load_run<3 * K>(a.grad + (ray * S + i0) * 3, 3 * n, a.whole_runs, g);
  load_run<K + 1>(a.edges + ray * (S + 1) + i0, n > 0 ? n + 1 : 0, false,
                  e);
  if (a.g_weights != nullptr) {
    load_run<K>(a.g_weights + ray * S + i0, n, a.whole_runs, gw);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) gw[j] = 0.f;
  }
  const float d[3] = {__ldg(a.dir + ray * 3), __ldg(a.dir + ray * 3 + 1),
                      __ldg(a.dir + ray * 3 + 2)};
  const float dn = __ldg(a.dnorm + ray);
  const float inv_s = __ldg(a.inv_s);
  const float g_acc = a.g_acc != nullptr ? __ldg(a.g_acc + ray) : 0.f;
  const float g_dep = a.g_depth != nullptr ? __ldg(a.g_depth + ray) / dn : 0.f;
  float g_nv[3] = {0.f, 0.f, 0.f};
  if (a.g_normal_vis != nullptr) {
    g_nv[0] = __ldg(a.g_normal_vis + ray * 3);
    g_nv[1] = __ldg(a.g_normal_vis + ray * 3 + 1);
    g_nv[2] = __ldg(a.g_normal_vis + ray * 3 + 2);
  }

  // forward again: alpha, the transmittance, w and G
  float alpha[K], la[K], trans[K], G[K];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const Section s = section(sdf[j], g[3 * j], g[3 * j + 1], g[3 * j + 2],
                              d, e[j + 1] - e[j], inv_s);
    alpha[j] = j < n ? clamp01(s.raw) : 0.f;
    la[j] = j < n ? logf(1.f - alpha[j] + kEps) : 0.f;
    run += la[j];
  }
  float unused_total;
  float prefix = lane_prefix(run, lane, &unused_total);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    trans[j] = expf(prefix);
    prefix += la[j];
    const float gx = g[3 * j], gy = g[3 * j + 1], gz = g[3 * j + 2];
    const float nrm = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), kNormEps);
    const float mid = (e[j] + e[j + 1]) * 0.5f;
    G[j] = gw[j] + g_acc + g_dep * mid +
           g_nv[0] * ((gx / nrm + 1.f) * 0.5f) +
           g_nv[1] * ((gy / nrm + 1.f) * 0.5f) +
           g_nv[2] * ((gz / nrm + 1.f) * 0.5f);
  }
  // g_alpha_k = T_k D_k with D_k = G_k - sum_{i>k} G_i alpha_i
  // prod_{k<j<i} b_j, b_j = 1 - alpha_j + eps, which obeys
  //   D_k = c_k + b_{k+1} D_{k+1},
  //   c_k = (G_k - G_{k+1}) - G_{k+1} ((alpha_{k+1} + b_{k+1}) - 1),
  // D = G at the last sample. This takes neither the division by
  // 1 - alpha_k + eps (down to 1e-7 where alpha saturates, scaling the
  // suffix sum's rounding by 1e7) nor the difference of G and the suffix
  // sum, which cancels to the remaining transmittance on an opaque ray;
  // (alpha + b) - 1 ~ eps is exact in double. Each lane's samples compose
  // to one affine map of the D its lanes above hand down, and the maps are
  // joined with shuffles.
  float b[K], b_err[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    b[j] = 1.f - alpha[j] + kEps;
    b_err[j] = static_cast<float>(static_cast<double>(alpha[j]) +
                                  static_cast<double>(b[j]) - 1.0);
  }
  const float G_up = __shfl_down_sync(kFull, G[0], 1);
  const float b_up = __shfl_down_sync(kFull, b[0], 1);
  const float b_err_up = __shfl_down_sync(kFull, b_err[0], 1);
  float c[K], beta[K];
  float lane_a = 0.f, lane_b = 1.f;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const int i = i0 + j;
    const int jn = j + 1 < K ? j + 1 : j;  // the next sample, in this lane
    const float G_next = j + 1 < K ? G[jn] : G_up;
    const float b_next = j + 1 < K ? b[jn] : b_up;
    const float e_next = j + 1 < K ? b_err[jn] : b_err_up;
    if (i < S - 1) {
      c[j] = (G[j] - G_next) - G_next * e_next;
      beta[j] = b_next;
    } else if (i == S - 1) {
      c[j] = G[j];
      beta[j] = 0.f;
    } else {  // past the ray's end: the identity
      c[j] = 0.f;
      beta[j] = 1.f;
    }
    lane_a = c[j] + beta[j] * lane_a;
    lane_b *= beta[j];
  }

  // backward, last sample first: D, g_alpha, then the chain
  float dk = lane_affine_suffix(lane_a, lane_b, lane);
  // g_sdf and g_grad are stored sample by sample as they are computed,
  // each store under j < n: no vector path, so no whole-run test for
  // ptxas to fold (see load_run)
  float* g_sdf_row = a.g_sdf + ray * S + i0;
  float* g_grad_row = a.g_grad + (ray * S + i0) * 3;
  float g_inv_s = 0.f;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    dk = c[j] + beta[j] * dk;
    const float w = alpha[j] * trans[j];
    const float g_alpha = trans[j] * dk;
    const float delta = e[j + 1] - e[j];
    const float gx = g[3 * j], gy = g[3 * j + 1], gz = g[3 * j + 2];
    const Section s = section(sdf[j], gx, gy, gz, d, delta, inv_s);
    const float g_raw =
        (j < n && s.raw >= 0.f && s.raw <= 1.f) ? g_alpha : 0.f;
    // raw = num / q, num = prev - next + eps, q = prev + eps
    const float q = s.prev_cdf + kCdfEps;
    const float g_num = g_raw / q;
    const float g_q = -g_raw * (s.prev_cdf - s.next_cdf + kCdfEps) / (q * q);
    const float g_prev = (g_num + g_q) * s.prev_cdf * (1.f - s.prev_cdf);
    const float g_next = -g_num * s.next_cdf * (1.f - s.next_cdf);
    g_inv_s += g_prev * s.est_prev + g_next * s.est_next;
    const float g_est_prev = g_prev * inv_s, g_est_next = g_next * inv_s;
    if (j < n) g_sdf_row[j] = g_est_prev + g_est_next;
    // est = sdf -+ iter_cos * delta / 2, iter_cos = -relu(-cos)
    const float g_iter_cos = (g_est_next - g_est_prev) * delta * 0.5f;
    const float g_cos = s.cos < 0.f ? g_iter_cos : 0.f;
    float gg[3] = {g_cos * d[0], g_cos * d[1], g_cos * d[2]};
    if (a.g_normal_vis != nullptr) {
      // normal_vis = sum w (g / max(|g|, 1e-6) + 1) / 2
      const float nrm = sqrtf(gx * gx + gy * gy + gz * gz);
      const float half_w = w * 0.5f;
      if (nrm >= kNormEps) {
        const float hx = gx / nrm, hy = gy / nrm, hz = gz / nrm;
        const float dot = hx * g_nv[0] + hy * g_nv[1] + hz * g_nv[2];
        gg[0] += half_w * (g_nv[0] - hx * dot) / nrm;
        gg[1] += half_w * (g_nv[1] - hy * dot) / nrm;
        gg[2] += half_w * (g_nv[2] - hz * dot) / nrm;
      } else {
        gg[0] += half_w * g_nv[0] / kNormEps;
        gg[1] += half_w * g_nv[1] / kNormEps;
        gg[2] += half_w * g_nv[2] / kNormEps;
      }
    }
    if (j < n) {
      g_grad_row[3 * j] = gg[0];
      g_grad_row[3 * j + 1] = gg[1];
      g_grad_row[3 * j + 2] = gg[2];
    }
  }
  g_inv_s = warp_sum(g_inv_s);
  if (lane == 0) a.g_inv_s[ray] = g_inv_s;
}

// The cotangent of alpha for the cotangent g of the weights of
// neus_weights_fwd (the closed form of render_pallas.py:76-84):
//   g_alpha_k = g_k T_k - (sum_{i>k} g_i w_i) / (1 - alpha_k + 1e-7),
// taken as T_k D_k with the recurrence of neus_render_bwd_kernel (D_k =
// c_k + b_{k+1} D_{k+1}, c_k = (g_k - g_{k+1}) - g_{k+1} ((alpha_{k+1} +
// b_{k+1}) - 1), D = g at the last sample), so that neither the division
// by 1 - alpha_k + eps nor the cancelling difference is taken where alpha
// saturates. One warp per ray, lane l owning samples [l K, (l + 1) K): it
// loads its alpha and g runs, scans the log-transmittance forward (one
// shuffle scan over the lanes), composes its samples' affine maps of D
// backward, joins the lanes' maps with shuffles, and writes its run of
// g_alpha. Per ray it reads 8 S bytes and writes 4 S: bound by memory.
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    neus_weights_bwd_kernel(const float* __restrict__ alpha_in,
                            const float* __restrict__ g_in,
                            float* __restrict__ g_alpha, int64_t num_rays,
                            int num_samples, bool whole_runs) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (ray >= num_rays) return;  // uniform per warp
  const int S = num_samples;
  const int i0 = lane * K;
  const int n = max(0, min(K, S - i0));
  float alpha[K], g[K];
  load_run<K>(alpha_in + ray * S + i0, n, whole_runs, alpha);
  load_run<K>(g_in + ray * S + i0, n, whole_runs, g);
  float la[K], run = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    la[j] = j < n ? logf(1.f - alpha[j] + kEps) : 0.f;
    run += la[j];
  }
  float unused_total;
  float prefix = lane_prefix(run, lane, &unused_total);
  float trans[K], b[K], b_err[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    trans[j] = expf(prefix);
    prefix += la[j];
    b[j] = 1.f - alpha[j] + kEps;
    b_err[j] = static_cast<float>(static_cast<double>(alpha[j]) +
                                  static_cast<double>(b[j]) - 1.0);
  }
  const float g_up = __shfl_down_sync(kFull, g[0], 1);
  const float b_up = __shfl_down_sync(kFull, b[0], 1);
  const float b_err_up = __shfl_down_sync(kFull, b_err[0], 1);
  float c[K], beta[K];
  float lane_a = 0.f, lane_b = 1.f;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const int i = i0 + j;
    const int jn = j + 1 < K ? j + 1 : j;
    const float g_next = j + 1 < K ? g[jn] : g_up;
    const float b_next = j + 1 < K ? b[jn] : b_up;
    const float e_next = j + 1 < K ? b_err[jn] : b_err_up;
    if (i < S - 1) {
      c[j] = (g[j] - g_next) - g_next * e_next;
      beta[j] = b_next;
    } else if (i == S - 1) {
      c[j] = g[j];
      beta[j] = 0.f;
    } else {  // past the ray's end: the identity
      c[j] = 0.f;
      beta[j] = 1.f;
    }
    lane_a = c[j] + beta[j] * lane_a;
    lane_b *= beta[j];
  }
  float dk = lane_affine_suffix(lane_a, lane_b, lane);
  float out[K];
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    dk = c[j] + beta[j] * dk;
    out[j] = trans[j] * dk;
  }
  store_run<K>(g_alpha + ray * S + i0, n, whole_runs, out);
}

// neus_weights_bwd above 256 samples: rows staged through shared memory.
//
// What bounds it: bytes, 12 S a ray (alpha and g read, g_alpha written;
// 15.7 MB at 4096 x 320, 4.7 us at 3.35 TB/s). The register kernel's run
// layout (lane l owns samples [l K, (l + 1) K)) keeps the scans to one
// shuffle scan and one affine scan a ray, but loading it straight from
// device memory spreads a warp-wide load over 32 sectors at K > 8 (no
// float4 when S is no multiple of 32 K). So a warp loads its ray's alpha
// and g rows coalesced (consecutive lanes on consecutive words, float4 when
// the launcher found every row 16-byte aligned: S % 4 == 0 and aligned
// bases), writes them to its own part of shared memory in the run layout,
// and each lane reads its run from there. A run's stride in shared memory
// is K | 1, odd, so the 32 lanes' j-th samples fall in 32 banks. g_alpha
// goes back the same way: each lane writes its run over its own alpha
// run, and the warp stores the row coalesced.
//
// Up to 512 samples (K <= 16) a ray is one pass (neus_weights_bwd_staged_
// kernel, one instance per K of 9, 10, 12 and 16). Its blocks are as many
// as fit the card at once (the occupancy calculator), and each warp walks
// rays a grid apart: it issues the next ray's loads into registers before
// it scans this one, so the loads of a warp's next ray are in flight while
// it computes. Above 512 (neus_weights_bwd_staged_tiles_kernel, one warp a
// ray) it walks tiles of 512 twice, staged the same way: first the tiles'
// log-transmittance totals forward (lane t keeps the log-T before tile t),
// then the tiles from the last to the first with four carries from the tile
// after: D at its first sample (the input of the top lane's maps) and that
// sample's g, b and (a + b) - 1 (the top lane's "next sample").
//
// Measured on an H100 80GB HBM3 at 700 W (tools/neus_bwd_variants.py,
// device ms at 4096 x 320 / the rounds' 4096 x 271, 287, 303 / 32768 x
// 320): this design 0.0072 / 0.0068-0.0080 / 0.0462-0.0473 (bound 0.0047
// / 0.0040-0.0044 / 0.0376). Dropped: one K = 16 instance for every S,
// its lanes' tails masked, 0.0101-0.0110 / 0.0122-0.0124 / 0.0757-0.0780;
// a block every 8 rays, no loads ahead, 0.0078-0.0080 / 0.0070-0.0085 /
// 0.0603-0.0609; __launch_bounds__ asking for 3 blocks an SM (80
// registers, 24-208 bytes of stack) 0.0106 / 0.0076-0.0107 / 0.0604-
// 0.0609. ptxas -v: 86 (K = 9) to 128 registers, no spills, 18-35 KB of
// shared memory a block: 2 blocks an SM.
constexpr int kStagedMaxRun = 16;               // one pass up to 32 x 16
constexpr int kWeightsBwdMaxSamples = 8192;     // 16 tiles of 512

// Where sample i of a tile sits in shared memory: run i / K at stride K | 1.
template <int K>
__device__ __forceinline__ int staged_pos(int i) {
  return (i / K) * (K | 1) + i % K;
}

// Floats a lane holds of a coalesced tile of 32 K samples: K words, or
// ceil(K / 4) float4s.
template <int K>
constexpr int kStagedSlots = 4 * ((K + 3) / 4);

// The first n (<= 32 K) floats of row, coalesced, into the lane's slots:
// word q * 32 + lane, or float4 q * 32 + lane when vec4.
template <int K>
__device__ __forceinline__ void fetch_tile(const float* __restrict__ row,
                                           int n, bool vec4, int lane,
                                           float (&r)[kStagedSlots<K>]) {
  if (vec4) {
#pragma unroll
    for (int q = 0; q < (K + 3) / 4; ++q) {
      const int i = 4 * (q * 32 + lane);
      const float4 x =
          i < n ? __ldg(reinterpret_cast<const float4*>(row + i))
                : make_float4(0.f, 0.f, 0.f, 0.f);
      r[4 * q] = x.x;
      r[4 * q + 1] = x.y;
      r[4 * q + 2] = x.z;
      r[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      r[q] = i < n ? __ldg(row + i) : 0.f;
    }
  }
}

// fetch_tile's slots to their places in the run layout of s.
template <int K>
__device__ __forceinline__ void put_tile(float* s, int n, bool vec4,
                                         int lane,
                                         const float (&r)[kStagedSlots<K>]) {
  if (vec4) {
#pragma unroll
    for (int q = 0; q < (K + 3) / 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (q * 32 + lane) + e;
        if (i < n) s[staged_pos<K>(i)] = r[4 * q + e];
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      if (i < n) s[staged_pos<K>(i)] = r[q];
    }
  }
}

// The first n floats of the run layout of s to row, coalesced.
template <int K>
__device__ __forceinline__ void store_tile(float* __restrict__ row,
                                           const float* s, int n, bool vec4,
                                           int lane) {
  if (vec4) {
#pragma unroll
    for (int q = 0; q < (K + 3) / 4; ++q) {
      const int i = 4 * (q * 32 + lane);
      if (i < n)
        *reinterpret_cast<float4*>(row + i) = make_float4(
            s[staged_pos<K>(i)], s[staged_pos<K>(i + 1)],
            s[staged_pos<K>(i + 2)], s[staged_pos<K>(i + 3)]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int i = q * 32 + lane;
      if (i < n) row[i] = s[staged_pos<K>(i)];
    }
  }
}

// A lane's run of a staged tile: samples lane K + j, 0 past n.
template <int K>
__device__ __forceinline__ void read_run(const float* s, int n, int lane,
                                         float (&v)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    v[j] = lane * K + j < n ? s[lane * (K | 1) + j] : 0.f;
}

// D's carry from the tile after: D at its first sample, and that sample's
// g, b and (a + b) - 1. The last tile's: D = 0 and the identity's b.
struct WeightsCarry {
  float d = 0.f, g = 0.f, b = 1.f, e = 0.f;
};

// g_alpha of one tile of 32 K samples, lane l holding alpha and g of
// samples [l K, (l + 1) K) of it: the closed form of neus_weights_bwd_kernel
// with the log-transmittance before the tile (log_t0) and the carry from
// the tile after it (c, replaced by this tile's). S counts the samples from
// the tile's first to the ray's last.
template <int K>
__device__ __forceinline__ void weights_bwd_tile(const float (&alpha)[K],
                                                 const float (&g)[K],
                                                 int lane, int S,
                                                 float log_t0,
                                                 WeightsCarry& carry,
                                                 float (&out)[K]) {
  const int i0 = lane * K;
  float la[K], run = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    la[j] = i0 + j < S ? logf(1.f - alpha[j] + kEps) : 0.f;
    run += la[j];
  }
  float unused_total;
  float prefix = log_t0 + lane_prefix(run, lane, &unused_total);
  float trans[K], b[K], b_err[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    trans[j] = expf(prefix);
    prefix += la[j];
    b[j] = 1.f - alpha[j] + kEps;
    b_err[j] = static_cast<float>(static_cast<double>(alpha[j]) +
                                  static_cast<double>(b[j]) - 1.0);
  }
  float g_up = __shfl_down_sync(kFull, g[0], 1);
  float b_up = __shfl_down_sync(kFull, b[0], 1);
  float b_err_up = __shfl_down_sync(kFull, b_err[0], 1);
  if (lane == 31) {
    g_up = carry.g;
    b_up = carry.b;
    b_err_up = carry.e;
  }
  float c[K], beta[K];
  float lane_a = 0.f, lane_b = 1.f;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const int i = i0 + j;
    const int jn = j + 1 < K ? j + 1 : j;
    const float g_next = j + 1 < K ? g[jn] : g_up;
    const float b_next = j + 1 < K ? b[jn] : b_up;
    const float e_next = j + 1 < K ? b_err[jn] : b_err_up;
    if (i < S - 1) {
      c[j] = (g[j] - g_next) - g_next * e_next;
      beta[j] = b_next;
    } else if (i == S - 1) {
      c[j] = g[j];
      beta[j] = 0.f;
    } else {  // past the ray's end: the identity
      c[j] = 0.f;
      beta[j] = 1.f;
    }
    lane_a = c[j] + beta[j] * lane_a;
    lane_b *= beta[j];
  }
  // the top lane's maps take D of the tile after as their input
  float dk = lane_affine_suffix(
      lane == 31 ? lane_a + lane_b * carry.d : lane_a, lane_b, lane);
  if (lane == 31) dk = carry.d;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    dk = c[j] + beta[j] * dk;
    out[j] = trans[j] * dk;
  }
  carry.d = __shfl_sync(kFull, dk, 0);
  carry.g = __shfl_sync(kFull, g[0], 0);
  carry.b = __shfl_sync(kFull, b[0], 0);
  carry.e = __shfl_sync(kFull, b_err[0], 0);
}

template <int K>
struct WeightsStage {
  float alpha[kWarpsPerBlock][32 * (K | 1)];  // g_alpha on the way out
  float g[kWarpsPerBlock][32 * (K | 1)];
};

// 32 (K - 1) < S <= 32 K: one pass over each ray, rays a grid apart.
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    neus_weights_bwd_staged_kernel(const float* __restrict__ alpha_in,
                                   const float* __restrict__ g_in,
                                   float* __restrict__ g_alpha,
                                   int64_t num_rays, int num_samples,
                                   bool vec4) {
  __shared__ WeightsStage<K> stage;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* sa = stage.alpha[warp];
  float* sg = stage.g[warp];
  const int S = num_samples;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  float ra[kStagedSlots<K>], rg[kStagedSlots<K>];
  if (ray < num_rays) {
    fetch_tile<K>(alpha_in + ray * S, S, vec4, lane, ra);
    fetch_tile<K>(g_in + ray * S, S, vec4, lane, rg);
  }
  for (; ray < num_rays; ray += step) {  // uniform per warp
    __syncwarp();  // the last ray's row is out of shared memory
    put_tile<K>(sa, S, vec4, lane, ra);
    put_tile<K>(sg, S, vec4, lane, rg);
    __syncwarp();
    if (ray + step < num_rays) {  // the next ray's loads, in flight
      fetch_tile<K>(alpha_in + (ray + step) * S, S, vec4, lane, ra);
      fetch_tile<K>(g_in + (ray + step) * S, S, vec4, lane, rg);
    }
    float alpha[K], g[K], out[K];
    read_run<K>(sa, S, lane, alpha);
    read_run<K>(sg, S, lane, g);
    WeightsCarry carry;
    weights_bwd_tile<K>(alpha, g, lane, S, 0.f, carry, out);
#pragma unroll
    for (int j = 0; j < K; ++j) sa[lane * (K | 1) + j] = out[j];
    __syncwarp();
    store_tile<K>(g_alpha + ray * S, sa, S, vec4, lane);
  }
}

// S > 512: one warp a ray, tiles of 512 in two passes (see above).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    neus_weights_bwd_staged_tiles_kernel(const float* __restrict__ alpha_in,
                                         const float* __restrict__ g_in,
                                         float* __restrict__ g_alpha,
                                         int64_t num_rays, int num_samples,
                                         bool vec4) {
  constexpr int K = kStagedMaxRun, kTile = 32 * K;
  __shared__ WeightsStage<K> stage;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      warp;
  if (ray >= num_rays) return;  // uniform per warp
  float* sa = stage.alpha[warp];
  float* sg = stage.g[warp];
  const int S = num_samples;
  const int tiles = (S + kTile - 1) / kTile;
  const float* a_row = alpha_in + ray * S;
  const float* g_row = g_in + ray * S;
  float r[kStagedSlots<K>], alpha[K], g[K], out[K];
  float start = 0.f, total_before = 0.f;  // lane t: the log-T before tile t
  for (int t = 0; t < tiles; ++t) {
    const int left = S - t * kTile;  // samples from the tile's first on
    fetch_tile<K>(a_row + t * kTile, left, vec4, lane, r);
    __syncwarp();
    put_tile<K>(sa, left, vec4, lane, r);
    __syncwarp();
    read_run<K>(sa, left, lane, alpha);
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      run += lane * K + j < left ? logf(1.f - alpha[j] + kEps) : 0.f;
    float total;
    lane_prefix(run, lane, &total);
    if (lane == t) start = total_before;
    total_before += total;
  }
  WeightsCarry carry;
  for (int t = tiles - 1; t >= 0; --t) {
    const int left = S - t * kTile;
    __syncwarp();
    fetch_tile<K>(a_row + t * kTile, left, vec4, lane, r);
    put_tile<K>(sa, left, vec4, lane, r);
    fetch_tile<K>(g_row + t * kTile, left, vec4, lane, r);
    put_tile<K>(sg, left, vec4, lane, r);
    __syncwarp();
    read_run<K>(sa, left, lane, alpha);
    read_run<K>(sg, left, lane, g);
    weights_bwd_tile<K>(alpha, g, lane, left, __shfl_sync(kFull, start, t),
                        carry, out);
#pragma unroll
    for (int j = 0; j < K; ++j) sa[lane * (K | 1) + j] = out[j];
    __syncwarp();
    store_tile<K>(g_alpha + ray * S + t * kTile, sa, left, vec4, lane);
  }
}

// Streaming multiprocessors of the current device, remembered.
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

// One pass at run length K: as many blocks as the card holds at once (the
// occupancy calculator's count, remembered), at most one warp a ray.
template <int K>
int launch_staged(const float* alpha, const float* g, float* g_alpha,
                  int64_t num_rays, int num_samples, bool vec4,
                  cudaStream_t s) {
  static int per_sm = 0;
  int sms = 0;
  int err = multiprocessors(&sms);
  if (err != 0) return err;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, neus_weights_bwd_staged_kernel<K>, kWarpsPerBlock * 32, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t want = (num_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t fit = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const dim3 grid(static_cast<unsigned>(want < fit ? want : fit));
  neus_weights_bwd_staged_kernel<K><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      alpha, g, g_alpha, num_rays, num_samples, vec4);
  return 0;
}

// The run length K of a lane: the least power of two with 32 K >= S, at
// most k_max (the forward then walks several tiles).
int run_length(int num_samples, int k_max) {
  int k = 1;
  while (k < k_max && 32 * k < num_samples) k *= 2;
  return k;
}

unsigned num_blocks(int64_t num_rays) {
  return static_cast<unsigned>((num_rays + kWarpsPerBlock - 1) /
                               kWarpsPerBlock);
}

template <bool kFused>
void launch_fwd(FwdArgs a, cudaStream_t stream) {
  const dim3 grid(num_blocks(a.num_rays)), block(kWarpsPerBlock * 32);
  const int k = run_length(a.num_samples, 8);
  a.whole_runs = a.num_samples % (32 * k) == 0;
  switch (k) {
    case 1: neus_render_fwd_kernel<1, kFused><<<grid, block, 0, stream>>>(a);
      break;
    case 2: neus_render_fwd_kernel<2, kFused><<<grid, block, 0, stream>>>(a);
      break;
    case 4: neus_render_fwd_kernel<4, kFused><<<grid, block, 0, stream>>>(a);
      break;
    default:
      neus_render_fwd_kernel<8, kFused><<<grid, block, 0, stream>>>(a);
  }
}

// The run length of a one-pass staged instance: the least of 9, 10, 12
// and 16 with 32 K >= S (256 < S <= 512; the on-path S of 271 to 320 take
// 9 and 10).
int staged_run(int num_samples) {
  const int k = (num_samples + 31) / 32;
  return k <= 10 ? k : (k <= 12 ? 12 : 16);
}

}  // namespace

extern "C" int neus_weights_fwd(const float* alpha, float* weights,
                                int64_t num_rays, int num_samples,
                                void* stream) {
  if (num_rays > 0 && num_samples > 0) {
    FwdArgs a = {};
    a.alpha = alpha;
    a.weights = weights;
    a.num_rays = num_rays;
    a.num_samples = num_samples;
    launch_fwd<false>(a, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int neus_render_fwd(
    const float* sdf, int64_t sdf_ray_stride, int64_t sdf_step,
    const float* grad, const float* dir, const float* edges,
    const float* dnorm, const float* inv_s, float* weights, float* acc,
    float* depth, float* normal_vis, float* ts, float* deltas,
    int64_t num_rays, int num_samples, void* stream) {
  if (num_rays > 0 && num_samples > 0) {
    const FwdArgs a = {nullptr, sdf, sdf_ray_stride, sdf_step, grad, dir,
                       edges, dnorm, inv_s, weights, acc, depth, normal_vis,
                       ts, deltas, num_rays, num_samples};
    launch_fwd<true>(a, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int neus_render_bwd(
    const float* sdf, int64_t sdf_ray_stride, int64_t sdf_step,
    const float* grad, const float* dir, const float* edges,
    const float* dnorm, const float* inv_s, const float* g_weights,
    const float* g_acc, const float* g_depth, const float* g_normal_vis,
    float* g_sdf, float* g_grad, float* g_inv_s, int64_t num_rays,
    int num_samples, void* stream) {
  if (num_samples > 32 * 8) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays > 0 && num_samples > 0) {
    const int k = run_length(num_samples, 8);
    const BwdArgs a = {sdf, sdf_ray_stride, sdf_step, grad, dir, edges,
                       dnorm, inv_s, g_weights, g_acc, g_depth,
                       g_normal_vis, g_sdf, g_grad, g_inv_s, num_rays,
                       num_samples, num_samples % (32 * k) == 0};
    const dim3 grid(num_blocks(num_rays)), block(kWarpsPerBlock * 32);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
      case 1: neus_render_bwd_kernel<1><<<grid, block, 0, s>>>(a); break;
      case 2: neus_render_bwd_kernel<2><<<grid, block, 0, s>>>(a); break;
      case 4: neus_render_bwd_kernel<4><<<grid, block, 0, s>>>(a); break;
      default: neus_render_bwd_kernel<8><<<grid, block, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// S <= 256: neus_weights_bwd_kernel, a ray in registers; 256 < S <= 512:
// neus_weights_bwd_staged_kernel, one pass; 512 < S <= 8192: its tiles.
// Rows take float4 loads and stores when every row is 16-byte aligned.
extern "C" int neus_weights_bwd(const float* alpha, const float* g_weights,
                                float* g_alpha, int64_t num_rays,
                                int num_samples, void* stream) {
  if (num_samples > kWeightsBwdMaxSamples)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays > 0 && num_samples > 0) {
    const dim3 grid(num_blocks(num_rays)), block(kWarpsPerBlock * 32);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_samples > 32 * 8) {
      const bool vec4 = num_samples % 4 == 0 &&
                        ((reinterpret_cast<uintptr_t>(alpha) |
                          reinterpret_cast<uintptr_t>(g_weights) |
                          reinterpret_cast<uintptr_t>(g_alpha)) & 15) == 0;
      int err = 0;
      if (num_samples > 32 * kStagedMaxRun) {
        neus_weights_bwd_staged_tiles_kernel<<<grid, block, 0, s>>>(
            alpha, g_weights, g_alpha, num_rays, num_samples, vec4);
      } else {
        switch (staged_run(num_samples)) {
          case 9: err = launch_staged<9>(alpha, g_weights, g_alpha, num_rays,
                                         num_samples, vec4, s); break;
          case 10: err = launch_staged<10>(alpha, g_weights, g_alpha,
                                           num_rays, num_samples, vec4, s);
            break;
          case 12: err = launch_staged<12>(alpha, g_weights, g_alpha,
                                           num_rays, num_samples, vec4, s);
            break;
          default: err = launch_staged<16>(alpha, g_weights, g_alpha,
                                           num_rays, num_samples, vec4, s);
        }
      }
      return err != 0 ? err : static_cast<int>(cudaGetLastError());
    }
    const int k = run_length(num_samples, 8);
    const bool whole = num_samples % (32 * k) == 0;
    switch (k) {
      case 1: neus_weights_bwd_kernel<1><<<grid, block, 0, s>>>(
          alpha, g_weights, g_alpha, num_rays, num_samples, whole); break;
      case 2: neus_weights_bwd_kernel<2><<<grid, block, 0, s>>>(
          alpha, g_weights, g_alpha, num_rays, num_samples, whole); break;
      case 4: neus_weights_bwd_kernel<4><<<grid, block, 0, s>>>(
          alpha, g_weights, g_alpha, num_rays, num_samples, whole); break;
      default: neus_weights_bwd_kernel<8><<<grid, block, 0, s>>>(
          alpha, g_weights, g_alpha, num_rays, num_samples, whole);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
