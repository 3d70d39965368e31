// Multi-scale deformable attention, per-head sampling locations: forward
// (msda_fwd) and backward (msda_bwd).
//
// Replaces: selfocc_tpu/ops/msda.py::_msda_dense (pure XLA on the TPU: per
// level, 4 corner gathers over a channel-first (B*H, D, h*w) value, then an
// einsum with the attention weights). The reference ran mmcv's CUDA
// ms_deformable_im2col; the semantics are mmcv's pytorch fallback:
// grid_sample with align_corners=False and zeros padding, i.e. fractional
// pixel = loc * size - 0.5, reduced with the softmaxed attention weights and
// accumulated in fp32.
//
// Bound on the H100: gathered bytes. Every (batch, query, head, level, point)
// reads 4 corners of D contiguous floats (64 bytes at D = 16). The flagship
// hw-plane cross-attention alone is 6 x 66049 x 6 x 4 x 8 = 76M points; the
// plain PyTorch version materialises a (B*H, D, Q, P) grid_sample output per
// level (about 1.2 GB on that plane) before the weighted sum.
//
// Design: one thread block per (batch, query); thread t of the block owns
// output channel t of the (H*D) row, i.e. head t / D, channel t % D, so the D
// threads of a head read each corner's D contiguous floats as one coalesced
// segment and their location/weight loads are broadcasts. (With D = 16 a
// warp covers two heads, so no lane idles, unlike one warp per head.) The
// thread loops over levels x points and keeps its sum in a register; nothing
// but the (B, Q, H*D) output is written.
//
// Backward (msda_bwd), mmcv ms_deform_attn_cuda_backward semantics: per
// (batch, query, head, level, point) the four corner weights and values
// give grad_value += g * w_att * w_corner (atomicAdd: many queries sample
// the same pixel), grad_attention_weights = <g, corner blend> and
// grad_sampling_locations = w_att * <g, d(blend)/d(x, y)> * (w, h), the
// derivative of the bilinear weights over the in-bounds corners only (the
// floor and the zeros-padding mask are piecewise constant). Same thread
// layout as the forward: one block per (batch, query), thread t owns
// channel t of the (H*D) row. The per-point grad_loc / grad_w partial sums
// of a head's D threads are reduced with warp shuffles (D a power of two up
// to 32, so a head's lanes are one aligned group of a warp) or, for other
// D, through shared memory, then stored once. Bound: the grad_value
// atomics, 4 * D per point (about 4.9G adds for the flagship hw-plane
// cross-attention call); they contend most on the small FPN levels, where
// many queries hit the same pixels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void msda_fwd_kernel(const float* __restrict__ value,
                                const int* __restrict__ level_table,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                float* __restrict__ out, int L, int H, int D,
                                int Q, int Lv, int P) {
  const int64_t bq = blockIdx.x;  // b * Q + q
  const int64_t b = bq / Q;
  const int HD = H * D;
  for (int t = threadIdx.x; t < HD; t += blockDim.x) {
    const int h = t / D, d = t - (t / D) * D;
    const float* v_b = value + (b * L) * HD + h * D + d;
    float acc = 0.f;
    for (int l = 0; l < Lv; ++l) {
      const int lh = __ldg(level_table + 3 * l);
      const int lw = __ldg(level_table + 3 * l + 1);
      const int start = __ldg(level_table + 3 * l + 2);
      const int64_t base = ((bq * H + h) * Lv + l) * P;
      for (int p = 0; p < P; ++p) {
        const float x = __ldg(loc + 2 * (base + p)) * lw - 0.5f;
        const float y = __ldg(loc + 2 * (base + p) + 1) * lh - 0.5f;
        const float a = __ldg(attn + base + p);
        const float x0 = floorf(x), y0 = floorf(y);
        const float fx = x - x0, fy = y - y0;
        const int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yi = y0i + (k >> 1), xi = x0i + (k & 1);
          if (yi < 0 || yi > lh - 1 || xi < 0 || xi > lw - 1) continue;
          const float wy = (k >> 1) ? fy : 1.f - fy;
          const float wx = (k & 1) ? fx : 1.f - fx;
          s += wy * wx *
               __ldg(v_b + (static_cast<int64_t>(start) + yi * lw + xi) * HD);
        }
        acc += s * a;
      }
    }
    out[bq * HD + t] = acc;
  }
}

// Reduce v over the D lanes of a head; D is a power of two <= 32 and a
// head's lanes are an aligned group of the warp.
__device__ __forceinline__ float head_sum_shfl(float v, int D) {
  for (int o = D >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kShfl>
__global__ void msda_bwd_kernel(const float* __restrict__ value,
                                const int* __restrict__ level_table,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                const float* __restrict__ grad_out,
                                float* __restrict__ grad_value,
                                float* __restrict__ grad_loc,
                                float* __restrict__ grad_attn, int L, int H,
                                int D, int Q, int Lv, int P) {
  extern __shared__ float red[];  // 3 * H partial sums (shared-memory path)
  const int64_t bq = blockIdx.x;  // b * Q + q
  const int64_t b = bq / Q;
  const int HD = H * D;
  const int t = threadIdx.x;
  const bool active = t < HD;
  const int h = active ? t / D : 0;
  const int d = active ? t - h * D : 0;
  const float g = active ? grad_out[bq * HD + t] : 0.f;
  const int64_t col = static_cast<int64_t>(h) * D + d;
  const float* v_b = value + (b * L) * HD + col;
  float* gv_b = grad_value + (b * L) * HD + col;
  for (int l = 0; l < Lv; ++l) {
    const int lh = __ldg(level_table + 3 * l);
    const int lw = __ldg(level_table + 3 * l + 1);
    const int start = __ldg(level_table + 3 * l + 2);
    for (int p = 0; p < P; ++p) {
      const int64_t base = ((bq * H + h) * Lv + l) * P + p;
      const float x = __ldg(loc + 2 * base) * lw - 0.5f;
      const float y = __ldg(loc + 2 * base + 1) * lh - 0.5f;
      const float a = __ldg(attn + base);
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x - x0, fy = y - y0;
      const int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
      float s = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int yi = y0i + (k >> 1), xi = x0i + (k & 1);
        if (!active || yi < 0 || yi > lh - 1 || xi < 0 || xi > lw - 1)
          continue;
        const float wy = (k >> 1) ? fy : 1.f - fy;
        const float wx = (k & 1) ? fx : 1.f - fx;
        const float dwy = (k >> 1) ? 1.f : -1.f;
        const float dwx = (k & 1) ? 1.f : -1.f;
        const int64_t off = (static_cast<int64_t>(start) + yi * lw + xi) * HD;
        const float v = __ldg(v_b + off);
        s += wy * wx * v;
        sx += wy * dwx * v;
        sy += dwy * wx * v;
        atomicAdd(gv_b + off, g * a * wy * wx);
      }
      float ga = g * s;
      float gx = g * a * sx * lw;
      float gy = g * a * sy * lh;
      if (kShfl) {
        ga = head_sum_shfl(ga, D);
        gx = head_sum_shfl(gx, D);
        gy = head_sum_shfl(gy, D);
        if (active && d == 0) {
          grad_attn[base] = ga;
          grad_loc[2 * base] = gx;
          grad_loc[2 * base + 1] = gy;
        }
      } else {
        if (t < 3 * H) red[t] = 0.f;
        __syncthreads();
        if (active) {
          atomicAdd(red + 3 * h, ga);
          atomicAdd(red + 3 * h + 1, gx);
          atomicAdd(red + 3 * h + 2, gy);
        }
        __syncthreads();
        if (t < H) {
          const int64_t hb = ((bq * H + t) * Lv + l) * P + p;
          grad_attn[hb] = red[3 * t];
          grad_loc[2 * hb] = red[3 * t + 1];
          grad_loc[2 * hb + 1] = red[3 * t + 2];
        }
        __syncthreads();
      }
    }
  }
}

}  // namespace

// level_table: device int32 (Lv, 3) rows of (h, w, start offset into L).
extern "C" int msda_fwd(const float* value, const int* level_table,
                        const float* loc, const float* attn, float* out,
                        int64_t B, int L, int H, int D, int Q, int Lv, int P,
                        void* stream) {
  const int64_t blocks = B * Q;
  if (blocks > 0) {
    int threads = ((H * D + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    msda_fwd_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        value, level_table, loc, attn, out, L, H, D, Q, Lv, P);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_value must be zeroed by the caller (the kernel accumulates into it);
// grad_loc and grad_attn are written in full. H * D <= 1024.
extern "C" int msda_bwd(const float* value, const int* level_table,
                        const float* loc, const float* attn,
                        const float* grad_out, float* grad_value,
                        float* grad_loc, float* grad_attn, int64_t B, int L,
                        int H, int D, int Q, int Lv, int P, void* stream) {
  const int64_t blocks = B * Q;
  if (blocks > 0) {
    const int threads = ((H * D + 31) / 32) * 32;
    const bool shfl = D <= 32 && (D & (D - 1)) == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (shfl) {
      msda_bwd_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
          value, level_table, loc, attn, grad_out, grad_value, grad_loc,
          grad_attn, L, H, D, Q, Lv, P);
    } else {
      msda_bwd_kernel<false><<<static_cast<unsigned>(blocks), threads,
                               3 * H * sizeof(float), st>>>(
          value, level_table, loc, attn, grad_out, grad_value, grad_loc,
          grad_attn, L, H, D, Q, Lv, P);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
