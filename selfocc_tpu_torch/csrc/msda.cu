// Multi-scale deformable attention, forward, per-head sampling locations.
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
