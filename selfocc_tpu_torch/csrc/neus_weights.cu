// NeuS compositing weights, forward: w_i = a_i * exp(sum_{j<i} log(1 - a_j + 1e-7)).
//
// Replaces: selfocc_tpu/ops/render_pallas.py::_weights_kernel (the Pallas
// TPU kernel behind weights_from_alpha_pallas). On the TPU the exclusive
// log-sum is one (S, S) strictly-lower-triangular MXU matmul per 256-ray
// block. A Hopper SM has no reason to spend S^2 multiply-adds on a scan.
//
// Bound on the H100: memory. One read and one write of (R, S) fp32, i.e.
// 2 * R * S * 4 bytes (67 MB for a 32768 x 256 render chunk), against a few
// transcendental ops per element.
//
// Design: one warp per ray. The warp walks the ray's samples in tiles of 32
// (lane i holds sample base + i, so every load and store is one coalesced
// 128-byte line), takes log(1 - a + eps), runs a shuffle inclusive scan, and
// shifts it by one lane to get the exclusive prefix. A running carry (the
// previous tiles' total) joins the tiles. Everything stays in fp32 and in
// registers; any S works, ragged tails are masked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-7f;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void neus_weights_fwd_kernel(const float* __restrict__ alpha,
                                        float* __restrict__ weights,
                                        int64_t num_rays, int num_samples) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (ray >= num_rays) return;  // uniform per warp: the shuffles stay full
  const float* a_row = alpha + ray * num_samples;
  float* w_row = weights + ray * num_samples;
  float carry = 0.f;  // log-transmittance of all samples before this tile
  for (int base = 0; base < num_samples; base += 32) {
    const int i = base + lane;
    const bool live = i < num_samples;
    const float a = live ? a_row[i] : 0.f;
    const float la = live ? logf(1.f - a + kEps) : 0.f;
    float incl = la;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += up;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    if (live) w_row[i] = a * expf(carry + excl);
    carry += __shfl_sync(kFull, incl, 31);
  }
}

}  // namespace

extern "C" int neus_weights_fwd(const float* alpha, float* weights,
                                int64_t num_rays, int num_samples,
                                void* stream) {
  if (num_rays > 0 && num_samples > 0) {
    const int64_t blocks = (num_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
    neus_weights_fwd_kernel<<<static_cast<unsigned>(blocks),
                              kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        alpha, weights, num_rays, num_samples);
  }
  return static_cast<int>(cudaGetLastError());
}
