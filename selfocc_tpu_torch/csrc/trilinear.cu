// Trilinear sampling of a channel-first volume with the analytic gradient of
// channel 0: forward (trilinear_cf_with_grad_fwd) and the volume's cotangent
// (trilinear_bwd).
//
// Replaces: selfocc_tpu/ops/interp.py::trilinear_sample_cf_with_grad, which
// XLA lowers on the TPU to 8 corner gathers over a flattened (C, H*W*D)
// volume (the JAX package bundles the 8 corners into one fat gather row
// instead, interp.py::bundle_corners_cf, because TPU gathers are row-rate
// bound). Semantics: align_corners=True fractional (h, w, d) indices, zeros
// padding; vals (N, C) = sum over corners of weight * value; grad0 (N, 3) =
// d(channel 0)/d(h, w, d), the bilinear interpolation over the other two
// axes of the corner differences along each axis.
//
// Bound on the H100: scattered 4-byte reads, 8 * C per point (the render
// chunk has 32768 x 256 = 8.4M points). The depth-only channel
// (257 * 257 * 25 fp32 = 6.6 MB) fits the 50 MB L2, so on the depth path the
// corner reads mostly hit L2; the full 25-channel volume (165 MB) does not.
//
// Design: one thread per sample point. Each thread computes the 8 corner
// offsets, weights and validity once, then loops over channels; channel 0 also
// feeds the gradient. Invalid (out-of-volume) corners are skipped instead of
// read clamped: their weight is 0 in the reference, so the sum is unchanged.
// The accumulation order over corners is the reference's (h, then w, then d).
//
// Backward (trilinear_bwd): the cotangent of the volume from both outputs,
// vals (N, C) and grad0 (N, 3). For every in-volume corner k of a point,
// grad_vol[c, k] += gv[c] * w_k for every channel c, and channel 0 also
// takes sum_j gg[j] * dw_k/dx_j, the derivative of the closed-form gradient
// above with respect to the corner value. The positions get no cotangent
// (nothing upstream of them is trained). One thread per point, atomicAdd
// into grad_vol (neighbouring samples of a ray share corners), out-of-volume
// corners skipped. Bound: the 8 * C (+ 8 for grad0) scattered atomic adds
// per point; the training render calls it on 7.37M points at C = 25, and the
// second-derivative taps about 6x more often at C = 1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void trilinear_cf_with_grad_fwd_kernel(
    const float* __restrict__ vol, const float* __restrict__ hwd,
    float* __restrict__ vals, float* __restrict__ grad0, int64_t num_points,
    int C, int H, int W, int D) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= num_points) return;
  const float h = hwd[3 * n], w = hwd[3 * n + 1], d = hwd[3 * n + 2];
  const float h0 = floorf(h), w0 = floorf(w), d0 = floorf(d);
  const float fh = h - h0, fw = w - w0, fd = d - d0;
  const int h0i = static_cast<int>(h0), w0i = static_cast<int>(w0),
            d0i = static_cast<int>(d0);
  const float wh[2] = {1.f - fh, fh};
  const float ww[2] = {1.f - fw, fw};
  const float wd[2] = {1.f - fd, fd};

  int64_t off[8];
  float wgt[8];
  bool valid[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ih = k >> 2, iw = (k >> 1) & 1, id = k & 1;
    const int hi = h0i + ih, wi = w0i + iw, di = d0i + id;
    valid[k] = hi >= 0 && hi <= H - 1 && wi >= 0 && wi <= W - 1 && di >= 0 &&
               di <= D - 1;
    off[k] = (static_cast<int64_t>(hi) * W + wi) * D + di;
    wgt[k] = wh[ih] * ww[iw] * wd[id];
  }

  const int64_t plane = static_cast<int64_t>(H) * W * D;
  float gh = 0.f, gw = 0.f, gd = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* v = vol + c * plane;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!valid[k]) continue;
      const float g = __ldg(v + off[k]);
      acc += wgt[k] * g;
      if (c == 0) {
        const int ih = k >> 2, iw = (k >> 1) & 1, id = k & 1;
        gh += (ih ? 1.f : -1.f) * ww[iw] * wd[id] * g;
        gw += (iw ? 1.f : -1.f) * wh[ih] * wd[id] * g;
        gd += (id ? 1.f : -1.f) * wh[ih] * ww[iw] * g;
      }
    }
    vals[n * C + c] = acc;
  }
  grad0[3 * n] = gh;
  grad0[3 * n + 1] = gw;
  grad0[3 * n + 2] = gd;
}

// gv (N, C) or null, gg (N, 3) or null; grad_vol (C, H, W, D) zeroed by the
// caller.
__global__ void trilinear_bwd_kernel(const float* __restrict__ hwd,
                                     const float* __restrict__ gv,
                                     const float* __restrict__ gg,
                                     float* __restrict__ grad_vol,
                                     int64_t num_points, int C, int H, int W,
                                     int D) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= num_points) return;
  const float h = hwd[3 * n], w = hwd[3 * n + 1], d = hwd[3 * n + 2];
  const float h0 = floorf(h), w0 = floorf(w), d0 = floorf(d);
  const float fh = h - h0, fw = w - w0, fd = d - d0;
  const int h0i = static_cast<int>(h0), w0i = static_cast<int>(w0),
            d0i = static_cast<int>(d0);
  const float wh[2] = {1.f - fh, fh};
  const float ww[2] = {1.f - fw, fw};
  const float wd[2] = {1.f - fd, fd};
  float gh = 0.f, gw = 0.f, gd = 0.f;
  if (gg != nullptr) {
    gh = gg[3 * n];
    gw = gg[3 * n + 1];
    gd = gg[3 * n + 2];
  }
  const int64_t plane = static_cast<int64_t>(H) * W * D;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ih = k >> 2, iw = (k >> 1) & 1, id = k & 1;
    const int hi = h0i + ih, wi = w0i + iw, di = d0i + id;
    if (hi < 0 || hi > H - 1 || wi < 0 || wi > W - 1 || di < 0 || di > D - 1)
      continue;
    const int64_t off = (static_cast<int64_t>(hi) * W + wi) * D + di;
    const float wgt = wh[ih] * ww[iw] * wd[id];
    float c0 = (ih ? 1.f : -1.f) * ww[iw] * wd[id] * gh +
               (iw ? 1.f : -1.f) * wh[ih] * wd[id] * gw +
               (id ? 1.f : -1.f) * wh[ih] * ww[iw] * gd;
    if (gv != nullptr) {
      c0 += wgt * gv[n * C];
      for (int c = 1; c < C; ++c)
        atomicAdd(grad_vol + c * plane + off, wgt * gv[n * C + c]);
    }
    if (gv != nullptr || gg != nullptr) atomicAdd(grad_vol + off, c0);
  }
}

}  // namespace

extern "C" int trilinear_cf_with_grad_fwd(const float* vol, const float* hwd,
                                          float* vals, float* grad0,
                                          int64_t num_points, int C, int H,
                                          int W, int D, void* stream) {
  if (num_points > 0) {
    const int64_t blocks = (num_points + kThreads - 1) / kThreads;
    trilinear_cf_with_grad_fwd_kernel<<<static_cast<unsigned>(blocks),
                                        kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        vol, hwd, vals, grad0, num_points, C, H, W, D);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trilinear_bwd(const float* hwd, const float* gv,
                             const float* gg, float* grad_vol,
                             int64_t num_points, int C, int H, int W, int D,
                             void* stream) {
  if (num_points > 0) {
    const int64_t blocks = (num_points + kThreads - 1) / kThreads;
    trilinear_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        hwd, gv, gg, grad_vol, num_points, C, H, W, D);
  }
  return static_cast<int>(cudaGetLastError());
}
