// Row gather out[i] = table[idx[i]] for a row-major (R, row_bytes) table.
//
// Replaces: selfocc_tpu/ops/gather_rows.py::gather_rows (Pallas, pallas_call
// at :82, kernel _gather_kernel at :27), which walks index blocks on the TPU
// and keeps `inflight` single-row HBM->VMEM DMAs rotating over a semaphore
// ring. On Hopper there is no such ring to manage: many warps in flight are
// the outstanding copies, so the kernel is a plain warp-per-row copy.
//
// Bound on the H100: bytes. Each output row is read once from the table and
// written once (2 * N * row_bytes, plus 4 * N for the indices); the
// microbenchmark shape (tools/bench_gather.py: N = 2^21 rows of a
// 1,651,225 x 200 bf16 table) moves 1.68 GB.
//
// Design: one warp per output row. The warp's lanes copy the row's bytes as
// vectors of the widest width (16, 8, 4, 2 or 1 bytes) that divides the row
// pitch and the alignment of both base pointers, so a 400-byte bf16 row of
// 200 channels is 25 lanes x 16 bytes. The kernel never looks at the dtype:
// any element type moves as bytes. Indices are int32 and must be in range
// (the contract of the JAX function; nothing is checked on the card).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int* __restrict__ idx,
                                   V* __restrict__ out, int64_t num_rows,
                                   int64_t row_vecs) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= num_rows) return;
  const int lane = threadIdx.x & 31;
  const V* src = table + static_cast<int64_t>(__ldg(idx + row)) * row_vecs;
  V* dst = out + row * row_vecs;
  for (int64_t j = lane; j < row_vecs; j += 32) dst[j] = __ldg(src + j);
}

template <typename V>
void launch(const void* table, const int* idx, void* out, int64_t num_rows,
            int64_t row_bytes, cudaStream_t stream) {
  const int64_t blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock,
                          0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), num_rows,
      row_bytes / static_cast<int64_t>(sizeof(V)));
}

}  // namespace

extern "C" int gather_rows(const void* table, const int* idx, void* out,
                           int64_t num_rows, int64_t row_bytes,
                           void* stream) {
  const uint64_t align = reinterpret_cast<uint64_t>(table) |
                         reinterpret_cast<uint64_t>(out) |
                         static_cast<uint64_t>(row_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows > 0 && row_bytes > 0) {
    if (align % 16 == 0) {
      launch<int4>(table, idx, out, num_rows, row_bytes, st);
    } else if (align % 8 == 0) {
      launch<int2>(table, idx, out, num_rows, row_bytes, st);
    } else if (align % 4 == 0) {
      launch<int>(table, idx, out, num_rows, row_bytes, st);
    } else if (align % 2 == 0) {
      launch<short>(table, idx, out, num_rows, row_bytes, st);
    } else {
      launch<char>(table, idx, out, num_rows, row_bytes, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
