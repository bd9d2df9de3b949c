// Full Hamming distance matrix of 256-bit descriptors: out[q, t] =
// popcount(query[q] XOR train[t]) summed over the 8 32-bit words.
//
// Replaces: stereo_semantic_vo_tpu/kernels/hamming.py:hamming_distance_matrix_pallas
// (Pallas, TPU), which tiled query blocks against the whole train set in
// VMEM.  Equal to the plain kernels/hamming.hamming_distance_matrix.
//
// Bound on the H100: integer issue, then the output write.  Q x T x 8
// popcounts (8.4 M at Q=2048, T=512) run at 16 a clock per SM, ~2.3 us on
// 132 SMs at 1.98 GHz; the (Q, T) int32 output is 4.2 MB, ~1.3 us at
// 3.35 TB/s.  Design: a block is 128 train columns by 16 query rows.  Each
// thread holds its train row's 8 words in registers, the block's 16 query
// rows sit in shared memory and every thread reads them at the same
// address (a broadcast), and a warp writes 32 consecutive ints of an output
// row (coalesced).
//
// Later work: more query rows per block to spread the train loads, and
// 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;     // 256 bits as 8 x 32-bit words
constexpr int kCols = 128;    // train rows per block (one per thread)
constexpr int kRows = 16;     // query rows per block

__global__ void hamming_matrix_kernel(const uint32_t* __restrict__ query,
                                      const uint32_t* __restrict__ train, int Q, int T,
                                      int* __restrict__ out) {
  __shared__ uint32_t qs[kRows][kWords];
  const int t = blockIdx.x * kCols + threadIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int nq = min(kRows, Q - q0);
  for (int i = threadIdx.x; i < nq * kWords; i += kCols) {
    qs[i / kWords][i % kWords] = query[static_cast<size_t>(q0) * kWords + i];
  }
  __syncthreads();
  if (t >= T) return;
  uint32_t tw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) tw[w] = train[static_cast<size_t>(t) * kWords + w];
  for (int i = 0; i < nq; ++i) {
    int d = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) d += __popc(qs[i][w] ^ tw[w]);
    out[static_cast<size_t>(q0 + i) * T + t] = d;
  }
}

}  // namespace

extern "C" int ssvo_hamming_distance_matrix(const uint32_t* query, const uint32_t* train, int Q,
                                            int T, int* out, cudaStream_t stream) {
  if ((Q + kRows - 1) / kRows > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  if (Q > 0 && T > 0) {
    const dim3 grid((T + kCols - 1) / kCols, (Q + kRows - 1) / kRows);
    hamming_matrix_kernel<<<grid, kCols, 0, stream>>>(query, train, Q, T, out);
  }
  return static_cast<int>(cudaGetLastError());
}
