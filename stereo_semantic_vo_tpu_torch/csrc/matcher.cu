// Fused Hamming matcher: per query descriptor, the best train index, the
// best distance and the second-best distance over 256-bit descriptors.
//
// Replaces: stereo_semantic_vo_tpu/kernels/matcher.py:fused_best_match
// (Pallas, TPU).  Same semantics as the plain masked_best_match: a masked
// pair (invalid query or invalid train row) has distance 257; ties go to the
// lower train index, because the minimum is taken over the code
// d * T + idx; the second-best is the smallest code other than the winner's.
// An invalid query therefore yields idx 0, best 257, second 257.
//
// Bound on the H100: integer throughput.  A call does Q * T * 8 XOR+popcount
// pairs (8 M at Q=2048, T=512) on 16 KB of train descriptors; at 16
// popcounts a clock per SM that is 2.5 us for a tracking step's two calls.
// Design: a warp takes one query, held in registers, and each lane a
// strided slice of the train rows (rows lane, lane + 32, ...), so a query's
// T rows are walked 32 at a time and Q=512 already gives 128 warps (one
// query a warp timed fastest on the H100 against 2 and 4, PERF.md).  A
// block of 4 warps stages 512 train rows at a time in shared memory,
// word-major with a pitch of 516 words (4 mod 32), so the staging stores
// and the lanes' reads of consecutive rows hit 32 distinct banks.
// Each lane keeps its own (best, second) codes with min/max, no branch;
// a butterfly of __shfl_xor_sync merges the lanes' pairs with
// best = min(a.best, b.best), second = min(max(a.best, b.best),
// min(a.second, b.second)), exact because every train index has its own
// code.  The sentinel INT_MAX (no row seen) maps to 257 as before.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;       // 256 bits as 8 x 32-bit words
constexpr int kTile = 512;      // train rows per shared-memory tile (16 KB)
constexpr int kPitch = kTile + 4;
constexpr int kWarps = 4;       // warps per block
constexpr int kBigDist = 257;   // distance of a masked pair

__global__ void __launch_bounds__(kWarps * 32)
    fused_best_match_kernel(const uint4* __restrict__ query, const uint4* __restrict__ train,
                            const unsigned char* __restrict__ query_valid,
                            const unsigned char* __restrict__ train_valid, int Q, int T,
                            int* __restrict__ out) {
  __shared__ uint32_t tile[kWords][kPitch];
  __shared__ unsigned char tile_valid[kTile];

  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool busy = q < Q;  // uniform across the warp
  uint4 a = make_uint4(0, 0, 0, 0), b = a;
  bool q_ok = false;
  if (busy) {  // every lane loads the same words (a broadcast)
    a = query[2 * q];
    b = query[2 * q + 1];
    q_ok = query_valid[q] != 0;
  }
  const uint32_t qw[kWords] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int best = INT_MAX, second = INT_MAX;

  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < 2 * n; i += kWarps * 32) {
      const uint4 v = train[2 * static_cast<size_t>(base) + i];
      const int row = i >> 1, w = (i & 1) * 4;
      tile[w][row] = v.x;
      tile[w + 1][row] = v.y;
      tile[w + 2][row] = v.z;
      tile[w + 3][row] = v.w;
    }
    for (int i = threadIdx.x; i < n; i += kWarps * 32) tile_valid[i] = train_valid[base + i];
    __syncthreads();
    if (!busy) continue;
#pragma unroll 4
    for (int r = lane; r < n; r += 32) {
      uint32_t tw[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) tw[w] = tile[w][r];
      const bool t_ok = tile_valid[r] != 0;
      int d = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) d += __popc(qw[w] ^ tw[w]);
      const int code = (q_ok && t_ok ? d : kBigDist) * T + base + r;
      second = min(second, max(best, code));
      best = min(best, code);
    }
  }
  if (!busy) return;

#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const int ob = __shfl_xor_sync(0xFFFFFFFFu, best, m);
    const int os = __shfl_xor_sync(0xFFFFFFFFu, second, m);
    second = min(max(best, ob), min(second, os));
    best = min(best, ob);
  }
  if (lane == 0) {
    out[q] = best % T;
    out[Q + q] = best / T;
    out[2 * Q + q] = second == INT_MAX ? kBigDist : second / T;
  }
}

}  // namespace

// query (Q, 8) and train (T, 8) words, 16-byte aligned; out (3, Q) int32:
// best idx, best, second.
extern "C" int ssvo_fused_best_match(const void* query, const void* train, const unsigned char* query_valid,
                                     const unsigned char* train_valid, int Q, int T, int* out,
                                     cudaStream_t stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (Q > 0) {
    fused_best_match_kernel<<<(Q + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
        static_cast<const uint4*>(query), static_cast<const uint4*>(train), query_valid, train_valid, Q, T, out);
  }
  return static_cast<int>(cudaGetLastError());
}
