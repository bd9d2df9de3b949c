// Full Hamming distance matrix of 256-bit descriptors: out[q, t] =
// popcount(query[q] XOR train[t]) summed over the 8 32-bit words.
//
// Replaces: stereo_semantic_vo_tpu/kernels/hamming.py:hamming_distance_matrix_pallas
// (Pallas, TPU), which tiled query blocks against the whole train set in
// VMEM.  Equal to the plain kernels/hamming.hamming_distance_matrix.
//
// Bound on the H100: the popcount pipe, then the output write.  Q x T x 8
// popcounts (8.4 M at Q=2048, T=512) run at 16 a clock per SM, ~2.0 us on
// 132 SMs at 1.98 GHz (0.5 us at Q=512); the (Q, T) int32 output is 4.2 MB,
// ~1.3 us at 3.35 TB/s.  Design: a block is 8 warps on 128 train columns;
// it stages their words once in shared memory, word-major with a pitch of
// 132 words (4 mod 32), one coalesced 16-byte load a thread, so the
// staging stores hit 32 banks and a lane reads the words of its 4
// consecutive columns as 8 conflict-free 16-byte loads into registers.  A
// warp then takes one query row: its lanes read the row's words at one
// address (a broadcast) and write 4 columns each as one 16-byte store, 512
// contiguous bytes a warp.  Q=512 against T=512 is then 2048 warps (~16 an
// SM), so every popcount unit has warps to switch to; 2 and 4 rows a warp,
// which stage the tile for more rows, timed slower on the H100 (PERF.md).
// A T that is no multiple of 4 stores column by column, masked; the ragged
// tile stages its last row again in place of the missing ones.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;                 // 256 bits as 8 x 32-bit words
constexpr int kCols = 4;                  // train columns a lane
constexpr int kTile = 32 * kCols;         // train columns a block
constexpr int kPitch = kTile + 4;         // words a staged row: 4 mod 32 banks, 16-byte aligned
constexpr int kWarps = 8;                 // warps a block, a query row each

__global__ void __launch_bounds__(kWarps * 32)
    hamming_matrix_kernel(const uint4* __restrict__ query, const uint4* __restrict__ train, int Q, int T,
                          int* __restrict__ out) {
  __shared__ __align__(16) uint32_t tile[kWords][kPitch];
  const int base = blockIdx.y * kTile;
  {  // thread i stages half i % 2 of train row base + i / 2
    const int i = threadIdx.x;
    const int col = i >> 1, h = (i & 1) * 4;
    const uint4 v = train[2 * static_cast<size_t>(min(base + col, T - 1)) + (i & 1)];
    tile[h][col] = v.x;
    tile[h + 1][col] = v.y;
    tile[h + 2][col] = v.z;
    tile[h + 3][col] = v.w;
  }
  static_assert(kWarps * 32 == 2 * kTile, "a thread stages one half row");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int t0 = base + lane * kCols;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t0 >= T || q >= Q) return;  // no barrier follows
  uint32_t tw[kWords][kCols];  // word w of columns t0 .. t0+3
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const uint4 v = *reinterpret_cast<const uint4*>(&tile[w][lane * kCols]);
    tw[w][0] = v.x, tw[w][1] = v.y, tw[w][2] = v.z, tw[w][3] = v.w;
  }
  const uint4 a = query[2 * static_cast<size_t>(q)];
  const uint4 b = query[2 * static_cast<size_t>(q) + 1];
  const uint32_t qw[kWords] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int d[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    d[c] = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) d[c] += __popc(qw[w] ^ tw[w][c]);
  }
  int* row = out + static_cast<size_t>(q) * T + t0;
  if ((T & (kCols - 1)) == 0) {
    *reinterpret_cast<int4*>(row) = make_int4(d[0], d[1], d[2], d[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (t0 + c < T) row[c] = d[c];
    }
  }
}

}  // namespace

// query (Q, 8) and train (T, 8) words and out (Q, T) int32, each 16-byte
// aligned.
extern "C" int ssvo_hamming_distance_matrix(const void* query, const void* train, int Q, int T, int* out,
                                            cudaStream_t stream) {
  const int col_blocks = (T + kTile - 1) / kTile;
  if (col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  if (Q > 0 && T > 0) {
    const dim3 grid((Q + kWarps - 1) / kWarps, col_blocks);
    hamming_matrix_kernel<<<grid, kWarps * 32, 0, stream>>>(static_cast<const uint4*>(query),
                                                            static_cast<const uint4*>(train), Q, T, out);
  }
  return static_cast<int>(cudaGetLastError());
}
