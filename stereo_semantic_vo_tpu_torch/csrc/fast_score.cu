// FAST-9/16 corner scores for one or two thresholds from one ring read, for
// every pyramid level of a frame in one launch, with extract_orb's border
// mask and 3x3 non-max suppression fused.
//
// Replaces: stereo_semantic_vo_tpu/kernels/fast_score.py:fast_scores_pallas
// (Pallas, TPU).  Its contract: img (H, W) float32 is zero outside its edge
// (a 3-px zero halo); per threshold t the score of a pixel is
// max(sum of (d - t) over the ring samples brighter by more than t,
//     sum of (-d - t) over those darker by more than t),
// d = ring sample - centre, and 0 unless 9 contiguous ring samples are all
// brighter or all darker.  With the epilogue on (kFused), each level's
// output is the composition extract_orb runs on those scores
// (stereo_semantic_vo_tpu/ops/orb.py:337-343):
//   _nms3(where(border_mask, fast_scores_pallas(img_l, ths)[j], 0))
// border_mask = [b, H-b) x [b, W-b); _nms3 keeps s where s >= its 3x3 max
// (-inf outside the image) and writes 0 elsewhere.  Without it, the raw
// scores of one level (the TPU kernel's own contract).
//
// Bit-equal to the plain version (kernels/fast_score.fast_scores_plain and
// fast_scores_levels_plain): the differences and both sums are rounded as it
// rounds them, in ring order from sample 0, with __fsub_rn / __fadd_rn (no
// contraction); a sample that fails the test adds nothing, where the plain
// version's where(..., 0.0) adds +0.0, which leaves a sum of +0.0 or more
// bit for bit as it is.  The run test is the 16-bit ring mask m:
// (m | m << 16) ANDed with its shifts by 1..8, taken as a doubling chain
// (runs of 2, 4, 8, then 9) in 4 steps for 8.  The NMS only selects: its
// output is s or +0.0.  Scores are >= +0.0, so a masked neighbour (0) and a
// neighbour outside the image (-inf in the plain NMS) decide alike.
//
// Bound on the H100: memory.  A frame's 8 levels (~1.44 M px) read each
// image once and write 4 bytes a pixel per threshold: 17.3 MB with two
// thresholds, 5.2 us at 3.35 TB/s; the NMS adds no HBM traffic and the
// arithmetic (~150 flops a pixel) is below that.  Design: the level table
// (image, H, W, tiles per row, first block, output offset of each of up to 8
// levels) travels by value in the kernel's parameters, so one launch covers
// every level with nothing uploaded per call (capture-safe, no sync).  A
// block of 256 threads scores a 32x32 region, a lane a column and a warp
// every 8th row, so every thread slot scores a pixel and the warps read
// shared memory at consecutive addresses: with the epilogue the region is a
// 30x30 output tile plus the 1-px ring the NMS reads (the border mask
// applied), without it a 32x32 output tile.  The block stages the region
// with the ring's 3-px halo (38x38 floats) in shared memory first.  A tile
// that lies wholly in the border writes zeros and skips the ring test.
//
// What bounds it in practice is instruction throughput, not memory: the exact sums
// (ring order, no reassociation) and the two 16-bit masks take a compare
// and a predicated OR on the integer pipe and two adds a sample, side and
// threshold; on a textured frame nearly every pixel passes FAST's
// 4-sample pre-test, so an early exit would skip little.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxThresholds = 2;
constexpr int kR = 3;                 // ring radius
constexpr int kRegion = 32;           // pixels scored per block, each way
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBuf = kRegion + 2 * kR;  // staged pixels per block, each way

// output tile per block, each way: the region less the NMS's ring when fused
__host__ __device__ constexpr int tile_size(bool fused) { return fused ? kRegion - 2 : kRegion; }

struct FastLevels {
  const float* img[kMaxLevels];
  long long out[kMaxLevels];  // offset of the level's first pixel in a threshold's plane
  int H[kMaxLevels];
  int W[kMaxLevels];
  int tiles_x[kMaxLevels];
  int first[kMaxLevels];      // the level's first block
  int n_levels;
};

// a circular run of >= 9 set bits in the 16-bit ring mask m
__device__ __forceinline__ bool has_arc(uint32_t m) {
  const uint32_t m2 = m | (m << 16);
  uint32_t run = m2 & (m2 >> 1);  // runs of 2 start here
  run &= run >> 2;                // of 4
  run &= run >> 4;                // of 8
  run &= m2 >> 8;                 // of 9
  return (run & 0xFFFFu) != 0;
}

// the scores at buf[cy][cx] for n_th thresholds
__device__ __forceinline__ void ring_scores(float (*buf)[kBuf], int cy, int cx, int n_th, float t0, float t1,
                                            float* s) {
  // the ring, clockwise from 12 o'clock (kernels/fast_score.CIRCLE)
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = buf[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = __fsub_rn(buf[cy + dy[k]][cx + dx[k]], c);
#pragma unroll
  for (int j = 0; j < kMaxThresholds; ++j) {
    if (j >= n_th) break;
    const float t = j == 0 ? t0 : t1;
    uint32_t mb = 0, md = 0;
    float sb = 0.f, sd = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      // a sample that fails adds nothing, where the plain version adds
      // +0.0: the same bits, since a sum is +0.0 or positive; the adds and
      // the mask bits become predicated instructions, with no selects
      if (d[k] > t) {
        mb |= 1u << k;
        sb = __fadd_rn(sb, __fsub_rn(d[k], t));
      }
      if (d[k] < -t) {
        md |= 1u << k;
        sd = __fadd_rn(sd, __fsub_rn(-d[k], t));
      }
    }
    s[j] = (has_arc(mb) || has_arc(md)) ? fmaxf(sb, sd) : 0.f;
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
    fast_scores_levels_kernel(const FastLevels lv, int n_th, float t0, float t1, int border, long long plane,
                              float* __restrict__ out) {
  constexpr int kS = kFused ? 1 : 0;  // the score ring the NMS reads around the tile
  constexpr int kTile = tile_size(kFused);
  __shared__ float buf[kBuf][kBuf];
  __shared__ float sc[kFused ? kMaxThresholds : 1][kFused ? kRegion : 1][kFused ? kRegion : 1];

  // the block's level: the last one whose first block is <= blockIdx.x
  // (static indices only, so the table stays in the parameter bank)
  const int blk = static_cast<int>(blockIdx.x);
  const float* img = lv.img[0];
  long long off = lv.out[0];
  int H = lv.H[0], W = lv.W[0], tiles_x = lv.tiles_x[0], first = 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l < lv.n_levels && blk >= lv.first[l]) {
      img = lv.img[l];
      off = lv.out[l];
      H = lv.H[l];
      W = lv.W[l];
      tiles_x = lv.tiles_x[l];
      first = lv.first[l];
    }
  }
  const int b = blk - first;
  const int by = (b / tiles_x) * kTile, bx = (b % tiles_x) * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* dst = out + off;

  if constexpr (kFused) {
    // a tile wholly in the border: zeros, no ring test (uniform per block)
    const bool rows = max(by, border) < min(by + kTile, H - border);
    const bool cols = max(bx, border) < min(bx + kTile, W - border);
    if (!(rows && cols)) {
      const int x = bx + lane;
      for (int ty = warp; ty < kTile; ty += kWarps) {
        const int y = by + ty;
        if (lane < kTile && y < H && x < W) {
          for (int j = 0; j < n_th; ++j) dst[j * plane + static_cast<long long>(y) * W + x] = 0.f;
        }
      }
      return;
    }
  }

  const int oy = by - kS - kR, ox = bx - kS - kR;
  for (int i = tid; i < kBuf * kBuf; i += kThreads) {
    const int ty = i / kBuf, tx = i - ty * kBuf;
    const int gy = oy + ty, gx = ox + tx;
    buf[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[static_cast<size_t>(gy) * W + gx] : 0.f;
  }
  __syncthreads();

  // a lane a column, a warp every 8th row of the region
  const int x = bx - kS + lane;
  for (int sy = warp; sy < kRegion; sy += kWarps) {
    const int y = by - kS + sy;
    float s[kMaxThresholds];
    ring_scores(buf, sy + kR, lane + kR, n_th, t0, t1, s);
    if constexpr (kFused) {
      const bool inside = y >= border && y < H - border && x >= border && x < W - border;
      for (int j = 0; j < n_th; ++j) sc[j][sy][lane] = inside ? s[j] : 0.f;
    } else if (y < H && x < W) {
      for (int j = 0; j < n_th; ++j) dst[j * plane + static_cast<long long>(y) * W + x] = s[j];
    }
  }
  if constexpr (kFused) {
    __syncthreads();
    // output (ty, tx) is region (ty + 1, tx + 1); lanes 30 and 31 idle
    const int xo = bx + lane;
    for (int ty = warp; ty < kTile; ty += kWarps) {
      const int y = by + ty;
      if (lane >= kTile || y >= H || xo >= W) continue;
      for (int j = 0; j < n_th; ++j) {
        const float c = sc[j][ty + 1][lane + 1];
        float m = c;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, sc[j][ty + dy][lane + dx]);
        }
        dst[j * plane + static_cast<long long>(y) * W + xo] = c >= m ? c : 0.f;
      }
    }
  }
}

}  // namespace

// imgs: n_levels device pointers; H, W: n_levels host ints each.  out is
// (n_th, sum H*W) float32: threshold j's plane holds the levels' maps in
// level order.  fused = 1: border mask and NMS (extract_orb's maps); 0: the
// raw scores (the TPU kernel's contract).
extern "C" int ssvo_fast_scores_levels(const float* const* imgs, const int* H, const int* W, int n_levels,
                                       int n_th, float t0, float t1, int border, int fused, float* out,
                                       cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_th < 1 || n_th > kMaxThresholds || border < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = tile_size(fused != 0);
  FastLevels lv = {};
  long long plane = 0;
  int blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (H[l] < 0 || W[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
    lv.img[l] = imgs[l];
    lv.out[l] = plane;
    lv.H[l] = H[l];
    lv.W[l] = W[l];
    lv.tiles_x[l] = W[l] > 0 ? (W[l] + tile - 1) / tile : 1;
    lv.first[l] = blocks;
    blocks += H[l] > 0 && W[l] > 0 ? lv.tiles_x[l] * ((H[l] + tile - 1) / tile) : 0;
    plane += static_cast<long long>(H[l]) * W[l];
  }
  lv.n_levels = n_levels;
  if (blocks > 0) {
    if (fused) {
      fast_scores_levels_kernel<true><<<blocks, kThreads, 0, stream>>>(lv, n_th, t0, t1, border, plane, out);
    } else {
      fast_scores_levels_kernel<false><<<blocks, kThreads, 0, stream>>>(lv, n_th, t0, t1, border, plane, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
