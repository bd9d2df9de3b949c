// FAST-9/16 corner scores for one or two thresholds from one ring read.
//
// Replaces: stereo_semantic_vo_tpu/kernels/fast_score.py:fast_scores_pallas
// (Pallas, TPU).  Same contract: img (H, W) float32 is zero outside its edge
// (a 3-px zero halo); per threshold t the score of a pixel is
// max(sum of (d - t) over the ring samples brighter by more than t,
//     sum of (-d - t) over those darker by more than t),
// d = ring sample - centre, and 0 unless 9 contiguous ring samples are all
// brighter or all darker.  The output is (n, H, W), n = 1 or 2 thresholds.
//
// Bit-equal to the plain version (kernels/fast_score.fast_scores_plain): the
// differences and both sums are rounded as it rounds them, in ring order
// from sample 0, with __fsub_rn / __fadd_rn (no contraction); a sample that
// fails the test adds +0.0, as the plain version's where(..., 0.0) does.
// The run test is the 16-bit ring mask m: (m | m << 16) ANDed with its
// shifts by 1..8.
//
// Bound on the H100: memory.  A level reads its image once and writes 4 or
// 8 bytes a pixel: at 376x1241 with two thresholds 5.6 MB, ~1.7 us at
// 3.35 TB/s; the arithmetic (~140 flops a pixel) is below that.  Design:
// one thread per output pixel; a block stages its 32x8 tile with the 3-px
// halo (38x14 floats) in shared memory, so a block loads 2.1 pixels for each
// it scores (the overlap mostly from L2), and each thread reads its 16 ring
// samples once for both thresholds.
//
// Later work: fuse the border mask and the 3x3 non-max suppression, and
// score all 8 pyramid levels in one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;        // ring radius
constexpr int kTileW = 32;   // output pixels per block, x
constexpr int kTileH = 8;    // output pixels per block, y
constexpr int kBufW = kTileW + 2 * kR;
constexpr int kBufH = kTileH + 2 * kR;
constexpr int kArc = 9;

__device__ __forceinline__ bool has_arc(uint32_t m) {
  const uint32_t m2 = m | (m << 16);
  uint32_t run = m2;
#pragma unroll
  for (int k = 1; k < kArc; ++k) run &= m2 >> k;
  return (run & 0xFFFFu) != 0;
}

__global__ void fast_scores_kernel(const float* __restrict__ img, int H, int W, int n_th,
                                   float t0, float t1, float* __restrict__ out) {
  __shared__ float buf[kBufH][kBufW];
  const int bx = blockIdx.x * kTileW, by = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kBufH * kBufW; i += kTileW * kTileH) {
    const int ty = i / kBufW, tx = i - ty * kBufW;
    const int gy = by + ty - kR, gx = bx + tx - kR;
    buf[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[static_cast<size_t>(gy) * W + gx] : 0.f;
  }
  __syncthreads();
  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= W || y >= H) return;

  // the ring, clockwise from 12 o'clock (ops/orb CIRCLE)
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int cy = threadIdx.y + kR, cx = threadIdx.x + kR;
  const float c = buf[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = __fsub_rn(buf[cy + dy[k]][cx + dx[k]], c);

  for (int j = 0; j < n_th; ++j) {
    const float t = j == 0 ? t0 : t1;
    uint32_t mb = 0, md = 0;
    float sb = 0.f, sd = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const bool b = d[k] > t;
      const bool dark = d[k] < -t;
      mb |= static_cast<uint32_t>(b) << k;
      md |= static_cast<uint32_t>(dark) << k;
      sb = __fadd_rn(sb, b ? __fsub_rn(d[k], t) : 0.f);
      sd = __fadd_rn(sd, dark ? __fsub_rn(-d[k], t) : 0.f);
    }
    const bool corner = has_arc(mb) || has_arc(md);
    out[(static_cast<size_t>(j) * H + y) * W + x] = corner ? fmaxf(sb, sd) : 0.f;
  }
}

}  // namespace

extern "C" int ssvo_fast_scores(const float* img, int H, int W, int n_th, float t0, float t1,
                                float* out, cudaStream_t stream) {
  if (n_th < 1 || n_th > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (H > 0 && W > 0) {
    const dim3 block(kTileW, kTileH);
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
    fast_scores_kernel<<<grid, block, 0, stream>>>(img, H, W, n_th, t0, t1, out);
  }
  return static_cast<int>(cudaGetLastError());
}
