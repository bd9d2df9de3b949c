// Dense stereo's two matching-cost volumes, left-based and right-based, in
// one launch: the raw costs, the 7x7 zero-padded box sum and the division
// by the window's area.
//
// Replaces no TPU kernel: the reference builds the volume in XLA
// (stereo_semantic_vo_tpu/ops/dense_stereo.py:cost_volume).  The port's
// plain version (ops/dense_stereo.cost_volume) loops over the D disparities,
// stacks them and sums the window with 48 whole-volume adds, ~1,150
// launches a frame for the pair; this kernel is its fused form.
//
// Contract, bit for bit the plain version as PyTorch's CUDA ops compute it:
//   G(x)       = (I[(x+1) mod W] - I[(x-1) mod W]) * 0.5
//   cost(x, d) = wc * min(|I_b(x) - I_m(x -+ d)|, tc) + wg * min(|G_b(x) - G_m(x -+ d)|, tg)
// with the match column wrapping mod W (torch.roll), b / m the left / right
// image for the left-based volume (x - d) and the right / left image for
// the right-based one (x + d); then
//   out(y, x, d) = (sum of the 49 costs of the window) * float32(1 / 49)
// where the window is zero outside the image and its terms are added one
// after another from window position (0, 0), row by row and column by
// column, as the plain version's sequence of adds over the padded volume.
// An accumulator starts at +0.0 (+0 + c = c exactly) and a term outside the
// image adds +0.0, which leaves a sum of costs (all >= +0) unchanged.  The
// last step is PyTorch's CUDA true division by a CPU scalar, which
// multiplies by the float32 reciprocal; the wrapper passes that
// reciprocal.  Every multiply and add is an _rn intrinsic, so nvcc cannot
// contract them into FMAs.
//
// Bound on the H100: the bytes, both volumes (2 x 376 x 1241 x 48 x 4 =
// 179 MB) written once and the two images read once, 54.6 us at
// 3.35 TB/s; the window sums take 49 adds an output (2.2 G adds a frame,
// ~70 us of the SMs' float32 adds), since their order is fixed (no
// separable or running sums).  Measured: 0.200 ms a frame.  Design: a
// block owns an 8 x 32 output tile of one volume and walks the
// disparities in passes of 16.  It stages each image row it needs once
// (intensity and x-gradient as a float2 a column: the tile with its 3-px
// halo from the base image, that span widened by D - 1 columns from the
// match image), then per pass writes the raw costs of the tile and halo to
// shared memory (14 x 38 cells x 16 disparities) and sums them: a thread
// holds 2 x 4 outputs x 4 disparities (one float4 a position) and adds each
// float4 it loads to every accumulator whose window holds it, so a pass
// reads 80 float4 a thread for 1,568 adds.  Positions in shared memory are
// 16 floats apart and rows 8 floats more than a whole row, so the two
// output rows a quarter warp loads together fall in the two halves of the
// banks.  Outputs go out as 16-byte stores, d fastest.  Four blocks share
// an SM (47 KB of shared memory each, registers capped at 128 with a 16-
// byte spill): three or two blocks with the registers free ran 16% and 6%
// slower, a 16-row tile at two blocks 4% faster.  The grid covers
// both volumes; the shapes of kitti() (r = 3, D = 48) are compile-time,
// other (r, D) run a runtime-shape instantiation of the same kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;        // output rows a block
constexpr int kTW = 32;       // output columns a block
constexpr int kDC = 16;       // disparities a pass
constexpr int kRB = 2;        // output rows a thread
constexpr int kCB = 4;        // output columns a thread
constexpr int kThreads = (kDC / 4) * (kTW / kCB) * (kTH / kRB);  // 128
constexpr int kMinBlocks = 4;  // blocks an SM: 4 x 47 KB of shared memory at r = 3, D = 48
constexpr int kMaxD = 128;
constexpr int kMaxR = 7;

struct CostParams {
  const float* left;
  const float* right;
  float* out;  // (2, H, W, D): the left-based volume, then the right-based
  int H, W, D, r;
  float wc, wg, tc, tg, inv_area;
};

// shared memory a block: the cost tile, then the base and match rows
__host__ __device__ constexpr int cost_row_stride(int r) { return (kTW + 2 * r) * kDC + 8; }
__host__ __device__ constexpr int smem_floats(int r, int D) {
  return (kTH + 2 * r) * cost_row_stride(r) + 2 * (kTH + 2 * r) * (2 * (kTW + 2 * r) + D - 1);
}

__device__ __forceinline__ int wrap(int c, int W) {
  while (c < 0) c += W;
  while (c >= W) c -= W;
  return c;
}

__device__ __forceinline__ float raw_cost(float2 b, float2 m, const CostParams& p) {
  const float ci = fminf(fabsf(__fsub_rn(b.x, m.x)), p.tc);
  const float cg = fminf(fabsf(__fsub_rn(b.y, m.y)), p.tg);
  return __fadd_rn(__fmul_rn(p.wc, ci), __fmul_rn(p.wg, cg));
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x = __fadd_rn(a.x, v.x);
  a.y = __fadd_rn(a.y, v.y);
  a.z = __fadd_rn(a.z, v.z);
  a.w = __fadd_rn(a.w, v.w);
}

// kR / kD > 0: compile-time radius and disparities; 0: the runtime p.r / p.D.
// kVec: D % 4 == 0 and the output 16-byte aligned, so a position's four
// disparities go out as one float4.
template <int kR, int kD, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dense_cost_volumes_kernel(const CostParams p) {
  extern __shared__ __align__(16) float smem[];
  const int r = kR > 0 ? kR : p.r;
  const int D = kD > 0 ? kD : p.D;
  const int H = p.H, W = p.W;
  const int P = 2 * r + 1;
  const int R = kTH + 2 * r, C = kTW + 2 * r;  // staged rows and columns of costs
  const int CM = C + D - 1;                     // staged match columns
  const int RS = cost_row_stride(r);
  float* cost_s = smem;
  float2* base_s = reinterpret_cast<float2*>(smem + R * RS);  // [R][C]
  float2* match_s = base_s + R * C;                           // [R][CM]

  const int vol = blockIdx.z;  // 0: left-based, 1: right-based
  const float* __restrict__ base = vol == 0 ? p.left : p.right;
  const float* __restrict__ match = vol == 0 ? p.right : p.left;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int gy0 = y0 - r, gx0 = x0 - r;  // image position of staged cell (0, 0)
  // match column of staged cell column c at disparity d: c - d + (D - 1)
  // (left-based, from gx0 - (D - 1)) or c + d (right-based, from gx0)
  const int mx0 = vol == 0 ? gx0 - (D - 1) : gx0;
  const int tid = threadIdx.x;

  // the rows' intensity and x-gradient, each column wrapped mod W as the
  // rolls wrap; rows outside the image are never read
  for (int i = tid; i < R * (C + CM); i += kThreads) {
    const int row = i / (C + CM), j = i - row * (C + CM);
    const int gy = gy0 + row;
    float2 v = make_float2(0.0f, 0.0f);
    if (gy >= 0 && gy < H) {
      const bool is_base = j < C;
      const float* __restrict__ src = (is_base ? base : match) + static_cast<size_t>(gy) * W;
      const int gx = wrap(is_base ? gx0 + j : mx0 + (j - C), W);
      const float ip = __ldg(src + (gx + 1 == W ? 0 : gx + 1));
      const float im = __ldg(src + (gx == 0 ? W - 1 : gx - 1));
      v = make_float2(__ldg(src + gx), __fmul_rn(__fsub_rn(ip, im), 0.5f));
    }
    if (j < C) {
      base_s[row * C + j] = v;
    } else {
      match_s[row * CM + (j - C)] = v;
    }
  }

  // the thread's outputs in the sum: disparities 4q..4q+3 of the pass, tile
  // rows 2rg, 2rg + 1 and columns 4cg..4cg+3; the two threads of a quarter
  // warp with the same q and cg take neighbouring row pairs
  const int q = tid & 3;
  const int rg = ((tid >> 2) & 1) | ((tid >> 6) << 1);
  const int cg = (tid >> 3) & 7;
  const int dir = vol == 0 ? -1 : 1;
  const int moff = vol == 0 ? D - 1 : 0;
  const size_t HWD = static_cast<size_t>(H) * W * D;
  float* __restrict__ out = p.out + vol * HWD;

  for (int d0 = 0; d0 < D; d0 += kDC) {
    __syncthreads();  // the rows are staged; the last pass's sums are read
    // raw costs of the tile and its halo, zero outside the image
    for (int i = tid; i < R * C * (kDC / 4); i += kThreads) {
      const int qq = i & 3, cell = i >> 2;
      const int row = cell / C, col = cell - row * C;
      const int gy = gy0 + row, gx = gx0 + col;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float2 b = base_s[row * C + col];
        const float2* m = match_s + row * CM + col + moff;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int d = d0 + 4 * qq + k;
          if ((kD > 0 && kD % kDC == 0) || d < D) c[k] = raw_cost(b, m[dir * d], p);
        }
      }
      *reinterpret_cast<float4*>(cost_s + row * RS + col * kDC + 4 * qq) = make_float4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();

    // window sums: each staged float4 goes to every accumulator whose
    // window holds it, in window order (input rows, then columns, rising)
    float4 acc[kRB][kCB];
#pragma unroll
    for (int o = 0; o < kRB; ++o) {
#pragma unroll
      for (int c = 0; c < kCB; ++c) acc[o][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const float* tile = cost_s + (kRB * rg) * RS + (kCB * cg) * kDC + 4 * q;
#pragma unroll
    for (int ir = 0; ir < kRB + 2 * r; ++ir) {
#pragma unroll
      for (int ic = 0; ic < kCB + 2 * r; ++ic) {
        const float4 v = *reinterpret_cast<const float4*>(tile + ir * RS + ic * kDC);
#pragma unroll
        for (int o = 0; o < kRB; ++o) {
#pragma unroll
          for (int c = 0; c < kCB; ++c) {
            if (ir - o >= 0 && ir - o < P && ic - c >= 0 && ic - c < P) add4(acc[o][c], v);
          }
        }
      }
    }

    const int d = d0 + 4 * q;
#pragma unroll
    for (int o = 0; o < kRB; ++o) {
      const int y = y0 + kRB * rg + o;
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const int x = x0 + kCB * cg + c;
        if (y >= H || x >= W) continue;
        const float4 a = acc[o][c];
        const float4 v = make_float4(__fmul_rn(a.x, p.inv_area), __fmul_rn(a.y, p.inv_area),
                                     __fmul_rn(a.z, p.inv_area), __fmul_rn(a.w, p.inv_area));
        float* dst = out + (static_cast<size_t>(y) * W + x) * D + d;
        if (kVec) {
          if (d < D) *reinterpret_cast<float4*>(dst) = v;
        } else {
          if (d < D) dst[0] = v.x;
          if (d + 1 < D) dst[1] = v.y;
          if (d + 2 < D) dst[2] = v.z;
          if (d + 3 < D) dst[3] = v.w;
        }
      }
    }
  }
}

template <int kR, int kD, bool kVec>
int launch(const CostParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.r, p.D);
  auto kernel = dense_cost_volumes_kernel<kR, kD, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.W + kTW - 1) / kTW, (p.H + kTH - 1) / kTH, 2);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// left, right: (H, W) float32 grey images; out: (2, H, W, D) float32, the
// left-based volume then the right-based one.  inv_area: float32(1) /
// float32((2r+1)^2).  1 <= D <= 128, 0 <= r <= 7.
extern "C" int ssvo_dense_cost_volumes(const float* left, const float* right, int H, int W, int D, int r,
                                       float wc, float wg, float tc, float tg, float inv_area, float* out,
                                       cudaStream_t stream) {
  if (H < 1 || W < 1 || D < 1 || D > kMaxD || r < 0 || r > kMaxR ||
      2LL * H * W * D >= (1LL << 31) || (H + kTH - 1) / kTH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CostParams p{left, right, out, H, W, D, r, wc, wg, tc, tg, inv_area};
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (r == 3 && D == 48 && vec) return launch<3, 48, true>(p, stream);
  return vec ? launch<0, 0, true>(p, stream) : launch<0, 0, false>(p, stream);
}
