// Per-keypoint sparse stereo: window costs, and the whole disparity step.
//
// Replaces: stereo_semantic_vo_tpu/kernels/sparse_stereo.py:keypoint_stereo_costs
// (Pallas, TPU) and, fused behind it, the epilogue its caller runs
// (stereo_semantic_vo_tpu/ops/stereo.py:sparse_disparity: flip, the
// addressable mask, argmin, uniqueness, the equiangular sub-pixel step, the
// validity gates and the depth).
//
// One kernel, two modes (a template flag):
// - raw, the TPU kernel's contract: (K,) pre-clamped window origins in,
//   (K, D) costs out in strip order (strip offset s <-> disparity d = D-1-s);
// - fused: (K, 2) keypoints in; the origins are computed here (round half to
//   even, then the caller's clamps), and (3, K) disparity / depth / cost plus
//   (K,) valid come out, StereoMatch's fields.
// Each cost is the sum over a P x P window (P = 2r+1) of
//   wc * min(|L - R|, tc) + wg * min(|dL/dx - dR/dx|, tg)
// with the x-gradient (I[x+1] - I[x-1]) * 0.5 read at columns (x +- 1) mod W,
// the wrap of the reference's jnp.roll.
//
// Exactness: each term uses the plain PyTorch version's float32 operations,
// in round-to-nearest intrinsics so nvcc cannot contract them into FMAs, and
// the 49 terms are summed in the plain version's order (window row, then
// column); the epilogue's min, compares and selects are exact, and its
// subtract, multiply and the two divisions are the IEEE-rounded _rn forms.
// Kernel and plain version therefore agree bit for bit on all outputs.
//
// Bound on the H100: launch latency.  A frame reads ~1 MB (the union of the
// K=512 windows and strips) and does K * D * P * P * 10 flops (~12 MFLOP):
// both are well under a microsecond.  Design: one warp per keypoint, which
// stages its left window and right strip (one gradient column either side)
// in its own slice of shared memory, neighbouring lanes on neighbouring
// columns, so only __syncwarp orders the staging and the sums.  In the fused
// mode the origins are clamped into the image, so only the gradient halo
// can leave it (column -1 at x = 0, column W at the right edge) and the wrap
// is two selects, no modulo.  A lane sums the windows of strip offsets lane
// and lane + 32; the shapes of kitti() (r=3, D=48) are compile-time, so the
// 7 x 7 loop unrolls into shared loads at fixed offsets.  The epilogue
// stays in the warp: argmin (first minimum, the lowest d on ties) and the
// runner-up by shuffle reductions, the two neighbours of the minimum by
// shuffles from the lanes that own them; lane 0 writes the keypoint.
// Other (r, D) run a runtime-shape instantiation of the same kernel.
// Nothing is uploaded and nothing synchronises (capture-safe): the scalars
// go by value, bf is read through its device pointer.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;     // keypoints (warps) per block
constexpr int kMaxSlots = 8;  // strip offsets a lane holds at most: D <= 256

struct StereoParams {
  const float* left;
  const float* right;
  int H, W, K, D, r;
  float wc, wg, tc, tg;
  // raw mode: the origins
  const int* y0;
  const int* xl0;
  const int* xr0;
  float* costs;  // (K, D)
  // fused mode: the keypoints, the gates, the outputs
  const float* uv;
  const bool* kp_valid;
  const float* bf;
  float uniqueness_ratio, min_disparity, max_cost;
  float* out;    // (3, K): disparity, depth, cost
  bool* valid;   // (K,)
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

template <int kR, int kD, bool kFused>
__global__ void __launch_bounds__(kWarps * 32) keypoint_stereo_kernel(const StereoParams p) {
  extern __shared__ float smem[];
  constexpr int kSlots = kD > 0 ? (kD + 31) / 32 : kMaxSlots;
  const int r = kR > 0 ? kR : p.r;
  const int D = kD > 0 ? kD : p.D;
  const int P = 2 * r + 1;
  const int Ws = D + 2 * r;
  const int LW = P + 2;   // left window plus one gradient column each side
  const int RW = Ws + 2;  // right strip plus one gradient column each side
  const int H = p.H, W = p.W;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= p.K) return;  // the whole warp: no block barrier follows
  float* Ls = smem + warp * P * (LW + RW);  // P x LW raw left,  columns xl0-1 .. xl0+P
  float* Rs = Ls + P * LW;                  // P x RW raw right, columns xr0-1 .. xr0+Ws

  int y0, xl, xr, shift = 0;
  if (kFused) {
    const int x = __float2int_rn(p.uv[2 * k]);  // round half to even, as torch.round
    const int y = __float2int_rn(p.uv[2 * k + 1]);
    y0 = clampi(y - r, 0, H - P);
    xl = clampi(x - r, 0, W - P);
    const int xr_raw = x - (D - 1) - r;
    xr = clampi(xr_raw, 0, W - Ws);
    shift = xr - xr_raw;  // > 0 where clamped at the left edge
  } else {
    y0 = clampi(p.y0[k], 0, H - P);
    xl = p.xl0[k];
    xr = p.xr0[k];
  }
  // columns: in the fused mode only -1 and W leave the image; the raw
  // contract takes any origin and wraps it as the plain version's % W
  auto col = [W](int c) {
    if (kFused) return c < 0 ? c + W : (c >= W ? c - W : c);
    c %= W;
    return c < 0 ? c + W : c;
  };
  for (int i = lane; i < P * LW; i += 32) {
    const int row = i / LW;
    Ls[i] = p.left[static_cast<size_t>(y0 + row) * W + col(xl - 1 + i - row * LW)];
  }
  for (int i = lane; i < P * RW; i += 32) {
    const int row = i / RW;
    Rs[i] = p.right[static_cast<size_t>(y0 + row) * W + col(xr - 1 + i - row * RW)];
  }
  __syncwarp();

  // a lane's strip offsets s = lane + 32 j; a lane past D reads offset D-1
  // and drops the result
  float acc[kSlots];
  int base[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    acc[j] = 0.0f;
    base[j] = min(lane + 32 * j, D - 1);
  }
  const float wc = p.wc, wg = p.wg, tc = p.tc, tg = p.tg;
#pragma unroll
  for (int wy = 0; wy < P; ++wy) {
    const float* lrow = Ls + wy * LW;
    const float* rrow = Rs + wy * RW;
#pragma unroll
    for (int wx = 0; wx < P; ++wx) {
      const float lp = lrow[wx + 1];
      const float lg = __fmul_rn(__fsub_rn(lrow[wx + 2], lrow[wx]), 0.5f);
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (32 * j < D) {  // uniform across the warp
          const float* rr = rrow + base[j] + wx;
          const float rg = __fmul_rn(__fsub_rn(rr[2], rr[0]), 0.5f);
          const float ci = fminf(fabsf(__fsub_rn(lp, rr[1])), tc);
          const float cg = fminf(fabsf(__fsub_rn(lg, rg)), tg);
          acc[j] = __fadd_rn(acc[j], __fadd_rn(__fmul_rn(wc, ci), __fmul_rn(wg, cg)));
        }
      }
    }
  }

  if (!kFused) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = lane + 32 * j;
      if (s < D) p.costs[static_cast<size_t>(k) * D + s] = acc[j];
    }
    return;
  }

  // the epilogue, in disparity order d = D-1-s: unaddressable offsets
  // (s < shift) cost 1e9; offsets past D take no part
  constexpr unsigned kAll = 0xFFFFFFFFu;
  float c[kSlots];
  int d[kSlots];
  float bc = INFINITY;
  int bd = INT_MAX;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = lane + 32 * j;
    c[j] = s < D ? (s >= shift ? acc[j] : 1e9f) : INFINITY;
    d[j] = s < D ? D - 1 - s : INT_MAX;
    if (c[j] < bc || (c[j] == bc && d[j] < bd)) {
      bc = c[j];
      bd = d[j];
    }
  }
  // argmin: the first minimum, the lowest d on ties
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float oc = __shfl_xor_sync(kAll, bc, m);
    const int od = __shfl_xor_sync(kAll, bd, m);
    if (oc < bc || (oc == bc && od < bd)) {
      bc = oc;
      bd = od;
    }
  }
  const float c0 = bc;
  const int best = bd;
  // the runner-up, the +-1 neighbours excluded (1e9 where none is left)
  float c1 = 1e9f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (d[j] != INT_MAX && abs(d[j] - best) > 1) c1 = fminf(c1, c[j]);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) c1 = fminf(c1, __shfl_xor_sync(kAll, c1, m));
  // the costs at clamp(best -+ 1), from the lanes that hold them
  const int sm = D - 1 - max(best - 1, 0);
  const int sp = D - 1 - min(best + 1, D - 1);
  float cm = 0.0f, cp = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (32 * j < D) {  // uniform across the warp
      const float a = __shfl_sync(kAll, c[j], sm & 31);
      const float b = __shfl_sync(kAll, c[j], sp & 31);
      if ((sm >> 5) == j) cm = a;
      if ((sp >> 5) == j) cp = b;
    }
  }
  if (lane != 0) return;
  const bool unique = c0 < __fmul_rn(p.uniqueness_ratio, c1);
  const float denom = __fmul_rn(2.0f, __fsub_rn(fmaxf(cm, cp), c0));
  const float delta = denom > 1e-6f ? __fdiv_rn(__fsub_rn(cm, cp), denom) : 0.0f;
  const float disp = __fadd_rn(static_cast<float>(best), fminf(fmaxf(delta, -0.5f), 0.5f));
  const bool ok = p.kp_valid[k] && unique && disp > p.min_disparity && best > 0 && best < D - 1 &&
                  c0 < p.max_cost;
  p.out[k] = ok ? disp : -1.0f;
  p.out[p.K + k] = ok ? __fdiv_rn(*p.bf, disp) : 0.0f;
  p.out[2 * p.K + k] = c0;
  p.valid[k] = ok;
}

template <bool kFused>
int launch(const StereoParams& p, cudaStream_t stream) {
  const int P = 2 * p.r + 1;
  const size_t per_warp = sizeof(float) * P * ((P + 2) + (p.D + 2 * p.r + 2));
  if (p.D < 1 || p.D > 32 * kMaxSlots || p.r < 0 || kWarps * per_warp > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.K > 0) {
    const dim3 grid((p.K + kWarps - 1) / kWarps);
    const size_t smem = kWarps * per_warp;
    if (p.r == 3 && p.D == 48) {
      keypoint_stereo_kernel<3, 48, kFused><<<grid, kWarps * 32, smem, stream>>>(p);
    } else {
      keypoint_stereo_kernel<0, 0, kFused><<<grid, kWarps * 32, smem, stream>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The TPU kernel's contract: (K,) int32 origins -> (K, D) float32 costs.
extern "C" int ssvo_keypoint_stereo_costs(const float* left, const float* right, int H, int W,
                                          const int* y0, const int* xl0, const int* xr0, int K,
                                          int D, int r, float wc, float wg, float tc, float tg,
                                          float* out, cudaStream_t stream) {
  StereoParams p{};
  p.left = left;
  p.right = right;
  p.H = H;
  p.W = W;
  p.K = K;
  p.D = D;
  p.r = r;
  p.wc = wc;
  p.wg = wg;
  p.tc = tc;
  p.tg = tg;
  p.y0 = y0;
  p.xl0 = xl0;
  p.xr0 = xr0;
  p.costs = out;
  return launch<false>(p, stream);
}

// The disparity step: (K, 2) float32 keypoints, (K,) bool validity and the
// 0-d float32 bf on the device -> out (3, K) float32 disparity / depth /
// cost and valid (K,) bool.  W >= D + 2r and H >= 2r + 1.
extern "C" int ssvo_keypoint_disparity(const float* left, const float* right, int H, int W,
                                       const float* uv, const bool* kp_valid, const float* bf,
                                       int K, int D, int r, float wc, float wg, float tc,
                                       float tg, float uniqueness_ratio, float min_disparity,
                                       float max_cost, float* out, bool* valid,
                                       cudaStream_t stream) {
  if (W < D + 2 * r || H < 2 * r + 1) return static_cast<int>(cudaErrorInvalidValue);
  StereoParams p{};
  p.left = left;
  p.right = right;
  p.H = H;
  p.W = W;
  p.K = K;
  p.D = D;
  p.r = r;
  p.wc = wc;
  p.wg = wg;
  p.tc = tc;
  p.tg = tg;
  p.uv = uv;
  p.kp_valid = kp_valid;
  p.bf = bf;
  p.uniqueness_ratio = uniqueness_ratio;
  p.min_disparity = min_disparity;
  p.max_cost = max_cost;
  p.out = out;
  p.valid = valid;
  return launch<true>(p, stream);
}
