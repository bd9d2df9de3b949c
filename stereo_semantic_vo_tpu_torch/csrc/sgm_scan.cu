// Directional semi-global matching sweep over an (H, W, D) cost volume.
//
// Replaces: stereo_semantic_vo_tpu/kernels/sgm_scan.py:_directional (Pallas,
// TPU), reached through sgm_bidirectional / sgm_aggregate_pallas.  The
// contract is ops/dense_stereo.sgm_aggregate's plain body: the caller
// launches this kernel once per direction (horizontal forward, horizontal
// backward, vertical forward, vertical backward); the first launch writes
// the sweep, the later ones write acc + sweep, so the output is
// ((h_fwd + h_bwd) + v_fwd) + v_bwd in the plain version's order.  acc may
// alias out: each element is read and written by the same thread.
//
// One step of the recurrence at scan position s, for every disparity d:
//   best = min(min(prev[d], prev_min + P2(s)), min(prev[d-1] + P1, prev[d+1] + P1))
//   out[d] = (c[d] + best) - prev_min
// with prev[-1] = prev[D] = 1e9 (the reference's sentinel), seeded with the
// raw cost at the first position of the sweep (the far end for a backward
// sweep).  Only min, add and subtract: the adds are __fadd_rn / __fsub_rn so
// nvcc cannot reorder them, min is exact in any order, and the kernel agrees
// with the plain PyTorch version bit for bit.
//
// Layout: the volume stays (H, W, D).  At each step a horizontal sweep (row
// h, column s) and a vertical sweep (column w, row s) both read D contiguous
// floats.  One warp per scanline; lane l holds d = l and d = l + 32 (D <= 64).
// prev_min is an xor-shuffle butterfly, d-1 / d+1 are shuffles up and down
// that cross between the two registers at lanes 31 and 0.
//
// Bound on the H100: latency.  A sweep is W = 1241 (or H = 376) dependent
// steps of a few shuffles each, while the bytes (89.6 MB read, as much
// written, at 376 x 1241 x 48) would take ~55 us of HBM time.  The costs of
// the next PF positions are loaded ahead into a register ring, so a step
// waits on shuffles, not on memory.  Later work: several scanlines per warp
// and the four directions in fewer launches.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPF = 4;              // positions loaded ahead
constexpr int kWarpsPerBlock = 2;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void sgm_directional_kernel(const float* __restrict__ vol,
                                       const float* __restrict__ p2x, const float* acc,
                                       float* out, int H, int W, int D, int horizontal,
                                       int reverse, float p1, float p2) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int n_lines = horizontal ? H : W;
  if (line >= n_lines) return;  // uniform across the warp
  const int S = horizontal ? W : H;
  // pixel index of scan position s: line * W + s (horizontal), s * W + line (vertical)
  const size_t stride = horizontal ? 1 : static_cast<size_t>(W);
  const size_t first = horizontal ? static_cast<size_t>(line) * W : static_cast<size_t>(line);
  const int d0 = lane, d1 = lane + 32;
  const bool v0 = d0 < D, v1 = d1 < D;
  const float inf = __int_as_float(0x7f800000);

  auto pixel = [&](int i) -> size_t {  // i-th position visited by this sweep
    const int s = reverse ? S - 1 - i : i;
    return first + static_cast<size_t>(s) * stride;
  };
  auto store = [&](size_t pix, float o0, float o1) {
    const size_t base = pix * D;
    if (v0) out[base + d0] = acc ? __fadd_rn(acc[base + d0], o0) : o0;
    if (v1) out[base + d1] = acc ? __fadd_rn(acc[base + d1], o1) : o1;
  };

  // seed: the raw cost of the first position
  size_t pix = pixel(0);
  float prev0 = v0 ? vol[pix * D + d0] : inf;
  float prev1 = v1 ? vol[pix * D + d1] : inf;
  store(pix, prev0, prev1);

  // ring of the next kPF positions' costs and P2
  float r0[kPF], r1[kPF], rp[kPF];
#pragma unroll
  for (int j = 0; j < kPF; ++j) {
    const int i = 1 + j;
    if (i < S) {
      const size_t q = pixel(i);
      r0[j] = v0 ? vol[q * D + d0] : inf;
      r1[j] = v1 ? vol[q * D + d1] : inf;
      rp[j] = p2x ? p2x[q] : p2;
    }
  }

  for (int base_i = 1; base_i < S; base_i += kPF) {
#pragma unroll
    for (int j = 0; j < kPF; ++j) {
      const int i = base_i + j;
      if (i >= S) break;
      const float c0 = r0[j], c1 = r1[j], pen = rp[j];
      if (i + kPF < S) {
        const size_t q = pixel(i + kPF);
        r0[j] = v0 ? vol[q * D + d0] : inf;
        r1[j] = v1 ? vol[q * D + d1] : inf;
        rp[j] = p2x ? p2x[q] : p2;
      }
      const float pm = warp_min(fminf(prev0, prev1));
      // prev[d - 1]
      const float up0 = __shfl_up_sync(kFull, prev0, 1);
      const float up1 = __shfl_up_sync(kFull, prev1, 1);
      const float last0 = __shfl_sync(kFull, prev0, 31);
      const float sm0 = lane == 0 ? kBig : up0;
      const float sm1 = lane == 0 ? last0 : up1;
      // prev[d + 1]
      const float dn0 = __shfl_down_sync(kFull, prev0, 1);
      const float dn1 = __shfl_down_sync(kFull, prev1, 1);
      const float first1 = __shfl_sync(kFull, prev1, 0);
      const float sp0 = d0 + 1 >= D ? kBig : (lane == 31 ? first1 : dn0);
      const float sp1 = d1 + 1 >= D ? kBig : dn1;

      const float pen2 = __fadd_rn(pm, pen);
      const float best0 = fminf(fminf(prev0, pen2), fminf(__fadd_rn(sm0, p1), __fadd_rn(sp0, p1)));
      const float best1 = fminf(fminf(prev1, pen2), fminf(__fadd_rn(sm1, p1), __fadd_rn(sp1, p1)));
      prev0 = v0 ? __fsub_rn(__fadd_rn(c0, best0), pm) : inf;
      prev1 = v1 ? __fsub_rn(__fadd_rn(c1, best1), pm) : inf;
      store(pixel(i), prev0, prev1);
    }
  }
}

}  // namespace

extern "C" int ssvo_sgm_directional(const float* vol, const float* p2x, const float* acc,
                                    float* out, int H, int W, int D, int horizontal, int reverse,
                                    float p1, float p2, cudaStream_t stream) {
  const int n_lines = horizontal ? H : W;
  if (n_lines > 0 && (horizontal ? W : H) > 0) {
    const int blocks = (n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sgm_directional_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
        vol, p2x, acc, out, H, W, D, horizontal, reverse, p1, p2);
  }
  return static_cast<int>(cudaGetLastError());
}
