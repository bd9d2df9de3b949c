// Semi-global matching over (H, W, D) cost volumes: the four directional
// sweeps of up to four same-shape volumes in one launch, then their sum.
//
// Replaces: stereo_semantic_vo_tpu/kernels/sgm_scan.py:_directional (Pallas,
// TPU), reached through sgm_bidirectional / sgm_aggregate_pallas.  The
// contract is ops/dense_stereo.sgm_aggregate's plain body, bit for bit:
// out = ((h_fwd + h_bwd) + v_fwd) + v_bwd, each sweep
//   best = min(min(prev[d], prev_min + P2(s)), min(prev[d-1] + P1, prev[d+1] + P1))
//   out[d] = (c[d] + best) - prev_min
// with prev[-1] = prev[D] = 1e9 (the reference's sentinel), seeded with the
// raw cost at the first position of the sweep (the far end for a backward
// sweep).  Only min, add and subtract: the adds are __fadd_rn / __fsub_rn so
// nvcc cannot reorder or contract them, and min is exact in any order.
//
// Bound on the H100: memory, once the sweeps run side by side.  A
// horizontal sweep is W = 1241 dependent steps, a vertical one H = 376, and
// the sweeps do not depend on each other, so one launch runs all four
// directions of every volume it is given: at 376 x 1241 x 48 and two
// volumes that is 6,468 warps (one per scanline and direction), against
// 376 a launch when the directions ran one after another.  Each sweep
// writes its own scratch plane; a second, elementwise launch sums the four
// planes in the plain order.  An aggregation then moves about 13
// volume-sized planes (the volume read by four sweeps, four planes written,
// read again, the sum written).
//
// Nothing on a step's dependent chain waits on memory: the costs and P2 of
// the next kPF positions sit in a register ring loaded ahead, and a sweep
// writes but never reads its output.  prev_min is one redux.sync
// (__reduce_min_sync) on order-preserving uint32 keys of the floats.
// Layout: one warp per scanline, lane l holds d = 2l and 2l + 1 (D <= 64),
// so d - 1 and d + 1 cost one shuffle each and the rest stays in the lane;
// for even D a lane moves its pair as one float2.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPF = 12;  // positions loaded ahead
constexpr int kWarpsPerBlock = 4;
// at most 80 registers a thread: 24 sweep warps an SM, enough loads in
// flight to keep HBM near its rate (deeper rings with more registers, or
// shallower ones with more warps, ran no faster on the H100)
constexpr int kMinBlocksPerSM = 6;
constexpr int kMaxBatch = 4;
constexpr int kPlanes = 4;  // scratch planes a volume: h_fwd, h_bwd, v_fwd, v_bwd

struct SgmBatch {
  const float* vol[kMaxBatch];
  const float* p2h[kMaxBatch];  // per-position P2 of the horizontal sweeps, or null
  const float* p2v[kMaxBatch];  // of the vertical sweeps, or null
};

// float -> uint32 with the same order (negatives flipped whole, positives
// by their sign bit), and back; min over keys is min over floats
__device__ __forceinline__ unsigned min_key(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// One warp per (volume, direction, scanline), each writing its own scratch
// plane; warps of horizontal sweeps (the long ones) come first so they
// start first.  Direction 0/1: horizontal forward/backward, 2/3: vertical
// forward/backward.  kVec2: D is even, a lane moves its pair as one float2.
//
// The ring is written only by its loads and read only kPF steps later: a
// load that has a branch around it, or a value moved out of its register
// before it is used, makes nvcc wait for the load there, one memory round
// trip a step.  So every load is unconditional (lanes past D read a valid
// column, positions past the end the last one, a sweep without a P2 plane
// reads the volume), what it brings is selected where it is used, and a
// slot is refilled only after its values are consumed.
template <bool kVec2>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kMinBlocksPerSM)
sgm_sweeps_kernel(const SgmBatch b, int n_vol, int H, int W, int D, float p1, float p2,
                  float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int n_h = 2 * n_vol * H;
  int n, dir, line;
  if (g < n_h) {
    line = g % H;
    dir = (g / H) & 1;
    n = g / (2 * H);
  } else {
    g -= n_h;
    if (g >= 2 * n_vol * W) return;  // uniform across the warp
    line = g % W;
    dir = 2 + ((g / W) & 1);
    n = g / (2 * W);
  }
  const bool horizontal = dir < 2, reverse = dir & 1;
  // the volume's pointers, picked with static indices so the table stays
  // in the parameter bank
  const float* vol = b.vol[0];
  const float* p2x = horizontal ? b.p2h[0] : b.p2v[0];
#pragma unroll
  for (int k = 1; k < kMaxBatch; ++k) {
    if (n == k) {
      vol = b.vol[k];
      p2x = horizontal ? b.p2h[k] : b.p2v[k];
    }
  }
  const bool has_plane = p2x != nullptr;
  const float* __restrict__ pen_src = has_plane ? p2x : vol;  // any valid address without a plane
  const float* __restrict__ cost = vol;
  float* __restrict__ dst = scratch + (static_cast<size_t>(n) * kPlanes + dir) * (static_cast<size_t>(H) * W * D);

  const int S = horizontal ? W : H;
  // pixel of the i-th position visited: pix0 + i * pstep
  const int stride = horizontal ? 1 : W;
  const int first = horizontal ? line * W : line;
  const int pix0 = reverse ? first + (S - 1) * stride : first;
  const int pstep = reverse ? -stride : stride;
  const int d0 = 2 * lane, d1 = 2 * lane + 1;
  const bool v0 = d0 < D, v1 = d1 < D;
  // the lane's columns, clamped into the row (their values are unused)
  const int o0 = kVec2 ? (v0 ? d0 : 0) : min(d0, D - 1);
  const int o1 = min(d1, D - 1);
  const float inf = __int_as_float(0x7f800000);
  auto load = [&](int pix, float& a, float& c) {
    const float* q = cost + pix * D;
    if constexpr (kVec2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(q + o0));
      a = t.x;
      c = t.y;
    } else {
      a = __ldg(q + o0);
      c = __ldg(q + o1);
    }
  };
  auto store = [&](int pix, float a, float c) {
    float* q = dst + pix * D + d0;
    if constexpr (kVec2) {
      if (v0) *reinterpret_cast<float2*>(q) = make_float2(a, c);
    } else {
      if (v0) q[0] = a;
      if (v1) q[1] = c;
    }
  };

  // seed: the raw cost of the first position
  float prev0, prev1;
  load(pix0, prev0, prev1);
  prev0 = v0 ? prev0 : inf;
  prev1 = v1 ? prev1 : inf;
  store(pix0, prev0, prev1);

  // ring of the costs and P2 of the next kPF positions
  float r0[kPF], r1[kPF], rp[kPF];
#pragma unroll
  for (int j = 0; j < kPF; ++j) {
    const int pix = pix0 + min(1 + j, S - 1) * pstep;
    load(pix, r0[j], r1[j]);
    rp[j] = __ldg(pen_src + pix);
  }

  for (int base_i = 1; base_i < S; base_i += kPF) {
#pragma unroll
    for (int j = 0; j < kPF; ++j) {
      const int i = base_i + j;  // past S - 1 the step runs on but stores nothing
      const float c0 = r0[j], c1 = r1[j], pen = has_plane ? rp[j] : p2;
      const float pm = from_key(__reduce_min_sync(kFull, min(min_key(prev0), min_key(prev1))));
      const float up1 = __shfl_up_sync(kFull, prev1, 1);    // prev[d0 - 1], from lane - 1
      const float dn0 = __shfl_down_sync(kFull, prev0, 1);  // prev[d1 + 1], from lane + 1
      const float sm0 = lane == 0 ? kBig : up1;
      const float sp0 = d0 + 1 >= D ? kBig : prev1;
      const float sp1 = d1 + 1 >= D ? kBig : dn0;  // sm1 is prev0
      const float pen2 = __fadd_rn(pm, pen);
      const float best0 = fminf(fminf(prev0, pen2), fminf(__fadd_rn(sm0, p1), __fadd_rn(sp0, p1)));
      const float best1 = fminf(fminf(prev1, pen2), fminf(__fadd_rn(prev0, p1), __fadd_rn(sp1, p1)));
      prev0 = v0 ? __fsub_rn(__fadd_rn(c0, best0), pm) : inf;
      prev1 = v1 ? __fsub_rn(__fadd_rn(c1, best1), pm) : inf;
      if (i < S) store(pix0 + i * pstep, prev0, prev1);
      // refill the slot once its values are consumed, so the load lands in
      // the slot's own registers
      const int ahead = pix0 + min(i + kPF, S - 1) * pstep;
      load(ahead, r0[j], r1[j]);
      rp[j] = __ldg(pen_src + ahead);
    }
  }
}

// out[n] = ((h_fwd + h_bwd) + v_fwd) + v_bwd, elementwise; blockIdx.y is
// the volume.  V is float4 when the plane size is a multiple of 4.
template <typename V>
__global__ void sgm_sum_kernel(const float* __restrict__ scratch, size_t hwd, float* __restrict__ out) {
  constexpr int kLanes = sizeof(V) / sizeof(float);
  const size_t count = hwd / kLanes;
  const V* __restrict__ s = reinterpret_cast<const V*>(scratch + blockIdx.y * kPlanes * hwd);
  V* __restrict__ o = reinterpret_cast<V*>(out + blockIdx.y * hwd);
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    V a = s[e];
    const V hb = s[count + e], vf = s[2 * count + e], vb = s[3 * count + e];
    float* pa = reinterpret_cast<float*>(&a);
    const float* pb = reinterpret_cast<const float*>(&hb);
    const float* pc = reinterpret_cast<const float*>(&vf);
    const float* pd = reinterpret_cast<const float*>(&vb);
#pragma unroll
    for (int k = 0; k < kLanes; ++k) pa[k] = __fadd_rn(__fadd_rn(__fadd_rn(pa[k], pb[k]), pc[k]), pd[k]);
    o[e] = a;
  }
}

}  // namespace

// vols, p2h, p2v: n host arrays of device pointers (p2h / p2v entries may
// be null); scratch: n * 4 * H * W * D floats; out: n * H * W * D floats.
extern "C" int ssvo_sgm_aggregate(const float* const* vols, const float* const* p2h,
                                  const float* const* p2v, int n, int H, int W, int D, float p1,
                                  float p2, float* scratch, float* out, cudaStream_t stream) {
  if (n < 1 || n > kMaxBatch || D < 1 || D > 64 || H < 1 || W < 1 ||
      static_cast<long long>(H) * W * D >= (1LL << 31) || 2LL * n * (H + W) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SgmBatch b = {};
  bool aligned = true;
  for (int i = 0; i < n; ++i) {
    b.vol[i] = vols[i];
    b.p2h[i] = p2h[i];
    b.p2v[i] = p2v[i];
    aligned = aligned && reinterpret_cast<uintptr_t>(vols[i]) % sizeof(float2) == 0;
  }
  const int warps = 2 * n * (H + W);
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (D % 2 == 0 && aligned) {
    sgm_sweeps_kernel<true><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(b, n, H, W, D, p1, p2, scratch);
  } else {
    sgm_sweeps_kernel<false><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(b, n, H, W, D, p1, p2, scratch);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t hwd = static_cast<size_t>(H) * W * D;
  const int threads = 256;
  if (hwd % 4 == 0) {
    const size_t count = hwd / 4;
    const dim3 grid(static_cast<unsigned>(std::min<size_t>((count + threads - 1) / threads, 2048)), n);
    sgm_sum_kernel<float4><<<grid, threads, 0, stream>>>(scratch, hwd, out);
  } else {
    const dim3 grid(static_cast<unsigned>(std::min<size_t>((hwd + threads - 1) / threads, 2048)), n);
    sgm_sum_kernel<float><<<grid, threads, 0, stream>>>(scratch, hwd, out);
  }
  return static_cast<int>(cudaGetLastError());
}
