// Bundle-adjustment normal-equation builds: the motion-only build (B5) and
// the local-BA block build (B7).  Both run inside an LM loop that calls them
// with the same loop-invariant operands every step, so each is one launch,
// and its wrapper (kernels/ba_hessian.py) binds those operands once per loop.
//
// --- Motion-only build -----------------------------------------------------
//
// Replaces: stereo_semantic_vo_tpu/kernels/ba_hessian.py:motion_hessian_gradient
// (Pallas, TPU).  Same contract: pose T_cw (4, 4), world points Xt (3, K),
// observations uvt (2, K) and mask (1, K) (float {0, 1}) give the 6x6
// Gauss-Newton Hessian H, the gradient g (6) and the Huber cost of mono
// motion-only BA for the left update T <- exp(xi) T, with the analytic 2x6
// Jacobian and IRLS weight mask * (z > 0.05) * huber(r).  The intrinsics
// [fx, fy, cx, cy] come as a (4,) device buffer, stacked once per
// motion_only_ba call, so the LM loop reads nothing back.
//
// Design: one block of 512 threads strides over the K observations; each thread keeps its
// 28 partial sums (21 upper-triangle H, 6 g, 1 cost), padded to 32, in
// registers.  A warp reduce-scatter (16 + 8 + 4 + 2 + 1 = 31 shuffles) leaves
// lane q with the warp's sum of entry q; through shared memory, the 16 lanes
// of a half-warp then add an entry's 16 warp sums in a fixed tree.  The order is
// fixed, so two runs agree bit for bit.
// H, g and cost land in one 43-float buffer that the wrapper returns views of.
//
// Bound on the H100: launch latency.  At K = 512 the build reads 12 KB and
// does ~120 kFLOP, 0.004 us of HBM or ALU time, which no launch can reach;
// the aim is the launch floor, one block on one SM.  Measured on an H100
// 80GB HBM3 at 700 W (tools/ba_launch_times.py): 2.8 us on the device at 512
// threads, against 3.0 us for the earlier 256-thread design with 28 warp
// trees a warp (256 threads read 3.2 us and 128 read 4.5 us, PERF.md).  The TPU kernel's point, that
// the (K, 2, 6) Jacobian never reaches memory, holds here too.
//
// --- Local-BA block build --------------------------------------------------
//
// Replaces: stereo_semantic_vo_tpu/kernels/ba_hessian.py:local_ba_blocks
// (Pallas, TPU).  Same contract as ops/local_ba.build_normal_equations: F
// poses (F, 4, 4) and L landmarks (L, 3) with observations obs_uv (F, L, 2)
// and mask (F, L) (bool), optionally a stereo row u_R = u - bf / z with
// obs_ur (F, L) and its validity (F, L) (bool), give
//   Hcc (F, 6, 6), Hcp (F, L, 6, 3), Hpp (L, 3, 3), gc (F, 6), gp (L, 3), cost
// under Huber IRLS weights, all in one output buffer in that order.  The
// formulas are the Pallas kernel's: the analytic 2x6 (or 3x6) pose Jacobian
// for the left update T <- exp(xi) T and the landmark Jacobian d(uv)/d(pc) R.
// Layouts are the natural ones, not the TPU's transposed (3, L) / (F, 2, L);
// any F >= 1 and L >= 0 are taken.
//
// Design: one launch, a thread per (frame, landmark) observation.  A block
// takes 64 landmarks (two tiles of 32) and all F frames, a warp a (frame,
// 32 landmarks), up to 4 frames a round.  Per round:
//   - a warp reduce-scatter sums the pose entries (21 Hcc, 6 gc, the cost;
//     padded to 32) over the warp's landmarks, the block adds its warps of a
//     frame in order and writes the block's partial for that frame;
//   - each lane's 18 Hcp entries are staged in shared memory and the warp
//     stores its 32 x 18 contiguous floats with 16-byte stores;
//   - each landmark's 6 Hpp and 3 gp entries are added over the round's
//     frames in frame order through shared memory.
// Then the block publishes its partials (__threadfence, an atomic ticket)
// and stores its last Hcp, Hpp and gp while the ticket is in flight.  The
// last block to take a ticket sums the partials in block order into Hcc, gc
// and the cost, with its spare threads splitting the blocks into runs summed
// in order, and resets the ticket to 0 for the next launch.  The partials
// and the ticket live in one zeroed buffer the wrapper makes once per LM
// loop, so a build is one launch with nothing staged and is safe to capture
// in a CUDA graph.  Every sum has a fixed order, so two runs agree bit for
// bit.
//
// Bound on the H100: launch latency.  At F = 4, L = 2048 the build reads
// ~140 KB (the masks as bytes), writes ~690 KB (Hcp is 4 x 2048 x 18
// floats) and does ~5 MFLOP, 0.25 us at the HBM rate.  Measured on an H100 80GB HBM3 at 700 W
// (tools/ba_launch_times.py): 6.3 us on the device at 64 landmarks a block
// (32 blocks), against 14.5 us for the earlier design's two launches (a
// thread a landmark walking the frames, then a one-block finalize); 32 and
// 128 landmarks a block read 6.6 and 8.1 us (PERF.md).  Later work: fuse the
// Schur complement's per-landmark Hpp^-1 products into the same pass.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPoseEntries = 28;   // 21 upper-triangle Hcc (or H), 6 gc (or g), 1 cost
constexpr int kPointEntries = 9;   // 6 upper-triangle Hpp, 3 gp
constexpr int kHcpEntries = 18;    // a 6x3 coupling block
constexpr int kTiles = 2;         // 32-landmark tiles a local-BA block takes: 64 landmarks
constexpr int kMaxGroups = 4;     // frames a local-BA block takes at once
constexpr int kMotionWarps = 16;  // the motion build's one block: 512 threads
constexpr int kFinalBatch = 16;   // partial loads a thread keeps in flight

// One step of the reduce-scatter below: lanes O apart swap halves of the
// HALF values they hold; each keeps the half its bit O selects, summed.
template <int O, int HALF>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
  if constexpr (O > 1) reduce_scatter_step<O / 2, HALF / 2>(v, lane);
}

// Reduce-scatter of 32 values over a warp: each step halves what a lane
// holds and exchanges the other half with its partner, 16 + 8 + 4 + 2 + 1 =
// 31 shuffles; lane q then holds in v[0] the warp's sum of entry q.  Every
// index is a compile-time constant, so v stays in registers.
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_step<16, 16>(v, lane);
}

// (a, b), a <= b, of the k-th upper-triangle entry of a 6x6 matrix, row-major
__device__ __forceinline__ void upper_entry(int k, int& a, int& b) {
  a = 0;
  while (k >= 6 - a) {
    k -= 6 - a;
    ++a;
  }
  b = a + k;
}

// index of (a, b) among the 6 upper-triangle entries of a 3x3 matrix
__device__ __forceinline__ int upper3(int a, int b) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return lo * 3 - lo * (lo - 1) / 2 + (hi - lo);
}

// The warp stores n floats from shared memory to dst (4-byte aligned): a
// head of up to 3 scalars to the first 16-byte boundary, 16-byte stores,
// then a scalar tail.
__device__ __forceinline__ void warp_store(float* dst, const float* src, int n, int lane) {
  int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) >> 2);
  head = head < n ? head : n;
  if (lane < head) dst[lane] = src[lane];
  const int n4 = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = lane; i < n4; i += 32) {
    const float* s = src + head + 4 * i;
    d4[i] = make_float4(s[0], s[1], s[2], s[3]);
  }
  const int tail = head + 4 * n4 + lane;
  if (tail < n) dst[tail] = src[tail];
}

__global__ void __launch_bounds__(kMotionWarps * 32)
motion_hessian_kernel(const float* __restrict__ T, const float* __restrict__ Xt,
                      const float* __restrict__ uvt, const float* __restrict__ mask,
                      const float* __restrict__ intr, int K, float delta, float* __restrict__ out) {
  __shared__ float red[kMotionWarps][kPoseEntries];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float R[3][3], t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) R[a][b] = T[4 * a + b];
    t[a] = T[4 * a + 3];
  }
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  float e[32] = {};
  for (int k = threadIdx.x; k < K; k += kMotionWarps * 32) {
    const float xw = Xt[k], yw = Xt[K + k], zw = Xt[2 * K + k];
    const float px = R[0][0] * xw + R[0][1] * yw + R[0][2] * zw + t[0];
    const float py = R[1][0] * xw + R[1][1] * yw + R[1][2] * zw + t[1];
    const float pz = R[2][0] * xw + R[2][1] * yw + R[2][2] * zw + t[2];
    const float zs = fabsf(pz) > 1e-6f ? pz : 1e-6f;
    const float iz = 1.0f / zs;
    const float iz2 = iz * iz;
    const float ru = fx * px * iz + cx - uvt[k];
    const float rv = fy * py * iz + cy - uvt[K + k];
    const float mpos = pz > 0.05f ? mask[k] : 0.f;
    // Huber IRLS weight and robust cost (ops/ba.huber_weights)
    const float r2 = ru * ru + rv * rv;
    const float r = sqrtf(fmaxf(r2, 1e-12f));
    const float w = mpos * (r <= delta ? 1.0f : delta / r);
    const float Ju[6] = {fx * iz, 0.f, -fx * px * iz2, -fx * px * py * iz2,
                         fx * (1.0f + px * px * iz2), -fx * py * iz};
    const float Jv[6] = {0.f, fy * iz, -fy * py * iz2, -fy * (1.0f + py * py * iz2),
                         fy * px * py * iz2, fy * px * iz};
    int q = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) e[q++] += w * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) e[21 + a] += w * (Ju[a] * ru + Jv[a] * rv);
    e[27] += mpos * (r2 <= delta * delta ? r2 : 2.0f * delta * r - delta * delta);
  }
  reduce_scatter(e, lane);  // lane q: the warp's sum of entry q
  if (lane < kPoseEntries) red[warp][lane] = e[0];
  __syncthreads();
  // entry q's 16 warp sums on the 16 lanes of a half-warp, added in a fixed
  // tree of 4 shuffles; 14 whole warps take the 28 entries
  static_assert(kMotionWarps == 16, "a half-warp takes an entry's warp sums");
  const int q = threadIdx.x >> 4, wi = threadIdx.x & 15;
  if (q < kPoseEntries) {
    float s = red[wi][q];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (wi == 0 && q < 21) {
      int a, b;
      upper_entry(q, a, b);
      out[6 * a + b] = s;
      out[6 * b + a] = s;
    } else if (wi == 0) {
      out[36 + (q - 21)] = s;  // g, then the cost at out[42]
    }
  }
}

// dynamic shared memory of a local-BA block of W warps over F frames
// (floats): the staged Hcp blocks, each thread's Hpp / gp terms, the
// landmarks' sums, the warps' pose sums, the frames' costs
constexpr size_t local_smem_floats(int W, int F) {
  return static_cast<size_t>(W) * 32 * (kHcpEntries + kPointEntries + 1) + kTiles * 32 * kPointEntries + F;
}

// sum of p[b * E] over blocks b in [lo, hi), in block order, kFinalBatch
// loads in flight
__device__ __forceinline__ float sum_blocks(const float* p, size_t E, unsigned lo, unsigned hi) {
  float s = 0.f;
  for (unsigned b0 = lo; b0 < hi; b0 += kFinalBatch) {
    float v[kFinalBatch];
#pragma unroll
    for (int j = 0; j < kFinalBatch; ++j)
      if (b0 + j < hi) v[j] = __ldcg(p + (b0 + j) * E);
#pragma unroll
    for (int j = 0; j < kFinalBatch; ++j)
      if (b0 + j < hi) s += v[j];
  }
  return s;
}

__global__ void __launch_bounds__(kTiles * kMaxGroups * 32)
local_ba_blocks_kernel(const float* __restrict__ poses, const float* __restrict__ X,
                       const float2* __restrict__ obs, const uint8_t* __restrict__ mask,
                       const float* __restrict__ ur, const uint8_t* __restrict__ urm,
                       const float* __restrict__ intr, int F, int L, float delta,
                       float* __restrict__ Hcc, float* __restrict__ Hcp, float* __restrict__ Hpp,
                       float* __restrict__ gc, float* __restrict__ gp, float* __restrict__ cost,
                       float* __restrict__ partial, unsigned int* __restrict__ ticket) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int groups = n_warps / kTiles;  // frames a round takes
  const int lt = warp / groups, g = warp % groups;
  const int l0 = blockIdx.x * kTiles * 32;  // the block's first landmark
  const int lw = l0 + 32 * lt;              // the warp's
  const int l = lw + lane;
  const int n_block = L - l0 < kTiles * 32 ? L - l0 : kTiles * 32;
  const int n_warp = L - lw < 0 ? 0 : (L - lw < 32 ? L - lw : 32);
  const bool live_l = l < L;
  const bool stereo = ur != nullptr;
  const size_t E = static_cast<size_t>(F) * kPoseEntries;  // a block's partials: 28 a frame
  float* s_hcp = smem;                                      // [warp][lane][18]
  float* s_pt = s_hcp + n_warps * 32 * kHcpEntries;         // [warp][lane][9]
  float* s_acc = s_pt + n_warps * 32 * kPointEntries;       // [tile][lane][9]
  float* s_pose = s_acc + kTiles * 32 * kPointEntries;      // [warp][entry]
  float* s_cost = s_pose + n_warps * 32;                    // [frame], the last block's
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3], bf = intr[4];
  const float xw = live_l ? X[3 * l + 0] : 0.f;
  const float yw = live_l ? X[3 * l + 1] : 0.f;
  const float zw = live_l ? X[3 * l + 2] : 0.f;
  for (int i = tid; i < kTiles * 32 * kPointEntries; i += blockDim.x) s_acc[i] = 0.f;
  const int f_last = (F - 1) / groups * groups;  // the last round's first frame
  // the warp's 32 x 18 Hcp floats of frame f, staged in s_hcp, stored contiguously
  auto store_hcp = [&](int f) {
    if (f < F && n_warp > 0)
      warp_store(Hcp + (static_cast<size_t>(f) * L + lw) * kHcpEntries, s_hcp + warp * 32 * kHcpEntries,
                 n_warp * kHcpEntries, lane);
  };

  for (int f0 = 0; f0 < F; f0 += groups) {
    const int f = f0 + g;
    const bool live_f = f < F;
    const bool live = live_l && live_f;
    const float* Tf = poses + 16 * (live_f ? f : 0);
    float R[3][3], t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) R[a][b] = Tf[4 * a + b];
      t[a] = Tf[4 * a + 3];
    }
    const float px = R[0][0] * xw + R[0][1] * yw + R[0][2] * zw + t[0];
    const float py = R[1][0] * xw + R[1][1] * yw + R[1][2] * zw + t[1];
    const float pz = R[2][0] * xw + R[2][1] * yw + R[2][2] * zw + t[2];
    const float zs = fabsf(pz) > 1e-6f ? pz : 1e-6f;
    const float iz = 1.0f / zs;
    const float iz2 = iz * iz;
    const float u = fx * px * iz + cx;
    const float v = fy * py * iz + cy;
    const size_t o = static_cast<size_t>(live_f ? f : 0) * L + l;
    const float2 uv = live ? obs[o] : make_float2(0.f, 0.f);
    const float ru = live ? u - uv.x : 0.f;
    const float rv = live ? v - uv.y : 0.f;
    const float mpos = live && pz > 0.05f && mask[o] ? 1.f : 0.f;
    float wr = 0.f, rs = 0.f;
    float r2 = ru * ru + rv * rv;
    if (stereo) {
      wr = live && urm[o] ? 1.f : 0.f;
      rs = live ? (u - bf * iz - ur[o]) * wr : 0.f;
      r2 += rs * rs;
    }
    // Huber IRLS weight and robust cost (ops/ba.huber_weights)
    const float r = sqrtf(fmaxf(r2, 1e-12f));
    const float w = mpos * (r <= delta ? 1.0f : delta / r);
    const float rho = mpos * (r2 <= delta * delta ? r2 : 2.0f * delta * r - delta * delta);

    const float Ju[6] = {fx * iz, 0.f, -fx * px * iz2, -fx * px * py * iz2,
                         fx * (1.0f + px * px * iz2), -fx * py * iz};
    const float Jv[6] = {0.f, fy * iz, -fy * py * iz2, -fy * (1.0f + py * py * iz2),
                         fy * px * py * iz2, fy * px * iz};
    float Jpu[3], Jpv[3], Js[6], Jps[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      Jpu[b] = fx * iz * R[0][b] - fx * px * iz2 * R[2][b];
      Jpv[b] = fy * iz * R[1][b] - fy * py * iz2 * R[2][b];
    }
    // stereo row: d(u_R)/d(pc) adds bf / z^2 * dz/d(pc); zero without it
    const float b2 = bf * iz2;
    Js[0] = Ju[0] * wr;
    Js[1] = Ju[1] * wr;
    Js[2] = (Ju[2] + b2) * wr;
    Js[3] = (Ju[3] + b2 * py) * wr;
    Js[4] = (Ju[4] - b2 * px) * wr;
    Js[5] = Ju[5] * wr;
#pragma unroll
    for (int b = 0; b < 3; ++b) Jps[b] = (Jpu[b] + b2 * R[2][b]) * wr;

    // this observation's Hcp block, staged for the warp's coalesced store
    float* hcp = s_hcp + tid * kHcpEntries;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) hcp[3 * a + b] = w * (Ju[a] * Jpu[b] + Jv[a] * Jpv[b] + Js[a] * Jps[b]);
    }
    // its Hpp (upper triangle) and gp, summed over the frames below
    float* pt = s_pt + tid * kPointEntries;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = a; b < 3; ++b) pt[k++] = w * (Jpu[a] * Jpu[b] + Jpv[a] * Jpv[b] + Jps[a] * Jps[b]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) pt[6 + a] = w * (Jpu[a] * ru + Jpv[a] * rv + Jps[a] * rs);

    // its pose-block entries, summed over the warp's 32 landmarks
    float e[32];
    k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) e[k++] = w * (Ju[a] * Ju[b] + Jv[a] * Jv[b] + Js[a] * Js[b]);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) e[21 + a] = w * (Ju[a] * ru + Jv[a] * rv + Js[a] * rs);
    e[27] = rho;
    e[28] = e[29] = e[30] = e[31] = 0.f;
    reduce_scatter(e, lane);
    s_pose[tid] = e[0];

    __syncwarp();
    if (f0 != f_last) store_hcp(f);  // the last round's waits for the ticket below
    __syncthreads();
    // the block's partial of each frame of the round: its tiles in order
    for (int i = tid; i < groups * kPoseEntries; i += blockDim.x) {
      const int gg = i / kPoseEntries, q = i % kPoseEntries;
      if (f0 + gg < F) {
        float s = 0.f;
        for (int k2 = 0; k2 < kTiles; ++k2) s += s_pose[(k2 * groups + gg) * 32 + q];
        partial[blockIdx.x * E + static_cast<size_t>(f0 + gg) * kPoseEntries + q] = s;
      }
    }
    // each landmark's Hpp and gp: the round's frames in order
    for (int i = tid; i < kTiles * 32 * kPointEntries; i += blockDim.x) {
      const int lm = i / kPointEntries, q = i % kPointEntries;
      const int k2 = lm / 32, ln = lm % 32;
      float s = s_acc[i];
      for (int gg = 0; gg < groups && f0 + gg < F; ++gg)
        s += s_pt[((k2 * groups + gg) * 32 + ln) * kPointEntries + q];
      s_acc[i] = s;
    }
    __syncthreads();
  }

  // the partials are complete: publish them and take a ticket, then store
  // the last round's Hcp and the landmarks' Hpp (mirrored) and gp while the
  // ticket is in flight
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  store_hcp(f_last + g);
  for (int i = tid; i < n_block * 9; i += blockDim.x) {
    const int lm = i / 9, a = (i % 9) / 3, b = i % 3;
    Hpp[static_cast<size_t>(l0) * 9 + i] = s_acc[lm * kPointEntries + upper3(a, b)];
  }
  for (int i = tid; i < n_block * 3; i += blockDim.x)
    gp[static_cast<size_t>(l0) * 3 + i] = s_acc[(i / 3) * kPointEntries + 6 + i % 3];
  __syncthreads();
  if (!s_last) return;

  // the last block sums each partial entry over the blocks in block order,
  // split into `parts` runs of blocks where the block has threads to spare
  __threadfence();
  auto emit = [&](size_t ei, float s) {
    const int f = static_cast<int>(ei / kPoseEntries), q = static_cast<int>(ei % kPoseEntries);
    if (q < 21) {
      int a, b;
      upper_entry(q, a, b);
      Hcc[36 * f + 6 * a + b] = s;
      Hcc[36 * f + 6 * b + a] = s;
    } else if (q < 27) {
      gc[6 * f + (q - 21)] = s;
    } else {
      s_cost[f] = s;
    }
  };
  const unsigned nb = gridDim.x;
  const unsigned parts = blockDim.x >= 2 * E ? blockDim.x / static_cast<unsigned>(E) : 1u;
  if (parts == 1) {
    for (size_t ei = tid; ei < E; ei += blockDim.x) emit(ei, sum_blocks(partial + ei, E, 0, nb));
  } else {
    float* s_part = s_pt;  // [part][entry]
    if (tid < parts * E) {
      const unsigned pa = tid / E, ei = tid % E;
      s_part[tid] = sum_blocks(partial + ei, E, pa * nb / parts, (pa + 1) * nb / parts);
    }
    __syncthreads();
    if (tid < E) {
      float s = s_part[tid];
      for (unsigned pa = 1; pa < parts; ++pa) s += s_part[pa * E + tid];
      emit(tid, s);
    }
  }
  __syncthreads();
  if (tid == 0) {
    float c = 0.f;
    for (int f = 0; f < F; ++f) c += s_cost[f];
    *cost = c;
    *ticket = 0u;  // ready for the next launch
  }
}

}  // namespace

// out: Hcc (F,6,6), Hcp (F,L,6,3), Hpp (L,3,3), gc (F,6), gp (L,3), cost, in
// that order; partial: max(1, ceil(L / 64)) * F * 28 floats; ticket: a zero
// that every launch leaves zero.  F is at most 4544, where a block's shared
// memory reaches the 48 KB a kernel gets without opting in.
extern "C" int ssvo_local_ba_blocks(const float* poses, const float* X, const void* obs,
                                    const void* mask, const float* ur, const void* urm,
                                    const float* intr, int F, int L, float delta, float* out,
                                    float* partial, unsigned int* ticket, cudaStream_t stream) {
  const int warps = kTiles * (F < kMaxGroups ? F : kMaxGroups);
  const size_t smem = local_smem_floats(warps, F) * sizeof(float);
  if (F < 1 || L < 0 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = L > 0 ? (L + 32 * kTiles - 1) / (32 * kTiles) : 1;
  float* Hcc = out;
  float* Hcp = Hcc + 36 * static_cast<size_t>(F);
  float* Hpp = Hcp + 18 * static_cast<size_t>(F) * L;
  float* gc = Hpp + 9 * static_cast<size_t>(L);
  float* gp = gc + 6 * static_cast<size_t>(F);
  float* cost = gp + 3 * static_cast<size_t>(L);
  local_ba_blocks_kernel<<<n_blocks, warps * 32, smem, stream>>>(
      poses, X, static_cast<const float2*>(obs), static_cast<const uint8_t*>(mask), ur,
      static_cast<const uint8_t*>(urm), intr, F, L, delta, Hcc, Hcp, Hpp, gc, gp, cost, partial, ticket);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssvo_motion_hessian_gradient(const float* T, const float* Xt, const float* uvt,
                                            const float* mask, const float* intr, int K,
                                            float delta, float* out, cudaStream_t stream) {
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  motion_hessian_kernel<<<1, kMotionWarps * 32, 0, stream>>>(T, Xt, uvt, mask, intr, K, delta, out);
  return static_cast<int>(cudaGetLastError());
}
