// Bundle-adjustment normal-equation builds: the motion-only build (B5) and
// the local-BA block build (B7).
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
// Design: one block of 256 threads strides over the K observations; each
// thread keeps its 28 partial sums (21 upper-triangle H, 6 g, 1 cost) in
// registers, then the block reduces them in a fixed order (warp shuffles,
// then the warps in order).  No atomics, so two runs agree bit for bit.  H,
// g and cost land in one 43-float buffer that the wrapper returns views of.
//
// Bound on the H100: launch latency.  At K = 512 the build reads 12 KB and
// does ~120 kFLOP, a few nanoseconds of HBM or ALU time; one block on one SM
// is enough.  The TPU kernel's point, that the (K, 2, 6) Jacobian never
// reaches memory, holds here too: the einsum build it replaces is dozens of
// launches per LM step, this one is one.
//
// --- Local-BA block build --------------------------------------------------
//
// Replaces: stereo_semantic_vo_tpu/kernels/ba_hessian.py:local_ba_blocks
// (Pallas, TPU).  Same contract as ops/local_ba.build_normal_equations: F
// poses (F, 4, 4) and L landmarks (L, 3) with observations obs_uv (F, L, 2)
// and mask (F, L) (float {0, 1}), optionally a stereo row u_R = u - bf / z
// with obs_ur (F, L) and its validity weight (F, L), give
//   Hcc (F, 6, 6), Hcp (F, L, 6, 3), Hpp (L, 3, 3), gc (F, 6), gp (L, 3), cost
// under Huber IRLS weights.  The formulas are the Pallas kernel's: the
// analytic 2x6 (or 3x6) pose Jacobian for the left update T <- exp(xi) T and
// the landmark Jacobian d(uv)/d(pc) R.  Layouts are the natural ones, not the
// TPU's transposed (3, L) / (F, 2, L); any L is taken.
//
// Design: one thread per landmark loops over the F frames, keeping its Hpp
// and gp in registers and writing its 18 Hcp entries per frame directly.
// The pose blocks (21 unique Hcc entries and 6 gc entries per frame) and the
// robust cost are reduced over the block's landmarks (a warp-shuffle tree,
// then the warps in order) into per-block partials; a second launch sums
// the partials in block order.  No atomics, so two runs agree bit for bit.
//
// Bound on the H100: launch latency.  At F = 4, L = 2048 the build reads
// ~130 KB, writes ~700 KB (Hcp is 4 x 2048 x 18 floats) and does ~2 MFLOP;
// both are microseconds.  Later work: fuse the Schur complement's
// per-landmark Hpp^-1 products into the same pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPoseEntries = 28;  // 21 upper-triangle Hcc, 6 gc, 1 cost
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

constexpr int kMotionThreads = 256;
constexpr int kMotionWarps = kMotionThreads / 32;

// (a, b), a <= b, of the k-th upper-triangle entry of a 6x6 matrix, row-major
__device__ __forceinline__ void upper_entry(int k, int& a, int& b) {
  a = 0;
  while (k >= 6 - a) {
    k -= 6 - a;
    ++a;
  }
  b = a + k;
}

__global__ void motion_hessian_kernel(const float* __restrict__ T, const float* __restrict__ Xt,
                                      const float* __restrict__ uvt, const float* __restrict__ mask,
                                      const float* __restrict__ intr, int K, float delta,
                                      float* __restrict__ out) {
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
  float e[kPoseEntries] = {};
  for (int k = threadIdx.x; k < K; k += kMotionThreads) {
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
#pragma unroll
  for (int q = 0; q < kPoseEntries; ++q) {
    const float s = warp_sum(e[q]);
    if (lane == 0) red[warp][q] = s;
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q < kPoseEntries) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kMotionWarps; ++wi) s += red[wi][q];
    if (q < 21) {
      int a, b;
      upper_entry(q, a, b);
      out[6 * a + b] = s;
      out[6 * b + a] = s;
    } else {
      out[36 + (q - 21)] = s;  // g, then the cost at out[42]
    }
  }
}

__global__ void local_ba_blocks_kernel(const float* __restrict__ poses,
                                       const float* __restrict__ X,
                                       const float* __restrict__ obs,
                                       const float* __restrict__ mask,
                                       const float* __restrict__ ur,
                                       const float* __restrict__ urm,
                                       const float* __restrict__ intr, int F, int L,
                                       float delta, float* __restrict__ Hcp,
                                       float* __restrict__ Hpp, float* __restrict__ gp,
                                       float* __restrict__ partial) {
  __shared__ float red[kWarps][kPoseEntries];
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool live = l < L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool stereo = ur != nullptr;
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3], bf = intr[4];
  const float xw = live ? X[3 * l + 0] : 0.f;
  const float yw = live ? X[3 * l + 1] : 0.f;
  const float zw = live ? X[3 * l + 2] : 0.f;

  float hpp[3][3] = {}, gpl[3] = {};
  for (int f = 0; f < F; ++f) {
    const float* T = poses + 16 * f;
    float R[3][3], t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) R[a][b] = T[4 * a + b];
      t[a] = T[4 * a + 3];
    }
    const float px = R[0][0] * xw + R[0][1] * yw + R[0][2] * zw + t[0];
    const float py = R[1][0] * xw + R[1][1] * yw + R[1][2] * zw + t[1];
    const float pz = R[2][0] * xw + R[2][1] * yw + R[2][2] * zw + t[2];
    const float zs = fabsf(pz) > 1e-6f ? pz : 1e-6f;
    const float iz = 1.0f / zs;
    const float iz2 = iz * iz;
    const float u = fx * px * iz + cx;
    const float v = fy * py * iz + cy;
    const size_t o = static_cast<size_t>(f) * L + l;
    const float ru = live ? u - obs[2 * o] : 0.f;
    const float rv = live ? v - obs[2 * o + 1] : 0.f;
    const float mpos = live && pz > 0.05f ? mask[o] : 0.f;
    float wr = 0.f, rs = 0.f;
    float r2 = ru * ru + rv * rv;
    if (stereo) {
      wr = live ? urm[o] : 0.f;
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

#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        hpp[a][b] += w * (Jpu[a] * Jpu[b] + Jpv[a] * Jpv[b] + Jps[a] * Jps[b]);
      gpl[a] += w * (Jpu[a] * ru + Jpv[a] * rv + Jps[a] * rs);
    }
    if (live) {
      float* hcp = Hcp + 18 * o;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          hcp[3 * a + b] = w * (Ju[a] * Jpu[b] + Jv[a] * Jpv[b] + Js[a] * Jps[b]);
      }
    }

    // this frame's pose-block entries, reduced over the block
    float e[kPoseEntries];
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) e[k++] = w * (Ju[a] * Ju[b] + Jv[a] * Jv[b] + Js[a] * Js[b]);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) e[21 + a] = w * (Ju[a] * ru + Jv[a] * rv + Js[a] * rs);
    e[27] = rho;
#pragma unroll
    for (int q = 0; q < kPoseEntries; ++q) {
      const float s = warp_sum(e[q]);
      if (lane == 0) red[warp][q] = s;
    }
    __syncthreads();
    if (threadIdx.x < kPoseEntries) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi][threadIdx.x];
      partial[(static_cast<size_t>(blockIdx.x) * F + f) * kPoseEntries + threadIdx.x] = s;
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) Hpp[9 * l + 3 * a + b] = hpp[a][b];
      gp[3 * l + a] = gpl[a];
    }
  }
}

// one thread per (frame, entry): sum the per-block partials in block order
__global__ void local_ba_finalize_kernel(const float* __restrict__ partial, int n_blocks, int F,
                                         float* __restrict__ Hcc, float* __restrict__ gc,
                                         float* __restrict__ cost) {
  extern __shared__ float frame_cost[];
  const int tid = threadIdx.x;
  const int f = tid / kPoseEntries, k = tid % kPoseEntries;
  if (f < F) {
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += partial[(static_cast<size_t>(b) * F + f) * kPoseEntries + k];
    if (k < 21) {
      int a, b;
      upper_entry(k, a, b);
      Hcc[36 * f + 6 * a + b] = s;
      Hcc[36 * f + 6 * b + a] = s;
    } else if (k < 27) {
      gc[6 * f + (k - 21)] = s;
    } else {
      frame_cost[f] = s;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float c = 0.f;
    for (int i = 0; i < F; ++i) c += frame_cost[i];
    *cost = c;
  }
}

}  // namespace

extern "C" int ssvo_local_ba_blocks(const float* poses, const float* X, const float* obs,
                                    const float* mask, const float* ur, const float* urm,
                                    const float* intr, int F, int L, float delta, float* Hcc,
                                    float* Hcp, float* Hpp, float* gc, float* gp, float* cost,
                                    float* partial, cudaStream_t stream) {
  const int n_blocks = (L + kThreads - 1) / kThreads;
  if (F < 1 || F * kPoseEntries > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    local_ba_blocks_kernel<<<n_blocks, kThreads, 0, stream>>>(
        poses, X, obs, mask, ur, urm, intr, F, L, delta, Hcp, Hpp, gp, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  local_ba_finalize_kernel<<<1, F * kPoseEntries, F * sizeof(float), stream>>>(
      partial, n_blocks, F, Hcc, gc, cost);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssvo_motion_hessian_gradient(const float* T, const float* Xt, const float* uvt,
                                            const float* mask, const float* intr, int K,
                                            float delta, float* out, cudaStream_t stream) {
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  motion_hessian_kernel<<<1, kMotionThreads, 0, stream>>>(T, Xt, uvt, mask, intr, K, delta, out);
  return static_cast<int>(cudaGetLastError());
}
