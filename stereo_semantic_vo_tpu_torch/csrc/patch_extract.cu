// Descriptor-patch extraction: the (2r+1)^2 patch at each keypoint's
// top-left origin, copied into tight (K, P, P) float32 patches, for all
// pyramid levels of a frame in one launch.
//
// Replaces: stereo_semantic_vo_tpu/kernels/patch_extract.py:extract_patches
// (Pallas, TPU).  The TPU kernel DMAs (8, 128)-aligned tiles and realigns
// them with rotates into (K, 32, 128) slabs, one call per level; that layout
// existed only for the TPU's tiling, so this kernel writes the tight patches
// the describe step indexes directly.
//
// Bound on the H100: memory, and below that the launch.  A frame moves
// about 6 MB (1,536 patches of 31x31 written, the pixels under them read),
// about 3 us of HBM time.  So the design cuts launches and host work: the
// level table (image pointer, H, W, first patch index of each of up to 8
// levels) travels by value in the kernel's parameters, which needs no
// host-to-device copy and no sync, and one launch covers every level.  One
// warp per patch: lane c copies column c of each row, so a row's 31 reads
// and 31 writes are contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 4;

struct PatchLevels {
  const float* img[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int first[kMaxLevels];  // index of the level's first patch
  int n_levels;
};

__global__ void extract_patches_levels_kernel(const PatchLevels lv, const int* __restrict__ y0,
                                              const int* __restrict__ x0, int K, int P,
                                              float* __restrict__ out) {
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= K) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  // the patch's level: the last one whose first index is <= k (static
  // indices only, so the table stays in the parameter bank)
  const float* img = lv.img[0];
  int H = lv.H[0], W = lv.W[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l < lv.n_levels && k >= lv.first[l]) {
      img = lv.img[l];
      H = lv.H[l];
      W = lv.W[l];
    }
  }
  // origins are pre-clamped by the caller; clamping again keeps every read
  // inside the image whatever the caller passes
  const int oy = min(max(y0[k], 0), H - P);
  const int ox = min(max(x0[k], 0), W - P);
  const float* src = img + static_cast<size_t>(oy) * W + ox;
  float* dst = out + static_cast<size_t>(k) * P * P;
#pragma unroll 8
  for (int r = 0; r < P; ++r) {
    for (int c = lane; c < P; c += 32) dst[r * P + c] = src[static_cast<size_t>(r) * W + c];
  }
}

}  // namespace

// imgs: n_levels device pointers; H, W, first: n_levels host ints each
// (first[l] = the index of level l's first patch, ascending from 0).
extern "C" int ssvo_extract_patches_levels(const float* const* imgs, const int* H, const int* W,
                                           const int* first, int n_levels, const int* y0,
                                           const int* x0, int K, int P, float* out,
                                           cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  PatchLevels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.img[l] = imgs[l];
    lv.H[l] = H[l];
    lv.W[l] = W[l];
    lv.first[l] = first[l];
  }
  lv.n_levels = n_levels;
  if (K > 0) {
    const int blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
    extract_patches_levels_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(lv, y0, x0, K, P, out);
  }
  return static_cast<int>(cudaGetLastError());
}
