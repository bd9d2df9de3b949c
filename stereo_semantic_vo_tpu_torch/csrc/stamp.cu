// A stage stamp of the tracer (utils/profiling.py): one thread writes the
// card's global nanosecond timer into the current row of a ring of stamps.
//
// No TPU counterpart: the JAX package reads its stages from XProf traces.
// Here every frame is one CUDA graph replay, whose stage code ran on the
// host once, at capture, so the stage marks are nodes of the graph.  The
// ring is (depth, width) int64 on the card with a device counter of the
// calls written so far; a call's stamps land in row count % depth, slot
// by slot, and its last stamp advances the counter.  The kernel reads
// nothing back to the host, so a capture or a replay that holds it never
// synchronises.  Kernels of one stream run in order, so a stamp reads the
// timer after the work queued before it has ended and before the work
// queued after it starts: consecutive stamps of a single-stream graph tile
// its replay.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* stamps, long long* count, int depth, int width, int slot, int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long calls = *count;
  stamps[(calls % depth) * width + slot] = static_cast<long long>(now);
  if (advance) *count = calls + 1;
}

}  // namespace

extern "C" int ssvo_stamp(void* stamps, void* count, int depth, int width, int slot, int advance,
                          cudaStream_t stream) {
  if (depth <= 0 || slot < 0 || slot >= width) return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, stream>>>(static_cast<long long*>(stamps), static_cast<long long*>(count), depth, width,
                                    slot, advance);
  return static_cast<int>(cudaGetLastError());
}
