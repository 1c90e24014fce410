// The spans' device clock (utils/spans.py): one thread reads the GPU's
// global nanosecond timer and writes it to a slot of pinned host memory,
// which the card reaches at the host pointer (unified addressing). Captured
// into a window's graph it is a kernel node, which cudaGraphLaunch handles
// like the window's own kernels, unlike an event-record node.

#include <cuda_runtime.h>

namespace {

// Writes the timer to row[point], row = base + (n % ring) * points, n = *seq
// (0 without a seq). With `advance` it first adds 1 to *seq, and after the
// timer writes n to the row's last slot: the first stamp of a graph's
// replay starts the replay's row and names it.
__global__ void stamp_kernel(unsigned long long* base, int point, int points,
                             int ring, unsigned int* seq, int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned int n = 0;
  if (seq != nullptr) {
    if (advance) *seq += 1u;
    n = *seq;
  }
  volatile unsigned long long* row =
      base + static_cast<long long>(n % static_cast<unsigned int>(ring)) *
                 points;
  row[point] = now;
  if (advance) {
    __threadfence_system();
    row[points - 1] = n;
  }
  __threadfence_system();
}

}  // namespace

extern "C" {

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One stamp on `stream` (see stamp_kernel; `seq` in device memory or null;
// with `advance`, `point` is not the last slot).
// Returns cudaGetLastError() after the launch.
int ultra_stamp(unsigned long long* base, int point, int points, int ring,
                unsigned int* seq, int advance, void* stream) {
  if (point < 0 || point >= points - (advance ? 1 : 0) || ring < 1)
    return cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      base, point, points, ring, seq, advance);
  return cudaGetLastError();
}

}  // extern "C"
