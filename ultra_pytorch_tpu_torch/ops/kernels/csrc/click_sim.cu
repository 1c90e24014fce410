// K5: PBM click sampler, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of ultra_pytorch_tpu/ops/pallas/click_sim.py:26
// (launched by `pallas_sample_pbm_clicks`, pallas_call at :74). For every
// element e of a [C, L] batch it draws u in [0, 1) and writes
// click = (u < probs[e]) * mask[e], where the caller has computed
// probs = exam[min(pos, 9)]^eta * click_prob[clip(grade)].
//
// Random bits: Philox4x32-10 written out here (not curand's API), so that
// the plain PyTorch version (ops/kernels/click_sim.py) reproduces the
// stream bit for bit. The key is two 32-bit words, drawn by the caller
// from its torch.Generator on every call and read from device memory (no
// host round trip); the TPU kernel also seeded with every word of its key.
// Counter i = (i mod 2^32, i div 2^32, 0, 0) yields four words, which are
// elements 4i .. 4i+3. u = (word >> 8) * 2^-24, as the TPU kernel's top
// 24 bits.
//
// What bounds it: at the training shape (C up to 9 x 256 candidates x 10
// positions per step, one launch for a window of steps) it reads probs and
// mask and writes clicks, 12 bytes an element, and does ~30 integer
// operations an element. A window of 50 steps at the bench protocol's
// auto-sized pool (about 800 candidates a step) is 0.4M elements: 4.8 MB,
// 1.4 us at 3.35 TB/s. At one launch per window it is bound by bytes; at a
// few thousand elements (feed init) by launch latency.
// Design: one thread per counter (four elements), no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c[0], hi0 = __umulhi(kM0, c[0]);
    const uint32_t lo1 = kM1 * c[2], hi1 = __umulhi(kM1, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__global__ void __launch_bounds__(kThreads)
pbm_clicks_kernel(const float* __restrict__ probs,
                  const float* __restrict__ mask,
                  const long long* __restrict__ key, float* __restrict__ out,
                  long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (4 * i >= n) return;
  uint32_t c[4] = {static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32),
                   0u, 0u};
  philox4x32_10(c, static_cast<uint32_t>(key[0]),
                static_cast<uint32_t>(key[1]));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long e = 4 * i + j;
    if (e < n) {
      const float u = static_cast<float>(c[j] >> 8) * 5.9604644775390625e-08f;
      out[e] = (u < probs[e] ? 1.f : 0.f) * mask[e];
    }
  }
}

}  // namespace

extern "C" {

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clicks for n elements of probs / mask (float32, contiguous) into out, with
// the Philox key key[0..1] (int64 words < 2^32, device memory) on `stream`.
// Returns cudaGetLastError() after the launch.
int ultra_pbm_clicks(const float* probs, const float* mask,
                     const long long* key, float* out, long long n,
                     void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long counters = (n + 3) / 4;
  const unsigned grid =
      static_cast<unsigned>((counters + kThreads - 1) / kThreads);
  pbm_clicks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      probs, mask, key, out, n);
  return cudaGetLastError();
}

}  // extern "C"
