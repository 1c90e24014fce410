// K3 / K4: fused propensity-weighted listwise softmax loss and its
// gradient, CUDA C++ for Hopper (sm_90a).
//
// Replace the TPU kernels `_fwd_kernel` (K3) and `_bwd_kernel` (K4) of
// ultra_pytorch_tpu/ops/pallas/listwise_loss.py:47 and :56 (pallas_call at
// :66 and :83). For scores s, labels y, weights w and mask m, all [B, L]:
//   wl        = (y + 1e-7) * w * m
//   denom_b   = sum_i wl[b, i];   total = sum_b denom_b
//   label_dis = denom_b > 0 ? wl / denom_b : 0
//   s~        = m > 0 ? s : -1e9
//   K3: loss  = sum_b denom_b * sum_i -label_dis * log_softmax(s~)[b, i]
//               / (total > 0 ? total : 1)
//   K4: ds    = g * (denom_b / (total > 0 ? total : 1))
//               * (softmax(s~) - label_dis) * m
//
// What bounds it: at the training shape (B = 256, L = 10) the inputs are
// 4 x 10 KB and the arithmetic a few tens of thousands of operations, far
// under a microsecond of the card's bytes or operations. It is bound by
// launch latency and by the one block's serial reduction.
// Design: `total` is a reduction over the whole batch (the TPU kernel held
// the batch in one VMEM block), so the kernel is one block of 1024 threads:
// warp w takes lists w, w + 32, ...; each list is reduced with shuffles;
// each warp keeps its running sums and thread 0 adds the 32 warp sums in
// order. Every sum is taken in a fixed order, so two runs give the same
// bits. K4 computes `total` in a first pass before it writes ds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kLabelEps = 1e-7f;
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct ListStats {
  float denom, mx, lse;
};

// One warp: the denominator, max and log-sum-exp of list `row` (length L).
__device__ ListStats list_stats(const float* s, const float* y,
                                const float* w, const float* m, int L,
                                int lane) {
  float denom = 0.f, mx = kNeg;
  for (int i = lane; i < L; i += 32) {
    denom += (y[i] + kLabelEps) * w[i] * m[i];
    mx = fmaxf(mx, m[i] > 0.f ? s[i] : kNeg);
  }
  denom = warp_sum(denom);
  mx = warp_max(mx);
  float se = 0.f;
  for (int i = lane; i < L; i += 32) se += expf((m[i] > 0.f ? s[i] : kNeg) - mx);
  return {denom, mx, logf(warp_sum(se))};
}

// Adds the 32 warp values in order; every thread gets the result.
__device__ float block_sum(float v, float* slots, int warp, int lane) {
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < kWarps; ++k) total += slots[k];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads, 1)
listwise_loss_fwd_kernel(const float* __restrict__ s,
                         const float* __restrict__ y,
                         const float* __restrict__ w,
                         const float* __restrict__ m, float* __restrict__ out,
                         int B, int L) {
  __shared__ float slots[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float ce_denom = 0.f, tot = 0.f;
  for (int b = warp; b < B; b += kWarps) {
    const long long o = static_cast<long long>(b) * L;
    const ListStats st = list_stats(s + o, y + o, w + o, m + o, L, lane);
    float ce = 0.f;
    for (int i = lane; i < L; i += 32) {
      const float wl = (y[o + i] + kLabelEps) * w[o + i] * m[o + i];
      const float dis = st.denom > 0.f ? wl / st.denom : 0.f;
      const float sm = m[o + i] > 0.f ? s[o + i] : kNeg;
      ce += -dis * (sm - st.mx - st.lse);
    }
    ce_denom += warp_sum(ce) * st.denom;
    tot += st.denom;
  }
  const float num = block_sum(ce_denom, slots, warp, lane);
  const float total = block_sum(tot, slots, warp, lane);
  if (threadIdx.x == 0) out[0] = num / (total > 0.f ? total : 1.f);
}

__global__ void __launch_bounds__(kThreads, 1)
listwise_loss_bwd_kernel(const float* __restrict__ s,
                         const float* __restrict__ y,
                         const float* __restrict__ w,
                         const float* __restrict__ m,
                         const float* __restrict__ g, float* __restrict__ ds,
                         int B, int L) {
  __shared__ float slots[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float tot = 0.f;
  for (int b = warp; b < B; b += kWarps) {
    const long long o = static_cast<long long>(b) * L;
    float d = 0.f;
    for (int i = lane; i < L; i += 32)
      d += (y[o + i] + kLabelEps) * w[o + i] * m[o + i];
    tot += warp_sum(d);
  }
  float total = block_sum(tot, slots, warp, lane);
  total = total > 0.f ? total : 1.f;
  const float gv = g[0];
  for (int b = warp; b < B; b += kWarps) {
    const long long o = static_cast<long long>(b) * L;
    const ListStats st = list_stats(s + o, y + o, w + o, m + o, L, lane);
    const float scale = st.denom / total;
    for (int i = lane; i < L; i += 32) {
      const float wl = (y[o + i] + kLabelEps) * w[o + i] * m[o + i];
      const float dis = st.denom > 0.f ? wl / st.denom : 0.f;
      const float sm = m[o + i] > 0.f ? s[o + i] : kNeg;
      const float p = expf(sm - st.mx - st.lse);
      ds[o + i] = gv * scale * (p - dis) * m[o + i];
    }
  }
}

}  // namespace

extern "C" {

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3: the loss of [B, L] float32 inputs (contiguous) into out[0].
int ultra_listwise_loss_fwd(const float* s, const float* y, const float* w,
                            const float* m, float* out, int B, int L,
                            void* stream) {
  if (B < 1 || L < 1) return cudaErrorInvalidValue;
  listwise_loss_fwd_kernel<<<1, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      s, y, w, m, out, B, L);
  return cudaGetLastError();
}

// K4: ds [B, L] for the incoming scalar cotangent g[0] (device memory).
int ultra_listwise_loss_bwd(const float* s, const float* y, const float* w,
                            const float* m, const float* g, float* ds, int B,
                            int L, void* stream) {
  if (B < 1 || L < 1) return cudaErrorInvalidValue;
  listwise_loss_bwd_kernel<<<1, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      s, y, w, m, g, ds, B, L);
  return cudaGetLastError();
}

}  // extern "C"
