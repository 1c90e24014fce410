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
// 4 x 10 KB, about 15 ns of the card's memory rate, and the arithmetic a
// few tens of thousands of operations. Both kernels are bound by launch
// and by latency: the chain of dependent loads, shuffles and block-wide
// steps between a launch and its last store.
//
// Design, against that latency:
// - A list gets G lanes (a power of two from 1 to 32, chosen from L by the
//   wrapper so a lane holds at most kPer = 8 elements a chunk). Lane j of
//   a group holds elements j, j + G, ... in registers, so neighbouring
//   lanes read neighbouring addresses. A list's max, sum-exp, denominator
//   and CE are segmented xor-shuffles of log2(G) steps. At L = 10, G = 2:
//   16 lists a warp and the whole [256, 10] batch in one block of 512
//   threads, with no serial loop over lists.
// - Every load of a chunk is issued before its arithmetic. Lists longer
//   than G * kPer are read chunk by chunk with a running max, a rescaled
//   sum-exp and a rescaled sum of wl * (s~ - max), so each element is read
//   once: denom * CE = denom * log(sum-exp) - sum wl * (s~ - max).
// - K3 spreads over as many blocks as B * G needs. Each block writes its
//   partial (sum denom * CE, sum denom); the last block to finish, found
//   through a ticket counter after __threadfence(), adds the partials in
//   block order, writes the loss and puts the counter back to 0. No float
//   atomics: every sum is taken in a fixed order, so a rerun gives the
//   same bits. The counter belongs to the device; launches on it must not
//   run concurrently on two streams.
// - K3 also writes the residual K4 needs: per list log Z = max + lse and
//   denom, and total. K4 then reads each list once and writes ds, with no
//   reduction at all, so the wrapper gives it small blocks (128 threads)
//   that spread its loads over more SMs.
// - Inputs come with a row stride each (the element stride is 1), so a
//   stride-0 broadcast of one row and a column slice go in as they lie.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPer = 8;  // elements a lane holds per chunk
constexpr float kLabelEps = 1e-7f;
constexpr float kNeg = -1e9f;

struct Inputs {
  const float* s;
  const float* y;
  const float* w;
  const float* m;
  long long rs_s, rs_y, rs_w, rs_m;  // row strides, in elements
};

// One chunk of a list: masked scores and weighted labels, kPer a lane.
struct Chunk {
  float s[kPer], wl[kPer], m[kPer];
};

__device__ __forceinline__ void load_chunk(const Inputs& in, int b, int L,
                                           int first, int G, bool live,
                                           Chunk& c) {
  const float* s = in.s + b * in.rs_s;
  const float* y = in.y + b * in.rs_y;
  const float* w = in.w + b * in.rs_w;
  const float* m = in.m + b * in.rs_m;
  float sv[kPer], yv[kPer], wv[kPer], mv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = first + k * G;
    const bool in_list = live && i < L;
    sv[k] = in_list ? __ldg(s + i) : kNeg;
    yv[k] = in_list ? __ldg(y + i) : 0.f;
    wv[k] = in_list ? __ldg(w + i) : 0.f;
    mv[k] = in_list ? __ldg(m + i) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    c.wl[k] = (yv[k] + kLabelEps) * wv[k] * mv[k];
    c.s[k] = mv[k] > 0.f ? sv[k] : kNeg;
    c.m[k] = mv[k];
  }
}

// Reduce over the G lanes of a group (aligned to G within the warp).
__device__ __forceinline__ float group_max(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
listwise_loss_fwd_kernel(Inputs in, int B, int L, int G,
                         float* __restrict__ out, float* __restrict__ stats,
                         float* __restrict__ partials,
                         unsigned* __restrict__ ticket) {
  const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = lane_id / G, j = lane_id % G;
  const bool live = b < B;

  // Per lane: running max mx, sum of exp(s~ - mx), denominator, and
  // sum of wl * (s~ - mx).
  float mx = kNeg, se = 0.f, den = 0.f, t = 0.f;
  for (int base = 0; base < L; base += G * kPer) {
    Chunk c;
    load_chunk(in, b, L, base + j, G, live, c);
    float cmax = kNeg;
#pragma unroll
    for (int k = 0; k < kPer; ++k) cmax = fmaxf(cmax, c.s[k]);
    const float nmx = fmaxf(mx, cmax);
    se *= expf(mx - nmx);
    t -= den * (nmx - mx);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (base + j + k * G < L) {
        se += expf(c.s[k] - nmx);
        t += c.wl[k] * (c.s[k] - nmx);
        den += c.wl[k];
      }
    }
    mx = nmx;
  }
  const float gmx = group_max(mx, G);
  se = group_sum(se * expf(mx - gmx), G);
  t = group_sum(t - den * (gmx - mx), G);
  den = group_sum(den, G);
  const float lse = logf(se);
  float num = den > 0.f ? den * lse - t : 0.f;
  if (live && j == 0) {
    stats[2LL * b] = gmx + lse;
    stats[2LL * b + 1] = den;
  }

  // The block's sum over its lists: one value a group, then warps in order.
  if (!live || j != 0) num = den = 0.f;
  for (int o = 16; o >= G; o >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, o);
    den += __shfl_xor_sync(0xffffffffu, den, o);
  }
  __shared__ float2 warp_sums[kMaxWarps];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_sums[warp] = make_float2(num, den);
  __syncthreads();
  if (threadIdx.x != 0) return;
  float2 acc = warp_sums[0];
  for (int k = 1; k < blockDim.x / 32; ++k) {
    acc.x += warp_sums[k].x;
    acc.y += warp_sums[k].y;
  }
  if (gridDim.x > 1) {
    partials[2 * blockIdx.x] = acc.x;
    partials[2 * blockIdx.x + 1] = acc.y;
    __threadfence();
    if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
    __threadfence();
    acc = make_float2(0.f, 0.f);
    for (int k = 0; k < gridDim.x; ++k) {
      acc.x += __ldcg(partials + 2 * k);
      acc.y += __ldcg(partials + 2 * k + 1);
    }
    *ticket = 0u;
  }
  out[0] = acc.x / (acc.y > 0.f ? acc.y : 1.f);
  stats[2LL * B] = acc.y;
}

__global__ void __launch_bounds__(kMaxThreads)
listwise_loss_bwd_kernel(Inputs in, int B, int L, int G,
                         const float* __restrict__ stats,
                         const float* __restrict__ g, float* __restrict__ ds) {
  const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = lane_id / G, j = lane_id % G;
  if (b >= B) return;  // K4 has no shuffles: a lane past the batch may go
  const float lz = __ldg(stats + 2LL * b), den = __ldg(stats + 2LL * b + 1);
  const float tot = __ldg(stats + 2LL * B);
  const float scale = den / (tot > 0.f ? tot : 1.f);
  const float gv = __ldg(g);
  float* out = ds + static_cast<long long>(b) * L;
  for (int base = 0; base < L; base += G * kPer) {
    Chunk c;
    load_chunk(in, b, L, base + j, G, true, c);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + j + k * G;
      if (i < L) {
        const float dis = den > 0.f ? c.wl[k] / den : 0.f;
        const float p = expf(c.s[k] - lz);
        out[i] = gv * scale * (p - dis) * c.m[k];
      }
    }
  }
}

bool bad_geometry(int B, int L, int G, int threads, int blocks) {
  return B < 1 || L < 1 || G < 1 || G > 32 || (G & (G - 1)) ||
         threads < 32 || threads > kMaxThreads || threads % 32 ||
         blocks < 1 ||
         static_cast<long long>(blocks) * threads <
             static_cast<long long>(B) * G;
}

}  // namespace

extern "C" {

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3: the loss of [B, L] float32 inputs (element stride 1, row strides
// rs_*) into out[0]; stats gets per list (log Z, denom) at [2b], [2b + 1]
// and total at [2B]. partials holds 2 floats a block (unused with one
// block); ticket is a counter that is 0 between launches.
int ultra_listwise_loss_fwd(const float* s, const float* y, const float* w,
                            const float* m, long long rs_s, long long rs_y,
                            long long rs_w, long long rs_m, int B, int L,
                            int G, int threads, int blocks, float* out,
                            float* stats, float* partials, unsigned* ticket,
                            void* stream) {
  if (bad_geometry(B, L, G, threads, blocks)) return cudaErrorInvalidValue;
  const Inputs in{s, y, w, m, rs_s, rs_y, rs_w, rs_m};
  listwise_loss_fwd_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      in, B, L, G, out, stats, partials, ticket);
  return cudaGetLastError();
}

// K4: ds [B, L] (contiguous) for the scalar cotangent g[0], from K3's
// residual stats, laid out as K3 writes it.
int ultra_listwise_loss_bwd(const float* s, const float* y, const float* w,
                            const float* m, long long rs_s, long long rs_y,
                            long long rs_w, long long rs_m, int B, int L,
                            int G, int threads, int blocks,
                            const float* stats, const float* g, float* ds,
                            void* stream) {
  if (bad_geometry(B, L, G, threads, blocks)) return cudaErrorInvalidValue;
  const Inputs in{s, y, w, m, rs_s, rs_y, rs_w, rs_m};
  listwise_loss_bwd_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      in, B, L, G, stats, g, ds);
  return cudaGetLastError();
}

}  // extern "C"
