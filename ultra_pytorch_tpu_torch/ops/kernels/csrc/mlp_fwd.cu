// K1: fused MLP forward for the DNN ranker, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of ultra_pytorch_tpu/ops/pallas/mlp.py:91
// (launched by `_forward_pallas`, pallas_call at :118). It computes, for
// every row of x [N, F], the DNN's whole layer chain: per layer LayerNorm
// (clamped one-pass variance E[x^2]-E[x]^2, eps 1e-5) with its affine,
// then h @ W + b, then the activation on every layer but the last. The
// last layer has width 1 and yields the row's score.
//
// What bounds it: at the serving shape F = 136, widths 512/256/128/1 the
// chain is 233,600 multiply-adds per row. At N = 32,768 rows that is
// 2 * N * 233,600 = 15.3 GFLOP, about 0.23 ms at the H100's 67 TFLOP/s of
// float32 on CUDA cores, against about 19 MB of traffic (features in,
// weights, scores out), about 6 us at 3.35 TB/s. So it is compute-bound.
//
// Design (simple and right first; a TF32/bf16 tensor-core `wgmma` redesign
// is later work):
//   * One block owns a tile of kRows rows. The tile's activations live in
//     two ping-pong buffers in dynamic shared memory, so no intermediate
//     goes back to device memory: only x is read and the scores written.
//   * LayerNorm: one warp per row reduces sum and sum of squares with
//     shuffles, then normalises in place and applies the affine.
//   * Linear: each thread owns an 8-row x 4-column micro-tile of the
//     output in registers and walks k, reading the row tile from shared
//     memory (a broadcast: the warp's threads share their rows) and W from
//     device memory. W keeps JAX's [in, out] layout, so neighbouring
//     threads read neighbouring W[k, j]. All weights together are 0.93 MB
//     at the serving widths and stay in the 50 MB L2.
//   * The TPU kernel held every weight in VMEM; 227 KB of shared memory is
//     less than the weights, so here only the activations are on chip.
//   * The ragged last tile is masked here (JAX padded N to 256 rows): rows
//     past N load as zeros and are never written.
//   * ELU and SELU use expm1f (Mosaic had no expm1; CUDA does).
//
// Parameters arrive packed in one buffer, per layer
// [scale (in), bias (in), W (in x out, row-major), b (out)].

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                       // rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;               // micro-tile rows
constexpr int kColsPerThread = 4;               // micro-tile columns
constexpr int kRowGroups = kRows / kRowsPerThread;       // 4
constexpr int kColLanes = kThreads / kRowGroups;         // 64
constexpr int kColsPerPass = kColLanes * kColsPerThread; // 256
constexpr int kMaxLayers = 16;
constexpr float kEps = 1e-5f;

struct Dims {
  int n_layers;
  int stride;  // floats per row of a shared-memory buffer (multiple of 4)
  int width[kMaxLayers + 1];
};

// Activation codes: 0 elu, 1 relu, 2 selu, 3 tanh, 4 sigmoid.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 0: return v > 0.f ? v : expm1f(v);
    case 1: return fmaxf(v, 0.f);
    case 2: return 1.0507009873554805f *
                   (v > 0.f ? v : 1.6732632423543772f * expm1f(v));
    case 3: return tanhf(v);
    default: return 1.f / (1.f + expf(-v));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ params,
               float* __restrict__ out, int n_rows, Dims d, int act,
               int use_norm) {
  extern __shared__ float4 smem4[];
  float* cur = reinterpret_cast<float*>(smem4);
  float* nxt = cur + kRows * d.stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int f = d.width[0];

  // The row tile; rows past n_rows are zeros and are never written out.
  for (int i = tid; i < kRows * f; i += kThreads) {
    const int r = i / f, k = i - r * f;
    const long long row = row0 + r;
    cur[r * d.stride + k] = row < n_rows ? x[row * f + k] : 0.f;
  }
  __syncthreads();

  const float* p = params;
  for (int j = 0; j < d.n_layers; ++j) {
    const int in = d.width[j], width = d.width[j + 1];
    const float* scale = p;
    const float* bias = p + in;
    const float* w = p + 2 * in;
    const float* b = w + static_cast<size_t>(in) * width;
    p = b + width;

    if (use_norm) {
      for (int r = warp; r < kRows; r += kWarps) {
        float* h = cur + r * d.stride;
        float s = 0.f, ss = 0.f;
        for (int k = lane; k < in; k += 32) {
          const float v = h[k];
          s += v;
          ss += v * v;
        }
        s = warp_sum(s);
        ss = warp_sum(ss);
        const float mean = s / in;
        const float var = fmaxf(ss / in - mean * mean, 0.f);
        const float rstd = rsqrtf(var + kEps);
        for (int k = lane; k < in; k += 32)
          h[k] = (h[k] - mean) * rstd * scale[k] + bias[k];
      }
      __syncthreads();
    }

    if (j == d.n_layers - 1) {
      // Width-1 output layer: one warp per row, a dot product.
      for (int r = warp; r < kRows; r += kWarps) {
        const float* h = cur + r * d.stride;
        float s = 0.f;
        for (int k = lane; k < in; k += 32) s += h[k] * w[k];
        s = warp_sum(s);
        const long long row = row0 + r;
        if (lane == 0 && row < n_rows) out[row] = s + b[0];
      }
      return;
    }

    // Hidden layer: thread (rg, cl) owns rows rg*8 .. rg*8+7 and columns
    // c0 + cl + 64*c, c = 0..3, of each 256-column pass.
    const int rg = tid / kColLanes, cl = tid % kColLanes;
    const float* hrow = cur + rg * kRowsPerThread * d.stride;
    for (int c0 = 0; c0 < width; c0 += kColsPerPass) {
      int col[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        col[c] = c0 + cl + c * kColLanes;
      float acc[kRowsPerThread][kColsPerThread] = {};
      int k = 0;
      if ((in & 3) == 0) {
        // Rows are 16-byte aligned (stride % 4 == 0): read h four k at a time.
        for (; k < in; k += 4) {
          float4 hv[kRowsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            hv[i] = *reinterpret_cast<const float4*>(hrow + i * d.stride + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wk = w + static_cast<size_t>(k + kk) * width;
            float wv[kColsPerThread];
#pragma unroll
            for (int c = 0; c < kColsPerThread; ++c)
              wv[c] = col[c] < width ? __ldg(wk + col[c]) : 0.f;
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) {
              const float hk = component(hv[i], kk);
#pragma unroll
              for (int c = 0; c < kColsPerThread; ++c)
                acc[i][c] = fmaf(hk, wv[c], acc[i][c]);
            }
          }
        }
      }
      for (; k < in; ++k) {
        const float* wk = w + static_cast<size_t>(k) * width;
        float wv[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          wv[c] = col[c] < width ? __ldg(wk + col[c]) : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float hk = hrow[i * d.stride + k];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c)
            acc[i][c] = fmaf(hk, wv[c], acc[i][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        if (col[c] >= width) continue;
        const float bc = b[col[c]];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          nxt[(rg * kRowsPerThread + i) * d.stride + col[c]] =
              activate(acc[i][c] + bc, act);
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

bool make_dims(const int* widths, int n_layers, Dims* d) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  d->n_layers = n_layers;
  int max_width = 0;
  for (int j = 0; j <= n_layers; ++j) {
    if (widths[j] < 1) return false;
    d->width[j] = widths[j];
    max_width = widths[j] > max_width ? widths[j] : max_width;
  }
  d->stride = (max_width + 3) & ~3;
  return true;
}

size_t smem_bytes(const Dims& d) {
  return 2ull * kRows * d.stride * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these widths (0 if invalid).
long long ultra_mlp_fwd_smem_bytes(const int* widths, int n_layers) {
  Dims d;
  return make_dims(widths, n_layers, &d) ? static_cast<long long>(smem_bytes(d))
                                         : 0;
}

int ultra_mlp_fwd_max_layers() { return kMaxLayers; }

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scores n_rows rows of x [n_rows, widths[0]] into out [n_rows] on
// `stream`. widths (host memory) holds n_layers + 1 entries, the last 1.
// Returns cudaGetLastError() after the launch.
int ultra_mlp_fwd(const float* x, const float* params, float* out,
                  int n_rows, const int* widths, int n_layers, int act,
                  int use_norm, void* stream) {
  Dims d;
  if (!make_dims(widths, n_layers, &d) || widths[n_layers] != 1 ||
      n_rows < 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n_rows + kRows - 1) / kRows);
  mlp_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, params, out, n_rows, d, act, use_norm);
  return cudaGetLastError();
}

}  // extern "C"
