// K2: fused MLP backward for the DNN ranker, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of ultra_pytorch_tpu/ops/pallas/mlp.py:155
// (launched by `_backward_pallas`, pallas_call at :254; custom_vjp
// `_fused_bwd` :267). Given x [N, F] and the scores' cotangent g [N], it
// recomputes the forward of K1 (csrc/mlp_fwd.cu) and backpropagates through
// every layer's activation, Linear and LayerNorm. It writes dx [N, F] and
// one gradient per parameter, in the packed layout of K1's parameters
// (per layer [dscale (in), dbias (in), dW (in x out), db (out)]).
//
// The LayerNorm backward is the TPU kernel's formula (:196-203) on the
// clamped one-pass variance:
//   dh = rstd * (dnhat - mean(dnhat) - nhat * mean(dnhat * nhat)),
//   dnhat = dpost * scale.
// Activation derivatives are taken from the activation's output h = act(z),
// which phase 1 keeps in shared memory: elu h > 0 ? 1 : h + 1 (= exp(z)),
// relu h > 0, selu h > 0 ? s : h + s*alpha, tanh 1 - h^2, sigmoid h(1 - h).
//
// The trap: the TPU grid runs in order and adds every tile's parameter
// gradients into one block (:211-219). Hopper's blocks run concurrently, so
// K2 is two kernels with no float atomics, and two runs give the same bits:
//   Phase 1 (one block per 16-row tile): recompute the forward with each
//     layer's input h_j in shared memory, then backprop. Each layer's
//     LayerNorm output `post` [N, in] and Linear cotangent dz [N, out] go to
//     a scratch buffer; the tile's column sums for dscale, dbias and db go
//     to a per-block partials buffer; dx is written directly.
//   Phase 2: dW_j = post_j^T dz_j, tiled over (in, out) in 64 x 64 tiles,
//     each summing the rows in order; and the per-block partials summed in
//     block order.
// Scratch at the training shape (N = 2,560 rows; widths 136, 512, 256, 128,
// 1): N x (1,032 + 897) floats = 19.8 MB, which stays in the 50 MB L2;
// partials 160 blocks x 2,961 floats = 1.9 MB.
//
// What bounds it: the forward recompute (233,600 multiply-adds a row), the
// dpost products (as many) and dW (as many) make ~3 x 2 x 233,600 = 1.4
// MFLOP a row, 3.6 GFLOP at N = 2,560: 54 us at 67 TFLOP/s of float32
// on CUDA cores, against ~3 MB of compulsory traffic (x, dx, weights,
// gradients), 1 us. So it is bound by operations. All float32 on CUDA
// cores (simple first; tensor cores are later work).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;                                // rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;                        // micro-tile rows
constexpr int kColsPerThread = 4;                        // micro-tile cols
constexpr int kRowGroups = kRows / kRowsPerThread;       // 4
constexpr int kColLanes = kThreads / kRowGroups;         // 64
constexpr int kColsPerPass = kColLanes * kColsPerThread; // 256
constexpr int kMaxLayers = 16;
constexpr float kEps = 1e-5f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kSeluAlpha = 1.6732632423543772f;
constexpr int kTile = 64;   // phase 2: dW tile (in x out)
constexpr int kChunk = 32;  // phase 2: rows per shared-memory stage

struct Dims {
  int n_layers;
  int n_rows;
  int width[kMaxLayers + 1];
  int stride[kMaxLayers + 1];      // width rounded up to a multiple of 4
  int h_off[kMaxLayers];           // shared-memory float offset of h_j
  int stats_off;                   // [n_layers][2][kRows]: mean, rstd
  int work_off;                    // two work buffers [kRows x work_stride]
  int work_stride;
  int small_off[kMaxLayers + 1];   // per-block partials: dscale, dbias, db
  int tile_start[kMaxLayers + 1];  // phase-2 dW tiles, prefix sums
  long long param_off[kMaxLayers]; // [scale, bias, W (in x out), b]
  long long wt_off[kMaxLayers];    // W^T (out x in)
  long long post_off[kMaxLayers];  // scratch: post_j [N, in]
  long long dz_off[kMaxLayers];    // scratch: dz_j [N, out]
};

// Activation codes: 0 elu, 1 relu, 2 selu, 3 tanh, 4 sigmoid (as K1).
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 0: return v > 0.f ? v : expm1f(v);
    case 1: return fmaxf(v, 0.f);
    case 2: return kSeluScale * (v > 0.f ? v : kSeluAlpha * expm1f(v));
    case 3: return tanhf(v);
    default: return 1.f / (1.f + expf(-v));
  }
}

// d act / dz, from the activation's output h.
__device__ __forceinline__ float act_grad(float h, int act) {
  switch (act) {
    case 0: return h > 0.f ? 1.f : h + 1.f;
    case 1: return h > 0.f ? 1.f : 0.f;
    case 2: return h > 0.f ? kSeluScale : h + kSeluScale * kSeluAlpha;
    case 3: return 1.f - h * h;
    default: return h * (1.f - h);
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

// out[r, col] = sum_k in[r, k] * m[k, col] for the tile's kRows rows and
// col < n_cols; `in` is shared [kRows x in_stride] (in_stride % 4 == 0),
// m is global row-major [depth x n_cols]. epi(r, col, acc) stores a value.
template <class Epi>
__device__ __forceinline__ void tile_gemm(const float* in, int in_stride,
                                          int depth,
                                          const float* __restrict__ m,
                                          int n_cols, Epi epi) {
  const int tid = threadIdx.x, rg = tid / kColLanes, cl = tid % kColLanes;
  const float* hrow = in + rg * kRowsPerThread * in_stride;
  for (int c0 = 0; c0 < n_cols; c0 += kColsPerPass) {
    int col[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) col[c] = c0 + cl + c * kColLanes;
    float acc[kRowsPerThread][kColsPerThread] = {};
    int k = 0;
    for (; k + 4 <= depth; k += 4) {
      float4 hv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        hv[i] = *reinterpret_cast<const float4*>(hrow + i * in_stride + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* mk = m + static_cast<size_t>(k + kk) * n_cols;
        float mv[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          mv[c] = col[c] < n_cols ? __ldg(mk + col[c]) : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float hk = component(hv[i], kk);
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c)
            acc[i][c] = fmaf(hk, mv[c], acc[i][c]);
        }
      }
    }
    for (; k < depth; ++k) {
      const float* mk = m + static_cast<size_t>(k) * n_cols;
      float mv[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        mv[c] = col[c] < n_cols ? __ldg(mk + col[c]) : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float hk = hrow[i * in_stride + k];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          acc[i][c] = fmaf(hk, mv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (col[c] >= n_cols) continue;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        epi(rg * kRowsPerThread + i, col[c], acc[i][c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ params,
                    const float* __restrict__ wt, float* __restrict__ dx,
                    float* __restrict__ scratch, float* __restrict__ partials,
                    Dims d, int act, int use_norm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* stats = smem + d.stats_off;
  float* cur = smem + d.work_off;                 // post, then dpost / dh
  float* other = cur + kRows * d.work_stride;     // dz
  const int ws = d.work_stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int n_rows = d.n_rows;
  const int valid = n_rows - row0 < kRows ? static_cast<int>(n_rows - row0)
                                          : kRows;
  float* part = partials + static_cast<long long>(blockIdx.x) *
                               d.small_off[d.n_layers];
  const int f = d.width[0];
  const int n_layers = d.n_layers;

  // The row tile into h_0; rows past n_rows are zeros (and have g = 0).
  {
    float* h0 = smem + d.h_off[0];
    for (int i = tid; i < kRows * f; i += kThreads) {
      const int r = i / f, k = i - r * f;
      h0[r * d.stride[0] + k] = r < valid ? x[(row0 + r) * f + k] : 0.f;
    }
  }
  __syncthreads();

  // ---- forward recompute: h_{j+1} = act(post_j @ W_j + b_j)
  for (int j = 0; j < n_layers; ++j) {
    const int in = d.width[j], out = d.width[j + 1], s_in = d.stride[j];
    const float* scale = params + d.param_off[j];
    const float* bias = scale + in;
    const float* w = bias + in;
    const float* b = w + static_cast<size_t>(in) * out;
    const float* h = smem + d.h_off[j];
    float* mean = stats + (2 * j) * kRows;
    float* rstd = mean + kRows;
    if (use_norm) {
      for (int r = warp; r < kRows; r += kWarps) {
        float s = 0.f, ss = 0.f;
        for (int k = lane; k < in; k += 32) {
          const float v = h[r * s_in + k];
          s += v;
          ss += v * v;
        }
        s = warp_sum(s);
        ss = warp_sum(ss);
        const float mu = s / in;
        const float rs = rsqrtf(fmaxf(ss / in - mu * mu, 0.f) + kEps);
        for (int k = lane; k < in; k += 32)
          cur[r * ws + k] = (h[r * s_in + k] - mu) * rs * scale[k] + bias[k];
        if (lane == 0) {
          mean[r] = mu;
          rstd[r] = rs;
        }
      }
    } else {
      for (int i = tid; i < kRows * in; i += kThreads) {
        const int r = i / in, k = i - r * in;
        cur[r * ws + k] = h[r * s_in + k];
      }
    }
    __syncthreads();
    float* post = scratch + d.post_off[j];
    for (int i = tid; i < valid * in; i += kThreads) {
      const int r = i / in, k = i - r * in;
      post[(row0 + r) * in + k] = cur[r * ws + k];
    }
    if (j + 1 < n_layers) {
      float* hn = smem + d.h_off[j + 1];
      const int s_out = d.stride[j + 1];
      tile_gemm(cur, ws, in, w, out, [&](int r, int c, float acc) {
        hn[r * s_out + c] = activate(acc + b[c], act);
      });
    }
    __syncthreads();
  }

  // ---- backward, from the scores' cotangent down to dx
  for (int r = tid; r < kRows; r += kThreads)
    other[r * ws] = r < valid ? g[row0 + r] : 0.f;
  for (int j = n_layers - 1; j >= 0; --j) {
    __syncthreads();
    const int in = d.width[j], out = d.width[j + 1], s_in = d.stride[j];
    const float* scale = params + d.param_off[j];
    const float* wtj = wt + d.wt_off[j];
    const float* h = smem + d.h_off[j];
    const float* mean = stats + (2 * j) * kRows;
    const float* rstd = mean + kRows;
    float* pj = part + d.small_off[j];
    const float* dz = other;

    float* dzs = scratch + d.dz_off[j];
    for (int i = tid; i < valid * out; i += kThreads) {
      const int r = i / out, c = i - r * out;
      dzs[(row0 + r) * out + c] = dz[r * ws + c];
    }
    for (int c = tid; c < out; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += dz[r * ws + c];
      pj[2 * in + c] = s;  // db
    }
    // dpost = dz @ W^T
    tile_gemm(dz, ws, out, wtj, in,
              [&](int r, int c, float acc) { cur[r * ws + c] = acc; });
    __syncthreads();
    if (use_norm) {
      for (int k = tid; k < in; k += kThreads) {
        float sd = 0.f, sb = 0.f;
        for (int r = 0; r < kRows; ++r) {
          const float nhat = (h[r * s_in + k] - mean[r]) * rstd[r];
          const float dp = cur[r * ws + k];
          sd += dp * nhat;
          sb += dp;
        }
        pj[k] = sd;       // dscale
        pj[in + k] = sb;  // dbias
      }
      __syncthreads();
      for (int r = warp; r < kRows; r += kWarps) {
        const float mu = mean[r], rs = rstd[r];
        float m1 = 0.f, m2 = 0.f;
        for (int k = lane; k < in; k += 32) {
          const float nhat = (h[r * s_in + k] - mu) * rs;
          const float dn = cur[r * ws + k] * scale[k];
          m1 += dn;
          m2 += dn * nhat;
        }
        m1 = warp_sum(m1) / in;
        m2 = warp_sum(m2) / in;
        for (int k = lane; k < in; k += 32) {
          const float nhat = (h[r * s_in + k] - mu) * rs;
          const float dn = cur[r * ws + k] * scale[k];
          cur[r * ws + k] = rs * (dn - m1 - nhat * m2);
        }
      }
    } else {
      for (int k = tid; k < in; k += kThreads) {
        pj[k] = 0.f;
        pj[in + k] = 0.f;
      }
    }
    __syncthreads();
    if (j > 0) {
      // dz_{j-1} = dh * act'(z_{j-1}), with h_j = act(z_{j-1}).
      for (int i = tid; i < kRows * in; i += kThreads) {
        const int r = i / in, k = i - r * in;
        cur[r * ws + k] *= act_grad(h[r * s_in + k], act);
      }
      float* t = cur;
      cur = other;
      other = t;
    } else {
      for (int i = tid; i < valid * in; i += kThreads) {
        const int r = i / in, k = i - r * in;
        dx[(row0 + r) * in + k] = cur[r * ws + k];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_reduce_kernel(const float* __restrict__ scratch,
                      const float* __restrict__ partials,
                      float* __restrict__ dparams, int n_row_blocks, Dims d) {
  const int tid = threadIdx.x;
  const int n_layers = d.n_layers;
  const int n_tiles = d.tile_start[n_layers];
  const int bid = blockIdx.x;
  if (bid < n_tiles) {
    // dW_j tile: rows i0.. of `in`, columns c0.. of `out`.
    __shared__ float as[kChunk][kTile];
    __shared__ float bs[kChunk][kTile];
    int j = 0;
    while (bid >= d.tile_start[j + 1]) ++j;
    const int in = d.width[j], out = d.width[j + 1];
    const int tiles_out = (out + kTile - 1) / kTile;
    const int local = bid - d.tile_start[j];
    const int i0 = (local / tiles_out) * kTile, c0 = (local % tiles_out) * kTile;
    const float* post = scratch + d.post_off[j];
    const float* dz = scratch + d.dz_off[j];
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4] = {};
    for (int n0 = 0; n0 < d.n_rows; n0 += kChunk) {
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile;
        const long long n = n0 + r;
        const bool row_ok = n < d.n_rows;
        as[r][c] = row_ok && i0 + c < in ? post[n * in + i0 + c] : 0.f;
        bs[r][c] = row_ok && c0 + c < out ? dz[n * out + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kChunk; ++r) {
        float a[4], bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = as[r][ty + 16 * q];
          bv[q] = bs[r][tx + 16 * q];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], bv[q], acc[p][q]);
      }
      __syncthreads();
    }
    float* dw = dparams + d.param_off[j] + 2 * in;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = i0 + ty + 16 * p;
      if (i >= in) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + tx + 16 * q;
        if (c < out) dw[static_cast<long long>(i) * out + c] = acc[p][q];
      }
    }
    return;
  }
  // dscale, dbias, db: the per-block partials summed in block order.
  const int total = d.small_off[n_layers];
  const int e = (bid - n_tiles) * kThreads + tid;
  if (e >= total) return;
  float s = 0.f;
  for (int blk = 0; blk < n_row_blocks; ++blk)
    s += partials[static_cast<long long>(blk) * total + e];
  int j = 0;
  while (e >= d.small_off[j + 1]) ++j;
  const int in = d.width[j], out = d.width[j + 1];
  const int local = e - d.small_off[j];
  const long long dst = local < 2 * in
      ? d.param_off[j] + local
      : d.param_off[j] + 2 * in + static_cast<long long>(in) * out +
            (local - 2 * in);
  dparams[dst] = s;
}

bool make_dims(const int* widths, int n_layers, int n_rows, Dims* d) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows < 0) return false;
  d->n_layers = n_layers;
  d->n_rows = n_rows;
  int max_width = 0;
  for (int j = 0; j <= n_layers; ++j) {
    if (widths[j] < 1) return false;
    d->width[j] = widths[j];
    d->stride[j] = (widths[j] + 3) & ~3;
    max_width = widths[j] > max_width ? widths[j] : max_width;
  }
  if (widths[n_layers] != 1) return false;
  d->work_stride = (max_width + 3) & ~3;
  d->stats_off = 0;
  int off = 2 * n_layers * kRows;  // a multiple of 4
  for (int j = 0; j < n_layers; ++j) {
    d->h_off[j] = off;
    off += kRows * d->stride[j];
  }
  d->work_off = off;
  long long p = 0, t = 0, s = 0;
  int small = 0, tiles = 0;
  for (int j = 0; j < n_layers; ++j) {
    const long long in = widths[j], out = widths[j + 1];
    d->param_off[j] = p;
    p += 2 * in + in * out + out;
    d->wt_off[j] = t;
    t += in * out;
    d->post_off[j] = s;
    s += static_cast<long long>(n_rows) * in;
    d->dz_off[j] = s;
    s += static_cast<long long>(n_rows) * out;
    d->small_off[j] = small;
    small += static_cast<int>(2 * in + out);
    d->tile_start[j] = tiles;
    tiles += static_cast<int>(((in + kTile - 1) / kTile) *
                              ((out + kTile - 1) / kTile));
  }
  d->small_off[n_layers] = small;
  d->tile_start[n_layers] = tiles;
  return true;
}

size_t smem_bytes(const Dims& d) {
  return (static_cast<size_t>(d.work_off) + 2ull * kRows * d.work_stride) *
         sizeof(float);
}

long long row_blocks(int n_rows) { return (n_rows + kRows - 1) / kRows; }

}  // namespace

extern "C" {

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ultra_mlp_bwd_max_layers() { return kMaxLayers; }

// Sizes (in floats, and bytes of dynamic shared memory) that the caller
// allocates for n_rows rows; returns 0, or -1 if the widths are invalid.
int ultra_mlp_bwd_workspace(const int* widths, int n_layers, int n_rows,
                            long long* scratch_floats,
                            long long* partial_floats, long long* smem) {
  Dims d;
  if (!make_dims(widths, n_layers, n_rows, &d)) return -1;
  long long s = 0;
  for (int j = 0; j < n_layers; ++j)
    s += static_cast<long long>(n_rows) * (widths[j] + widths[j + 1]);
  *scratch_floats = s;
  *partial_floats = row_blocks(n_rows) * d.small_off[n_layers];
  *smem = static_cast<long long>(smem_bytes(d));
  return 0;
}

// dx [n_rows, widths[0]] and dparams (K1's packed layout) from x, g [n_rows],
// params (K1's packed layout) and wt (each layer's W as [out, in], one after
// the other), on `stream`. scratch and partials are sized by
// ultra_mlp_bwd_workspace. Returns cudaGetLastError() after the launches.
int ultra_mlp_bwd(const float* x, const float* g, const float* params,
                  const float* wt, float* dx, float* dparams, float* scratch,
                  float* partials, int n_rows, const int* widths,
                  int n_layers, int act, int use_norm, void* stream) {
  Dims d;
  if (n_rows < 1 || !make_dims(widths, n_layers, n_rows, &d))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = row_blocks(n_rows);
  mlp_bwd_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      x, g, params, wt, dx, scratch, partials, d, act, use_norm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int small = d.small_off[n_layers];
  const unsigned grid = static_cast<unsigned>(
      d.tile_start[n_layers] + (small + kThreads - 1) / kThreads);
  mlp_bwd_reduce_kernel<<<grid, kThreads, 0, s>>>(
      scratch, partials, dparams, static_cast<int>(blocks), d);
  return cudaGetLastError();
}

}  // extern "C"
