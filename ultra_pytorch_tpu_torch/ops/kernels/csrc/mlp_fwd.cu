// K1: fused MLP forward for the DNN ranker, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of ultra_pytorch_tpu/ops/pallas/mlp.py:91
// (launched by `_forward_pallas`, pallas_call at :118). It computes, for
// every row of x [N, F], the DNN's whole layer chain: per layer LayerNorm
// (clamped one-pass variance E[x^2]-E[x]^2, eps 1e-5) with its affine,
// then h @ W^T + b, then the activation on every layer but the last. The
// last layer has width 1 and yields the row's score.
//
// Saving mode (a residual buffer given, where autograd will call the
// backward): K1 also writes what K2 (csrc/mlp_bwd.cu) backpropagates
// from, in the layout of `residual_plan` (mlp_common.cuh): each layer's
// LayerNorm output post_j, its input h_j (j >= 1) and each row's mean and
// rstd, or post_j alone without LayerNorm. At the training widths that is
// 1,936 floats a row, 19.8 MB at 2,560 rows and 238 MB at 30,720; the
// values are the very ones the scores are computed from, and the scores
// are the same bits with or without saving. Without a buffer (serving,
// validation, anything under no_grad) nothing is written but the scores.
//
// What bounds it: at the serving shape F = 136, widths 512/256/128/1 the
// chain is 233,600 multiply-adds per row: 15.57 GFLOP at N = 32,768 rows
// and 1.22 GFLOP at a training step's 2,560. Bound at 3xTF32 (165 TFLOP/s
// effective): 0.094 ms and 0.0074 ms; at float32 on CUDA cores (67
// TFLOP/s): 0.232 and 0.018 ms. Traffic is 19 MB (features in, 0.93 MB of
// weights, scores out), 6 us at 3.35 TB/s, so it is bound by operations.
//
// Design (mlp_common.cuh holds the shared pieces):
//   * Products on the tensor cores at float32 accuracy (3xTF32 through
//     mma.sync m16n8k8). LayerNorm statistics, the affine, the activation
//     and the width-1 output layer stay float32 on CUDA cores, fused around
//     the products. The previous kernel did every FMA on CUDA cores, so 67
//     TFLOP/s was its ceiling.
//   * Weights are staged in shared memory, 16 or 32 deep, in a ring of
//     three stages loaded with cp.async two chunks ahead, and every row of
//     the tile reuses each staged weight. The previous kernel issued an
//     __ldg of W from L2 for every 32 FMAs of a thread and shared nothing
//     between warps. W is read as nn.Linear's [out, in] tensor itself: the
//     TF32 `col` B operand is K-major.
//   * Rows per block R = 16, 32 or 64 (one template instance each), chosen
//     by the caller from N so that the busiest SM gets the fewest rows:
//     2,560 rows run 80 32-row blocks of 16 warps (160 16-row blocks of 8
//     warps would put two on 28 SMs, which measured slower), and 32,768
//     rows run 512 64-row blocks of 16 warps, which read the weights from
//     L2 half as often as 32-row tiles (0.48 GB instead of 0.95 GB). The
//     previous kernel ran 32 rows on 8 warps, one block an SM.
//   * The tile's activations live in two buffers sized per layer (buffer p
//     holds the inputs of the layers j with j % 2 == p): 776 floats a row at
//     the serving widths, 194 KB for 64 rows, instead of two max-width
//     buffers. No intermediate goes back to device memory.
//   * Bias values are read when a pass starts, the LayerNorm affine and the
//     output layer's weights are staged in shared memory, and the
//     activation is chosen once per loop, not per element: a global load
//     per element, or a switch (an indirect jump) per element, left the
//     tile's warps waiting in the epilogue and the LayerNorm.
//   * Widths that are no multiple of 8 are zero-padded in shared memory (k
//     and n of the MMA); the ragged last tile loads zero rows that are never
//     written out.
//
// Parameters arrive as 4 * n_layers device pointers, per layer
// [LayerNorm scale (in), LayerNorm bias (in), W (out x in), b (out)].

#include "mlp_common.cuh"

namespace {

using namespace mlp;

// kSave: the saving mode, its own instance, so that the scoring one
// carries no store or branch of it.
template <int R, bool kSave>
__global__ void __launch_bounds__(Tile<R>::kThreads, R == 16 ? 2 : 1)
mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ res, Residual rp, int n_rows, Net net,
               Smem sm, int act, int use_norm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* stage = smem + sm.stage_off;
  constexpr int kCap = kStages * Tile<R>::kStage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int valid = n_rows - row0 < R ? static_cast<int>(n_rows - row0) : R;
  const int f = net.width[0];

  load_rows<R>(x + row0 * f, f, valid, smem + sm.buf_off[0], sm.stride[0]);
  __syncthreads();

  for (int j = 0; j < net.n_layers; ++j) {
    const Layer& L = net.layer[j];
    const int in = net.width[j], width = net.width[j + 1];
    float* cur = smem + sm.buf_off[j % 2];
    const int s = sm.stride[j % 2];
    if constexpr (kSave) {
      float* post = res + rp.post_off[j] + row0 * in;
      if (use_norm) {
        layer_norm_rows<R>(cur, s, in, L.scale, L.bias,
                           res + rp.mean_off[j] + row0,
                           res + rp.rstd_off[j] + row0,
                           j ? res + rp.h_off[j] + row0 * in : nullptr, post,
                           valid, stage, kCap);
        __syncthreads();
      } else {
        for (int i = threadIdx.x; i < valid * in; i += Tile<R>::kThreads) {
          const int r = i / in, k = i - r * in;
          post[i] = cur[r * s + k];
        }
      }
    } else if (use_norm) {
      layer_norm_rows<R>(cur, s, in, L.scale, L.bias, nullptr, nullptr,
                         nullptr, nullptr, 0, stage, kCap);
      __syncthreads();
    }
    if (j == net.n_layers - 1) {
      // Width-1 output layer: one warp per row, a dot product.
      const float* w = stage_vector<R>(L.w, in, stage, kCap);
      for (int r = warp; r < R; r += Tile<R>::kWarps) {
        const float* h = cur + r * s;
        float acc = 0.f;
#pragma unroll 4
        for (int k = lane; k < in; k += 32) acc += h[k] * w[k];
        acc = warp_sum(acc);
        if (lane == 0 && r < valid) out[row0 + r] = acc + L.b[0];
      }
      return;
    }
    block_gemm<R, false>(cur, s, in, L.w, in, width, stage,
                         smem + sm.buf_off[(j + 1) % 2],
                         sm.stride[(j + 1) % 2], L.b, act);
    __syncthreads();
  }
}

template <int R, bool kSave>
int launch_mode(const float* x, float* out, float* res, const Residual& rp,
                int n_rows, const Net& net, int act, int use_norm,
                cudaStream_t stream) {
  const Smem sm = smem_layout<R>(net, false);
  const size_t bytes = static_cast<size_t>(sm.total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<R, kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((n_rows + R - 1) / R);
  mlp_fwd_kernel<R, kSave><<<grid, Tile<R>::kThreads, bytes, stream>>>(
      x, out, res, rp, n_rows, net, sm, act, use_norm);
  return cudaGetLastError();
}

template <int R>
int launch(const float* x, float* out, float* res, const Residual& rp,
           int n_rows, const Net& net, int act, int use_norm,
           cudaStream_t stream) {
  return res ? launch_mode<R, true>(x, out, res, rp, n_rows, net, act,
                                    use_norm, stream)
             : launch_mode<R, false>(x, out, res, rp, n_rows, net, act,
                                     use_norm, stream);
}

long long smem_bytes(const Net& net, int rows) {
  switch (rows) {
    case 16: return smem_layout<16>(net, false).total * 4LL;
    case 32: return smem_layout<32>(net, false).total * 4LL;
    case 64: return smem_layout<64>(net, false).total * 4LL;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block of `rows` rows (16, 32 or 64) needs for
// these widths; 0 if the widths or rows are invalid.
long long ultra_mlp_fwd_smem_bytes(const int* widths, int n_layers,
                                   int rows) {
  Net net;
  const void* none[4 * kMaxLayers] = {};
  return make_net(widths, n_layers, none, &net) ? smem_bytes(net, rows) : 0;
}

int ultra_mlp_fwd_max_layers() { return kMaxLayers; }

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scores n_rows rows of x [n_rows, widths[0]] into out [n_rows] on
// `stream`, `rows` rows a block. widths (host memory) holds n_layers + 1
// entries, the last 1; params (host memory) the 4 * n_layers device
// pointers. With `residual` (res_floats floats, which must be
// `residual_plan`'s total for these rows) the forward's residuals for K2
// go there too; null saves nothing. Returns cudaGetLastError() after the
// launch.
int ultra_mlp_fwd(const float* x, const void* const* params, float* out,
                  float* residual, long long res_floats, int n_rows,
                  const int* widths, int n_layers, int rows, int act,
                  int use_norm, void* stream) {
  Net net;
  if (!make_net(widths, n_layers, params, &net) || n_rows < 1)
    return cudaErrorInvalidValue;
  const Residual rp = residual_plan(net, n_rows, use_norm);
  if (residual && res_floats != rp.total) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 16:
      return launch<16>(x, out, residual, rp, n_rows, net, act, use_norm, s);
    case 32:
      return launch<32>(x, out, residual, rp, n_rows, net, act, use_norm, s);
    case 64:
      return launch<64>(x, out, residual, rp, n_rows, net, act, use_norm, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
