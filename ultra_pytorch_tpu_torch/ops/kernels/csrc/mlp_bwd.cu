// K2: fused MLP backward for the DNN ranker, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of ultra_pytorch_tpu/ops/pallas/mlp.py:155
// (launched by `_backward_pallas`, pallas_call at :254; custom_vjp
// `_fused_bwd` :267). Given x [N, F], the scores' cotangent g [N] and the
// residuals that K1 (csrc/mlp_fwd.cu) saved in its forward, it
// backpropagates through every layer's activation, Linear and LayerNorm.
// It writes dx [N, F] and one gradient per parameter into one buffer, per
// layer [dscale (in), dbias (in), dW (out x in, nn.Linear's layout), db
// (out)].
//
// The residuals (`residual_plan`, mlp_common.cuh): each layer's LayerNorm
// output post_j [N, in], its input h_j [N, in] (j >= 1) and each row's mean
// and rstd; without LayerNorm post_j alone. The TPU kernel recomputes the
// forward per row tile, which fits its VMEM; here K1 writes these tensors
// as it computes the scores, so K2 starts at the backward and runs no
// forward product.
//
// The LayerNorm backward is the TPU kernel's formula (:196-203) on the
// clamped one-pass variance:
//   dh = rstd * (dnhat - mean(dnhat) - nhat * mean(dnhat * nhat)),
//   dnhat = dpost * scale.
// Activation derivatives are taken from the activation's output h = act(z)
// (mlp_common.cuh `act_grad`).
//
// The TPU grid runs in order and adds every tile's parameter gradients into
// one block (:211-219). Hopper's blocks run concurrently, so K2 is three
// kernels with no float atomics, and two runs give the same bits:
//   Phase 1 (one block per row tile of 16, 32 or 64 rows): from the tile's
//     mean and rstd, copied to shared memory, and dpost of the width-1
//     layer (g * w), down the layers: LayerNorm backward and activation
//     derivatives on CUDA cores, reading h_j from the residual, and dpost =
//     dz @ W on the tensor cores (3xTF32, as K1). Each layer's Linear
//     cotangent dz_j [N, out] goes to a scratch buffer; the tile's column
//     sums for dscale, dbias and db go to a per-block partials buffer; dx
//     is written directly. A tile holds K1's two activation buffers and its
//     statistics, so tiles of 32 rows on 16 warps (a training step: 80
//     blocks) or 64 rows fit.
//   Phase 2: dW_j = dz_j^T post_j on the tensor cores (3xTF32), post_j from
//     the residual, in 64 x 64 tiles of [out, in], with the rows split into
//     fixed chunks (chosen by the caller) so that tiles x chunks give four
//     blocks per SM.
//   Phase 3: the chunk partials of dW summed in chunk order, and the
//     per-block partials of dscale, dbias and db in block order.
//
// What bounds it: dpost and dW are 2 x 233,600 multiply-adds a row at the
// training widths (136, 512, 256, 128, 1), 2.39 GFLOP at N = 2,560 rows,
// and with LayerNorm, activation and bias work 2.43 GFLOP. Bound at 3xTF32
// (165 TFLOP/s effective): 0.0147 ms; at float32 on CUDA cores (67
// TFLOP/s): 0.036 ms. It reads the 19.8 MB residual, writes and rereads
// its 9.2 MB of dz scratch (in the 50 MB L2), and moves 4.7 MB of x, dx,
// weights and gradients: 42.9 MB, 0.0128 ms at 3.35 TB/s even if none of
// it stayed in L2. So it is bound by operations.

#include "mlp_common.cuh"

namespace {

using namespace mlp;

constexpr int kTo = 64;    // phase 2: dW tile, rows of [out, in]
constexpr int kTi = 64;    // phase 2: dW tile, columns
constexpr int kKr = 32;    // phase 2: rows of N a stage
constexpr int kP2Threads = 128;
constexpr int kReduceThreads = 256;
constexpr int kAs = kTo + 8;   // stage strides = 8 (mod 32): conflict-free
constexpr int kBs = kTi + 8;
constexpr int kP2Stage = kKr * (kAs + kBs);

struct Plan {
  int n_rows;
  int n_blocks;                        // phase 1 row blocks
  int chunks, chunk_rows;              // phase 2 row chunks
  int small;                           // partial floats per row block
  long long dw_total;                  // dW floats of one chunk
  long long dz_off[kMaxLayers];        // scratch: dz_j [N, out]
  long long scratch;                   // scratch floats
  int small_off[kMaxLayers + 1];       // per block: dscale, dbias, db
  long long dw_off[kMaxLayers + 1];    // a chunk's dW_j [out, in]
  long long grad_off[kMaxLayers + 1];  // dparams: dscale, dbias, dW, db
  int tile_start[kMaxLayers + 1];      // phase 2 tiles, prefix sums
};

Plan make_plan(const Net& net, int n_rows, int rows, int chunks) {
  Plan p;
  const int n_layers = net.n_layers;
  p.n_rows = n_rows;
  p.n_blocks = (n_rows + rows - 1) / rows;
  const int per_chunk = (n_rows + chunks - 1) / chunks;
  p.chunk_rows = round_up(per_chunk > 0 ? per_chunk : 1, kKr);
  p.chunks = n_rows > 0 ? (n_rows + p.chunk_rows - 1) / p.chunk_rows : 1;
  long long s = 0, dw = 0, grad = 0;
  int small = 0, tiles = 0;
  for (int j = 0; j < n_layers; ++j) {
    const long long in = net.width[j], out = net.width[j + 1];
    p.dz_off[j] = s;
    s += round4(n_rows * out);
    p.small_off[j] = small;
    small += static_cast<int>(2 * in + out);
    p.dw_off[j] = dw;
    dw += out * in;
    p.grad_off[j] = grad;
    grad += 2 * in + out * in + out;
    p.tile_start[j] = tiles;
    tiles += static_cast<int>(((out + kTo - 1) / kTo) * ((in + kTi - 1) / kTi));
  }
  p.scratch = s;
  p.small = small;
  p.small_off[n_layers] = small;
  p.dw_total = dw;
  p.dw_off[n_layers] = dw;
  p.grad_off[n_layers] = grad;
  p.tile_start[n_layers] = tiles;
  return p;
}

template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads, R == 16 ? 2 : 1)
mlp_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ res, Residual rp,
                    float* __restrict__ dx, float* __restrict__ scratch,
                    float* __restrict__ partials, Net net, Smem sm, Plan plan,
                    int act, int use_norm) {
  constexpr int kT = Tile<R>::kThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* stage = smem + sm.stage_off;
  float* stats = smem + sm.stats_off;   // [n_layers][2][R]: mean, rstd
  constexpr int kCap = kStages * Tile<R>::kStage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int valid = plan.n_rows - row0 < R
                        ? static_cast<int>(plan.n_rows - row0) : R;
  const int f = net.width[0], n_layers = net.n_layers;
  float* part = partials + static_cast<long long>(blockIdx.x) * plan.small;

  // ---- the tile's mean and rstd of every layer, from K1's residual
  if (use_norm) {
    for (int i = tid; i < n_layers * valid; i += kT) {
      const int j = i / valid, r = i - j * valid;
      stats[2 * j * R + r] = res[rp.mean_off[j] + row0 + r];
      stats[(2 * j + 1) * R + r] = res[rp.rstd_off[j] + row0 + r];
    }
  }

  // ---- the width-1 output layer: dz = g, dpost = g * w, and zeros in
  // the columns up to round_up(in, 8) that the product's last k step reads
  // (block_gemm writes them as zeros in every later buffer).
  {
    const int j = n_layers - 1, in = net.width[j], s = sm.stride[j % 2];
    const int in8 = round_up(in, 8);
    float* p = smem + sm.buf_off[j % 2];
    const float* w = net.layer[j].w;
    float* dzs = scratch + plan.dz_off[j] + row0;
    for (int r = tid; r < valid; r += kT) dzs[r] = g[row0 + r];
    if (tid == 0) {
      float db = 0.f;
      for (int r = 0; r < valid; ++r) db += g[row0 + r];
      part[plan.small_off[j] + 2 * in] = db;
    }
    for (int i = tid; i < R * in8; i += kT) {
      const int r = i / in8, k = i - r * in8;
      p[r * s + k] = r < valid && k < in ? g[row0 + r] * w[k] : 0.f;
    }
    __syncthreads();
  }

  // ---- backward, from dpost_j (in buffer j % 2) down to dx. Rows past
  // n_rows have g = 0, so their dpost and dz stay 0 and are skipped.
  for (int j = n_layers - 1; j >= 0; --j) {
    const int in = net.width[j], s = sm.stride[j % 2];
    float* p = smem + sm.buf_off[j % 2];
    const float* h = j == 0 ? x + row0 * f
                            : res + (use_norm ? rp.h_off[j] : rp.post_off[j]) +
                                  row0 * in;
    float* pj = part + plan.small_off[j];
    if (use_norm) {
      const float* mean = stats + 2 * j * R;
      const float* rstd = mean + R;
      const float* scale =
          stage_vector<R>(net.layer[j].scale, in, stage, kCap);
      for (int k = tid; k < in; k += kT) {
        float sd = 0.f, sb = 0.f;
#pragma unroll 8
        for (int r = 0; r < valid; ++r) {
          const float nhat = (h[r * in + k] - mean[r]) * rstd[r];
          const float dp = p[r * s + k];
          sd += dp * nhat;
          sb += dp;
        }
        pj[k] = sd;       // dscale
        pj[in + k] = sb;  // dbias
      }
      __syncthreads();
      const float inv_in = 1.f / in;
      with_act(j ? act : -1, [&](auto A) {
        for (int r = warp; r < valid; r += kT / 32) {
          float* pr = p + r * s;
          const float* hr = h + static_cast<long long>(r) * in;
          const float mu = mean[r], rs = rstd[r];
          float m1 = 0.f, m2 = 0.f;
#pragma unroll 4
          for (int k = lane; k < in; k += 32) {
            const float nhat = (hr[k] - mu) * rs;
            const float dn = pr[k] * scale[k];
            m1 += dn;
            m2 += dn * nhat;
          }
          m1 = warp_sum(m1) * inv_in;
          m2 = warp_sum(m2) * inv_in;
#pragma unroll 4
          for (int k = lane; k < in; k += 32) {
            const float hv = hr[k];
            const float nhat = (hv - mu) * rs;
            const float dh = rs * (pr[k] * scale[k] - m1 - nhat * m2);
            if constexpr (decltype(A)::value >= 0)
              pr[k] = dh * act_grad<decltype(A)::value>(hv);  // dz_{j-1}
            else
              dx[(row0 + r) * f + k] = dh;
          }
        }
      });
    } else {
      for (int k = tid; k < in; k += kT) {
        pj[k] = 0.f;
        pj[in + k] = 0.f;
      }
      with_act(j ? act : -1, [&](auto A) {
        for (int i = tid; i < valid * in; i += kT) {
          const int r = i / in, k = i - r * in;
          if constexpr (decltype(A)::value >= 0)
            p[r * s + k] *= act_grad<decltype(A)::value>(h[i]);
          else
            dx[row0 * f + i] = p[r * s + k];
        }
      });
    }
    __syncthreads();
    if (j == 0) break;

    // p holds dz_{j-1} [R, in]: to scratch, its column sums (db_{j-1}),
    // then dpost_{j-1} = dz_{j-1} @ W_{j-1} into the other buffer.
    const int prev = net.width[j - 1];
    float* dzs = scratch + plan.dz_off[j - 1] + row0 * in;
    for (int i = tid; i < valid * in; i += kT) {
      const int r = i / in, k = i - r * in;
      dzs[i] = p[r * s + k];
    }
    float* db = part + plan.small_off[j - 1] + 2 * prev;
    for (int c = tid; c < in; c += kT) {
      float sum = 0.f;
      for (int r = 0; r < valid; ++r) sum += p[r * s + c];
      db[c] = sum;
    }
    block_gemm<R, true>(p, s, in, net.layer[j - 1].w, prev, prev, stage,
                        smem + sm.buf_off[(j - 1) % 2],
                        sm.stride[(j - 1) % 2], nullptr, -1);
    __syncthreads();
  }
}

// dW_j tile [o0 .. o0+64) x [i0 .. i0+64) over one chunk of rows:
// sum_n dz_j[n, o] * post_j[n, i], into that chunk's partial.
__global__ void __launch_bounds__(kP2Threads)
mlp_bwd_dw_kernel(const float* __restrict__ scratch,
                  const float* __restrict__ res, Residual rp,
                  float* __restrict__ dw_part, Net net, Plan plan) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // kStages x kP2Stage
  const int tile = blockIdx.x, chunk = blockIdx.y;
  int j = 0;
  while (tile >= plan.tile_start[j + 1]) ++j;
  const int in = net.width[j], out = net.width[j + 1];
  const int tiles_i = (in + kTi - 1) / kTi;
  const int local = tile - plan.tile_start[j];
  const int o0 = (local / tiles_i) * kTo, i0 = (local % tiles_i) * kTi;
  const long long r0 = static_cast<long long>(chunk) * plan.chunk_rows;
  const int n_here = plan.n_rows - r0 < plan.chunk_rows
                         ? static_cast<int>(plan.n_rows - r0)
                         : plan.chunk_rows;
  const float* dz = scratch + plan.dz_off[j] + r0 * out + o0;
  const float* post = res + rp.post_off[j] + r0 * in + i0;
  const bool vec_a = out % 4 == 0, vec_b = in % 4 == 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wo = (warp / 2) * 32, wi = (warp % 2) * 32;
  const int n_k = (n_here + kKr - 1) / kKr;

  auto load = [&](int c) {
    float* a = st + (c % kStages) * kP2Stage;
    const int rows_ok = n_here - c * kKr;
    stage_tile<kP2Threads>(a, kAs, dz + static_cast<long long>(c) * kKr * out,
                           out, kKr, kTo, rows_ok, out - o0, vec_a, scratch);
    stage_tile<kP2Threads>(a + kKr * kAs, kBs,
                           post + static_cast<long long>(c) * kKr * in, in,
                           kKr, kTi, rows_ok, in - i0, vec_b, scratch);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  load(0);
  cp_async_commit();
  if (n_k > 1) load(1);
  cp_async_commit();
  for (int c = 0; c < n_k; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    if (c + 2 < n_k) load(c + 2);
    cp_async_commit();
    const float* A = st + (c % kStages) * kP2Stage;  // dz rows as [n][o]
    const float* B = A + kKr * kAs;                  // post rows as [n][i]
#pragma unroll
    for (int kk = 0; kk < kKr; kk += 8) {
      unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = A + (kk + t) * kAs + wo + mt * 16 + g;
        split_tf32(ap[0], ah[mt][0], al[mt][0]);
        split_tf32(ap[8], ah[mt][1], al[mt][1]);
        split_tf32(ap[4 * kAs], ah[mt][2], al[mt][2]);
        split_tf32(ap[4 * kAs + 8], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bp = B + (kk + t) * kBs + wi + nt * 8 + g;
        split_tf32(bp[0], bh[nt][0], bl[nt][0]);
        split_tf32(bp[4 * kBs], bh[nt][1], bl[nt][1]);
      }
      // Tiles past `out` or `in` multiply the zeros staged there.
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32(acc[mt][nt], term == 0 ? al[mt] : ah[mt],
                     term == 1 ? bl[nt] : bh[nt]);
    }
  }
  float* dw = dw_part + chunk * plan.dw_total + plan.dw_off[j];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + wo + mt * 16 + g + 8 * (e / 2);
        const int i = i0 + wi + nt * 8 + 2 * t + (e % 2);
        if (o < out && i < in)
          dw[static_cast<long long>(o) * in + i] = acc[mt][nt][e];
      }
}

// Every gradient element: dW summed over the chunks in chunk order,
// dscale, dbias and db over the row blocks in block order.
__global__ void __launch_bounds__(kReduceThreads)
mlp_bwd_reduce_kernel(const float* __restrict__ partials,
                      const float* __restrict__ dw_part,
                      float* __restrict__ dparams, Net net, Plan plan) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (e >= plan.grad_off[net.n_layers]) return;
  int j = 0;
  while (e >= plan.grad_off[j + 1]) ++j;
  const long long in = net.width[j], out = net.width[j + 1];
  const long long local = e - plan.grad_off[j];
  float s = 0.f;
  if (local < 2 * in || local >= 2 * in + in * out) {
    const long long idx =
        plan.small_off[j] + (local < 2 * in ? local : local - in * out);
#pragma unroll 8
    for (int b = 0; b < plan.n_blocks; ++b)
      s += partials[static_cast<long long>(b) * plan.small + idx];
  } else {
    const long long idx = plan.dw_off[j] + local - 2 * in;
#pragma unroll 4
    for (int c = 0; c < plan.chunks; ++c) s += dw_part[c * plan.dw_total + idx];
  }
  dparams[e] = s;
}

template <int R>
int launch(const float* x, const float* g, const float* res,
           const Residual& rp, float* dx, float* dparams, float* scratch,
           float* partials, float* dw_part, const Net& net, const Plan& plan,
           int act, int use_norm, cudaStream_t stream) {
  const Smem sm = smem_layout<R>(net, true);
  const size_t bytes = static_cast<size_t>(sm.total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_rows_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  mlp_bwd_rows_kernel<R><<<plan.n_blocks, Tile<R>::kThreads, bytes, stream>>>(
      x, g, res, rp, dx, scratch, partials, net, sm, plan, act, use_norm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int dw_smem = kStages * kP2Stage * sizeof(float);
  err = cudaFuncSetAttribute(mlp_bwd_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dw_smem);
  if (err != cudaSuccess) return err;
  const dim3 tiles(plan.tile_start[net.n_layers], plan.chunks);
  mlp_bwd_dw_kernel<<<tiles, kP2Threads, dw_smem, stream>>>(
      scratch, res, rp, dw_part, net, plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = plan.grad_off[net.n_layers];
  mlp_bwd_reduce_kernel<<<static_cast<unsigned>((total + kReduceThreads - 1) /
                                                kReduceThreads),
                          kReduceThreads, 0, stream>>>(partials, dw_part, dparams,
                                                 net, plan);
  return cudaGetLastError();
}

long long smem_bytes(const Net& net, int rows) {
  switch (rows) {
    case 16: return smem_layout<16>(net, true).total * 4LL;
    case 32: return smem_layout<32>(net, true).total * 4LL;
    case 64: return smem_layout<64>(net, true).total * 4LL;
    default: return 0;
  }
}

}  // namespace

extern "C" {

const char* ultra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ultra_mlp_bwd_max_layers() { return kMaxLayers; }

// Sizes (in floats, and bytes of dynamic shared memory) that the caller
// allocates for n_rows rows, `rows` rows a block (16, 32 or 64) and dW over
// `chunks` row chunks; returns 0, or -1 if an argument is invalid.
int ultra_mlp_bwd_workspace(const int* widths, int n_layers, int n_rows,
                            int rows, int chunks, long long* scratch_floats,
                            long long* partial_floats, long long* dw_floats,
                            long long* smem) {
  Net net;
  const void* none[4 * kMaxLayers] = {};
  if (n_rows < 0 || chunks < 1 || !make_net(widths, n_layers, none, &net))
    return -1;
  const long long bytes = smem_bytes(net, rows);
  if (bytes == 0) return -1;
  const Plan plan = make_plan(net, n_rows, rows, chunks);
  *scratch_floats = plan.scratch;
  *partial_floats = static_cast<long long>(plan.n_blocks) * plan.small;
  *dw_floats = plan.chunks * plan.dw_total;
  *smem = bytes;
  return 0;
}

// dx [n_rows, widths[0]] and dparams (per layer dscale, dbias, dW [out, in],
// db) from x, g [n_rows], the residual K1 saved for the same rows and
// use_norm (res_floats floats, `residual_plan`'s total) and the parameters
// (params: 4 * n_layers device pointers in host memory, per layer
// LayerNorm scale, bias, W [out, in], b), on `stream`. scratch, partials
// and dw_part are sized by ultra_mlp_bwd_workspace for the same rows and
// chunks. Returns cudaGetLastError() after the launches.
int ultra_mlp_bwd(const float* x, const float* g, const float* residual,
                  long long res_floats, const void* const* params, float* dx,
                  float* dparams, float* scratch, float* partials,
                  float* dw_part, int n_rows, const int* widths, int n_layers,
                  int rows, int chunks, int act, int use_norm, void* stream) {
  Net net;
  if (n_rows < 1 || chunks < 1 || !residual ||
      !make_net(widths, n_layers, params, &net))
    return cudaErrorInvalidValue;
  const Residual rp = residual_plan(net, n_rows, use_norm);
  if (res_floats != rp.total) return cudaErrorInvalidValue;
  const Plan plan = make_plan(net, n_rows, rows, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 16: return launch<16>(x, g, residual, rp, dx, dparams, scratch,
                               partials, dw_part, net, plan, act, use_norm, s);
    case 32: return launch<32>(x, g, residual, rp, dx, dparams, scratch,
                               partials, dw_part, net, plan, act, use_norm, s);
    case 64: return launch<64>(x, g, residual, rp, dx, dparams, scratch,
                               partials, dw_part, net, plan, act, use_norm, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
