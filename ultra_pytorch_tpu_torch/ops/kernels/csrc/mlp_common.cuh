// Shared by K1 (mlp_fwd.cu) and K2 (mlp_bwd.cu): the DNN's parameters as
// the kernels read them, the activations, the shared-memory layout of a row
// tile, and the block-wide matrix product on Hopper's tensor cores at
// float32 accuracy (3xTF32).
//
// 3xTF32: each float32 operand x is split in registers into a TF32 part hi
// and the rest lo = x - hi (`split_tf32`), and a * b is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi by three
// `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`, accumulating in
// float32. The dropped a_lo*b_lo term is below 2^-22 of the product, so the
// result keeps float32's accuracy at a third of the TF32 rate.
//
// Why `mma.sync` and not `wgmma`: both operands must be split into hi and
// lo parts before they reach the tensor cores. `wgmma` reads B only from
// shared memory, so B's two parts would have to be staged as two tiles
// (twice the weight stage), and its 64-row warpgroup tiles do not suit the
// 16- and 32-row tiles that small batches need to fill 132 SMs. `mma.sync`
// takes both operands from registers, where the split costs five
// instructions per element. The price: on the H100 an SM issues an m16n8k8
// TF32 `mma.sync` about once every 1.5 clocks (torch_mlp_probe.py),
// so 3xTF32 this way tops out near 105 TFLOP/s, not 165; `wgmma` is the
// way past it.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace mlp {

constexpr int kMaxLayers = 16;
constexpr int kStages = 3;       // weight stages in flight
constexpr float kEps = 1e-5f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kSeluAlpha = 1.6732632423543772f;

// One layer's parameters, read where PyTorch keeps them: LayerNorm scale
// and bias [in], nn.Linear's weight [out, in] and bias [out].
struct Layer {
  const float* scale;
  const float* bias;
  const float* w;
  const float* b;
};

struct Net {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = F, width[n_layers] = 1
  Layer layer[kMaxLayers];
};

// A row tile of R rows. Each warp owns one 16-row MMA tile and 32 columns
// of a pass of kNp columns; a block takes one pass at a time. 16 rows:
// 8 warps, and two blocks fit an SM; 32 and 64 rows: 16 warps, one block
// an SM.
template <int R>
struct Tile {
  static constexpr int kWarpsM = R / 16;
  static constexpr int kWarpsN = R == 64 ? 4 : 8;
  static constexpr int kWarps = kWarpsM * kWarpsN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNp = kWarpsN * 32;
  // Depth of one weight stage: 32 where shared memory has room for three
  // such stages beside the activations (32 rows), else 16.
  static constexpr int kKc = R == 32 ? 32 : 16;
  static constexpr int kKs = kKc + 4;   // stage row stride, W as [n][k]
  static constexpr int kNs = kNp + 8;   // stage row stride, W as [k][n]
  static constexpr int kStage =
      kNp * kKs > kKc * kNs ? kNp * kKs : kKc * kNs;
  static_assert(R == 16 || R == 32 || R == 64, "rows per block");
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row stride of an activation buffer for widths up to w: room for the
// zero-padded k of the last MMA step, and = 4 (mod 8), so that the eight
// row groups of an MMA fragment load fall on distinct banks.
__host__ __device__ inline int act_stride(int w) {
  return round_up(w, 8) + 4;
}

// Shared memory of a row tile, in floats: two activation buffers (buffer
// p holds the inputs of the layers j with j % 2 == p, so each is sized by
// its own layers), kStages weight stages, then (K2) each layer's mean and
// rstd of the tile's rows, copied from the residual.
struct Smem {
  int stride[2];
  int buf_off[2];
  int stage_off;
  int stats_off;
  int total;  // floats
};

template <int R>
inline Smem smem_layout(const Net& net, bool stats) {
  Smem s;
  int widest[2] = {0, 0};
  for (int j = 0; j < net.n_layers; ++j)
    widest[j % 2] = net.width[j] > widest[j % 2] ? net.width[j] : widest[j % 2];
  s.stride[0] = act_stride(widest[0]);
  s.stride[1] = widest[1] ? act_stride(widest[1]) : 0;
  s.buf_off[0] = 0;
  s.buf_off[1] = R * s.stride[0];
  s.stage_off = s.buf_off[1] + R * s.stride[1];
  s.stats_off = s.stage_off + kStages * Tile<R>::kStage;
  s.total = s.stats_off + (stats ? 2 * net.n_layers * R : 0);
  return s;
}

__host__ __device__ inline long long round4(long long v) {
  return (v + 3) / 4 * 4;
}

// The forward's residuals that K1 saves for K2, for n_rows rows, as
// offsets in floats into one buffer: per layer j its LayerNorm output
// post_j [N, in] (the layer's input where there is no LayerNorm), and with
// LayerNorm its input h_j [N, in] for j >= 1 (h_0 is x) and each row's
// mean and rstd [N]. Every part starts on 16 bytes.
struct Residual {
  long long post_off[kMaxLayers];
  long long h_off[kMaxLayers];
  long long mean_off[kMaxLayers];
  long long rstd_off[kMaxLayers];
  long long total;  // floats
};

inline Residual residual_plan(const Net& net, long long n_rows,
                              bool use_norm) {
  Residual r;
  long long s = 0;
  for (int j = 0; j < net.n_layers; ++j) {
    const long long in = net.width[j];
    r.post_off[j] = s;
    s += round4(n_rows * in);
    r.h_off[j] = r.mean_off[j] = r.rstd_off[j] = -1;
    if (!use_norm) continue;
    if (j) {
      r.h_off[j] = s;
      s += round4(n_rows * in);
    }
    r.mean_off[j] = s;
    s += round4(n_rows);
    r.rstd_off[j] = s;
    s += round4(n_rows);
  }
  r.total = s;
  return r;
}

inline bool make_net(const int* widths, int n_layers,
                     const void* const* params, Net* net) {
  if (n_layers < 1 || n_layers > kMaxLayers || widths[n_layers] != 1)
    return false;
  net->n_layers = n_layers;
  for (int j = 0; j <= n_layers; ++j) {
    if (widths[j] < 1) return false;
    net->width[j] = widths[j];
  }
  for (int j = 0; j < n_layers; ++j) {
    net->layer[j].scale = static_cast<const float*>(params[4 * j]);
    net->layer[j].bias = static_cast<const float*>(params[4 * j + 1]);
    net->layer[j].w = static_cast<const float*>(params[4 * j + 2]);
    net->layer[j].b = static_cast<const float*>(params[4 * j + 3]);
  }
  return true;
}

// Activation codes: 0 elu, 1 relu, 2 selu, 3 tanh, 4 sigmoid. For v <= 0,
// expm1(v) is taken as expf(v) - 1: off by at most ~1e-7 in absolute
// terms, and a fifth of expm1f's instructions.
template <int A>
__device__ __forceinline__ float activate(float v) {
  if constexpr (A == 0) return v > 0.f ? v : expf(v) - 1.f;
  if constexpr (A == 1) return fmaxf(v, 0.f);
  if constexpr (A == 2)
    return kSeluScale * (v > 0.f ? v : kSeluAlpha * (expf(v) - 1.f));
  if constexpr (A == 3) return tanhf(v);
  if constexpr (A == 4) return 1.f / (1.f + expf(-v));
  return v;
}

// d act / dz, from the activation's output h: elu h > 0 ? 1 : h + 1
// (= exp(z)), relu h > 0, selu h > 0 ? s : h + s*alpha, tanh 1 - h^2,
// sigmoid h(1 - h).
template <int A>
__device__ __forceinline__ float act_grad(float h) {
  if constexpr (A == 0) return h > 0.f ? 1.f : h + 1.f;
  if constexpr (A == 1) return h > 0.f ? 1.f : 0.f;
  if constexpr (A == 2) return h > 0.f ? kSeluScale : h + kSeluScale * kSeluAlpha;
  if constexpr (A == 3) return 1.f - h * h;
  if constexpr (A == 4) return h * (1.f - h);
  return 1.f;
}

template <int A>
using Act = std::integral_constant<int, A>;

// f(Act<act>{}) with the activation code as a constant: one branch for a
// whole loop, where a switch per element costs an indirect jump each
// (-1: no activation).
template <class F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case 0: f(Act<0>{}); break;
    case 1: f(Act<1>{}); break;
    case 2: f(Act<2>{}); break;
    case 3: f(Act<3>{}); break;
    case 4: f(Act<4>{}); break;
    default: f(Act<-1>{}); break;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- cp.async: global -> shared without registers; src-size 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, n_rows) x columns [0, n_cols) of a tile of global `src`
// (row-major, leading dimension ld, tile origin already applied) into
// shared `dst` (row stride ds); `rows_ok` / `cols_ok` rows and columns
// are real, the rest is zero-filled. Vectors of 4 when `vec` (ld and
// the tile origin multiples of 4, n_cols and cols_ok too).
template <int kN>
__device__ __forceinline__ void stage_tile(float* dst, int ds,
                                           const float* src, long long ld,
                                           int n_rows, int n_cols,
                                           int rows_ok, int cols_ok,
                                           bool vec, const float* base) {
  const int tid = threadIdx.x;
  if (vec) {
    const int per_row = n_cols / 4;
    for (int i = tid; i < n_rows * per_row; i += kN) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * ds + c, ok ? src + r * ld + c : base, ok);
    }
  } else {
    for (int i = tid; i < n_rows * n_cols; i += kN) {
      const int r = i / n_cols, c = i - r * n_cols;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(dst + r * ds + c, ok ? src + r * ld + c : base, ok);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- 3xTF32 on the tensor cores
// x rounded to TF32, to nearest with ties away from zero (add half of the
// dropped bits' range to the magnitude, then clear them): what
// `cvt.rna.tf32.f32` computes, in two instructions where that compiles to
// a longer sequence with a check for infinities on sm_90a.
__device__ __forceinline__ unsigned rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with both parts TF32; the pair carries x to ~2^-22 of its
// magnitude.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the block's matrix product
//
// out[r][c] = act(sum_k a[r][k] * B(k, c) + bias[c]) for the tile's R rows
// and c < n_cols, and 0 for n_cols <= c < round_up(n_cols, 8); no bias when
// `bias` is null, no activation when act < 0. `a` is the
// shared activation buffer (row stride sa, zero from column `depth` to
// round_up(depth, 8)); `out` another one (row stride so). B comes from
// global W through the two shared stages:
//   kTrans false: B(k, c) = w[c * ld + k], nn.Linear's [out, in] weight for
//     h @ W^T (the TF32 `col` operand is K-major: exactly that layout);
//   kTrans true:  B(k, c) = w[k * ld + c], the same weight for dz @ W.
// Stages of kKc x kNp weights are loaded with cp.async two chunks ahead of
// the one being multiplied (a ring of kStages, one barrier a chunk), so
// every row of the tile reuses each staged weight and the loads' L2
// latency hides behind two chunks of products. Each thread's bias values
// are read when a pass starts, so their latency hides behind it too.
template <int R, bool kTrans>
__device__ void block_gemm(const float* a, int sa, int depth,
                           const float* __restrict__ w, int ld, int n_cols,
                           float* stage, float* out, int so,
                           const float* __restrict__ bias, int act) {
  using T = Tile<R>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = (warp / T::kWarpsN) * 16;
  const int wc0 = (warp % T::kWarpsN) * 32;
  constexpr int kKc = T::kKc;
  const int n_k = (depth + kKc - 1) / kKc;
  const int n_pass = (n_cols + T::kNp - 1) / T::kNp;
  const int total = n_k * n_pass;
  const bool vec = ld % 4 == 0 && aligned16(w);

  auto load = [&](int c) {
    const int p = c / n_k, k0 = (c - p * n_k) * kKc, n0 = p * T::kNp;
    float* dst = stage + (c % kStages) * T::kStage;
    if constexpr (!kTrans)
      stage_tile<T::kThreads>(dst, T::kKs,
                              w + static_cast<long long>(n0) * ld + k0, ld,
                              T::kNp, kKc, n_cols - n0, depth - k0, vec, w);
    else
      stage_tile<T::kThreads>(dst, T::kNs,
                              w + static_cast<long long>(k0) * ld + n0, ld,
                              kKc, T::kNp, depth - k0, n_cols - n0, vec, w);
  };

  float acc[4][4], bv[4][2];
  load(0);
  cp_async_commit();
  if (total > 1) load(1);
  cp_async_commit();
  for (int c = 0; c < total; ++c) {
    const int p = c / n_k, kc = c - p * n_k;
    const int n0 = p * T::kNp, k0 = kc * kKc;
    if (kc == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wc0 + nt * 8 + 2 * t + e;
          bv[nt][e] = bias && col < n_cols ? bias[col] : 0.f;
        }
      }
    }
    cp_async_wait<1>();  // chunk c has landed (c + 1 may be in flight)
    __syncthreads();     // ... for every thread; chunk c - 1 is done with
    if (c + 2 < total) load(c + 2);  // so its stage takes chunk c + 2
    cp_async_commit();
    const float* st = stage + (c % kStages) * T::kStage;
    if (n0 + wc0 < n_cols) {
#pragma unroll
      for (int kk = 0; kk < kKc; kk += 8) {
        if (k0 + kk >= depth) break;
        unsigned ah[4], al[4], bh[4][2], bl[4][2];
        const float* ap = a + (wr0 + g) * sa + k0 + kk + t;
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8 * sa], ah[1], al[1]);
        split_tf32(ap[4], ah[2], al[2]);
        split_tf32(ap[8 * sa + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float b0, b1;
          if constexpr (!kTrans) {
            const float* bp = st + (wc0 + nt * 8 + g) * T::kKs + kk + t;
            b0 = bp[0];
            b1 = bp[4];
          } else {
            const float* bp = st + (kk + t) * T::kNs + wc0 + nt * 8 + g;
            b0 = bp[0];
            b1 = bp[4 * T::kNs];
          }
          split_tf32(b0, bh[nt][0], bl[nt][0]);
          split_tf32(b1, bh[nt][1], bl[nt][1]);
        }
        // The three products of an accumulator are issued a round of
        // independent MMAs apart, so none waits on the one before. Tiles
        // past n_cols multiply the zeros staged there.
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(acc[nt], term == 0 ? al : ah,
                     term == 1 ? bl[nt] : bh[nt]);
      }
    }
    if (kc == n_k - 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wc0 + nt * 8 + 2 * t;
        if (n0 + wc0 + nt * 8 >= n_cols) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wr0 + g + 8 * half;
          const float v0 = acc[nt][2 * half] + bv[nt][0];
          const float v1 = acc[nt][2 * half + 1] + bv[nt][1];
          *reinterpret_cast<float2*>(out + r * so + col) = make_float2(
              col < n_cols ? v0 : 0.f, col + 1 < n_cols ? v1 : 0.f);
        }
      }
      // The activation, over the same elements, in a loop of its own
      // compiled once per activation.
      if (act >= 0 && n0 + wc0 < n_cols) {
        with_act(act, [&](auto A) {
#pragma unroll 4
          for (int e = 0; e < 8; ++e) {
            const int nt = e / 2, half = e % 2;
            const int col = n0 + wc0 + nt * 8 + 2 * t;
            float* o = out + (wr0 + g + 8 * half) * so + col;
            if (col < n_cols) o[0] = activate<decltype(A)::value>(o[0]);
            if (col + 1 < n_cols) o[1] = activate<decltype(A)::value>(o[1]);
          }
        });
      }
    }
  }
}

// `n` floats of global `src` into shared `tmp` when they fit in `cap`
// (the weight stages, idle between products); returns where to read them.
// Every thread of the block calls it.
template <int R>
__device__ const float* stage_vector(const float* __restrict__ src, int n,
                                     float* tmp, int cap) {
  if (n > cap) return src;
  for (int k = threadIdx.x; k < n; k += Tile<R>::kThreads) tmp[k] = src[k];
  __syncthreads();
  return tmp;
}

// Two vectors at once (one barrier): returns where to read each.
template <int R>
__device__ void stage_pair(const float* __restrict__ a,
                           const float* __restrict__ b, int n, float* tmp,
                           int cap, const float** sa, const float** sb) {
  if (2 * n > cap) {
    *sa = a;
    *sb = b;
    return;
  }
  for (int k = threadIdx.x; k < n; k += Tile<R>::kThreads) {
    tmp[k] = a[k];
    tmp[n + k] = b[k];
  }
  __syncthreads();
  *sa = tmp;
  *sb = tmp + n;
}

// LayerNorm of the tile's rows in place (clamped one-pass variance, as the
// TPU kernel): one warp per row. Optionally (K1 saving residuals for K2)
// writes, for the tile's first `valid` rows, each row's mean and rstd
// (`mean`, `rstd`), its input h (`h_out`) and its output post
// (`post_out`), the last two as global rows of width `in`. The affine is
// first copied to `tmp` (cap floats of idle shared memory).
template <int R>
__device__ void layer_norm_rows(float* h, int s, int in,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, float* mean,
                                float* rstd, float* h_out, float* post_out,
                                int valid, float* tmp, int cap) {
  const float *sc, *bi;
  stage_pair<R>(scale, bias, in, tmp, cap, &sc, &bi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_in = 1.f / in;
  for (int r = warp; r < R; r += Tile<R>::kWarps) {
    float* hr = h + r * s;
    float sum = 0.f, ss = 0.f;
#pragma unroll 4
    for (int k = lane; k < in; k += 32) {
      const float v = hr[k];
      sum += v;
      ss += v * v;
    }
    sum = warp_sum(sum);
    ss = warp_sum(ss);
    const float mu = sum * inv_in;
    const float rs = rsqrtf(fmaxf(ss * inv_in - mu * mu, 0.f) + kEps);
    const bool keep = r < valid;
    const long long off = static_cast<long long>(r) * in;
#pragma unroll 4
    for (int k = lane; k < in; k += 32) {
      const float v = hr[k];
      const float p = (v - mu) * rs * sc[k] + bi[k];
      hr[k] = p;
      if (keep && h_out) h_out[off + k] = v;
      if (keep && post_out) post_out[off + k] = p;
    }
    if (keep && mean && lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// The tile's rows of x [n, f] into a buffer; rows past `valid` and columns
// f .. round_up(f, 8) are zeros.
template <int R>
__device__ void load_rows(const float* __restrict__ x, int f, int valid,
                          float* dst, int s) {
  const int fp = round_up(f, 8);
  for (int i = threadIdx.x; i < R * fp; i += Tile<R>::kThreads) {
    const int r = i / fp, k = i - r * fp;
    dst[r * s + k] =
        r < valid && k < f ? x[static_cast<long long>(r) * f + k] : 0.f;
  }
}

}  // namespace mlp
