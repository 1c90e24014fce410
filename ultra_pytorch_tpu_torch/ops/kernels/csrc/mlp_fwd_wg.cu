// K1's scoring instance on warpgroup MMAs: the fused MLP forward without
// residuals, 64 rows a tile, for Hopper (sm_90a). It computes what
// mlp_fwd.cu's scoring instance computes (per layer LayerNorm with the
// clamped one-pass variance and eps 1e-5, its affine, h @ W^T + b, the
// activation on every layer but the width-1 last) at the same float32
// accuracy (3xTF32), with the same order of every sum, and is what
// mlp.py's `_fwd_plan` picks where no residual is saved and 64-row tiles
// balance the card: the online learners' six passes over whole lists
// (30,720 rows), the 256x128 serving bucket (32,768), evaluation over whole
// lists. It replaces no TPU kernel of its own: it is a second design of
// the port of `_kernel` (ultra_pytorch_tpu/ops/pallas/mlp.py:91).
//
// What bounds it: 233,600 multiply-adds a row at F = 136, widths
// 512/256/128/1, 14.35 GFLOP at 30,720 rows, 0.0885 ms at the 3xTF32 peak
// (165 TFLOP/s effective). mlp_fwd.cu's 64-row instance issues
// `mma.sync.m16n8k8` from 16 warps, each splitting its own copy of every
// weight fragment into hi and lo, with a block barrier and a cp.async wait
// every 16 weights of depth: 0.635 ms there on an H100 (700 W), 13.9% of
// the bound.
//
// Design (each choice with what an H100 at 700 W measured):
//   * Products: `wgmma.mma_async.m64nNk8.f32.tf32.tf32`, A (the tile's
//     post-LayerNorm activations) from registers, split into hi and lo by
//     `split_tf32` once a k-step; B from shared memory. Three products a
//     k-step, lo*hi, hi*lo, hi*hi, into float32 accumulators, in
//     block_gemm's order (the lo*lo term dropped, as there): the scores
//     are the mma.sync instance's bits. A register-A m64n128k8 TF32 issues
//     every 64 SM clocks, the full rate, with B in this unswizzled layout.
//   * B is split once a call, not once a warp: `wg_split_weights`,
//     launched by the same call before the products, writes every hidden
//     layer's W_hi and W_lo (1.87 MB at the widths above) into a scratch
//     the wrapper allocates, already in the order the tile reads them:
//     32 KB chunks of kc x 2N weights (a consumer warpgroup's N columns,
//     two warpgroups), hi then lo, each k8 step as wgmma's K-major core
//     matrices (8 columns x 4 k, 128 bytes; the other 4 k 128 bytes on,
//     the next 8 columns 256 bytes on), so a chunk lands in shared memory
//     by one bulk copy and needs no tensor map. It runs every call: the
//     online learners' candidates are new weights at each pass.
//   * Weight stream: one producer thread keeps bulk copies (TMA) of the
//     chunks in flight into a ring of three stages, each with a `full`
//     mbarrier the copy completes and an `empty` one each consumer warp
//     arrives on once its products on the stage have retired; consumers
//     never wait on a block barrier for weights. The stream is not what
//     bounds the kernel: consumers that skipped the waits (on stale
//     weights) took as long. Clusters of 2 and 4 blocks sharing each chunk
//     by TMA multicast halve or quarter the L2 traffic (1.87 MB a tile,
//     0.9 GB a call) and ran slower, 0.51 and 0.72 ms against 0.31.
//   * Two consumer warpgroups take a layer's columns in halves, N = 64,
//     128 or 256 each (the smallest that covers half the width), the
//     whole layer in one pass with its accumulators in registers:
//     setmaxnreg gives each consumer thread 232 registers (128 of them
//     hold N = 256 columns) and the producer warpgroup 40. At the 168 a
//     thread of 384 gets without it, ptxas spilled and serialized every
//     wgmma (0.52 ms). So a layer's output can overwrite its input, and
//     one activation buffer of the widest layer input serves every layer:
//     132 KB for 64 rows at width 512, where mlp_fwd.cu's two buffers take
//     194 KB, which leaves 96 KB for the three 32 KB stages.
//   * A chunk's wgmma group is waited for before the next is issued: with
//     a second set of A registers in flight ptxas serialized the products
//     (0.39-0.52 ms). The next chunk's A is read from shared memory while
//     the group runs, and the other warpgroup's products fill the gap.
//   * Around the products, on CUDA cores, in the consumer warpgroups: the
//     LayerNorm in place (a warp a row, four rows at once, with
//     layer_norm_rows' order of sums: statistics summed in another order
//     left the ill-conditioned witness of the card tests a rounding apart
//     from the mma.sync instance), the bias and the activation from the
//     accumulators (all five codes through `with_act`), the width-1
//     output layer as a dot product a row.
//   * Schedule: one block an SM walks the tiles at a static stride of the
//     grid, so the producer streams the next tile's first chunks while the
//     consumers finish a tile, and nothing counts tiles atomically: a call
//     replays inside CUDA graphs without a reset, and every score is the
//     same bits on every run.
//
// The saving mode (K2's residuals), the 16- and 32-row tiles and widths
// whose buffer does not fit stay with mlp_fwd.cu.

#include "mlp_common.cuh"

namespace {

using namespace mlp;

constexpr int kRows = 64;                      // a tile: wgmma's M
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kProducer = 128 * kConsumers;    // the producer warpgroup
constexpr int kThreads = kProducer + 128;
constexpr int kProducerRegs = 40;              // setmaxnreg: the producer's
constexpr int kConsumerRegs = 232;             // registers to the consumers'
                                               // accumulators
constexpr int kRing = 3;                       // weight stages
constexpr int kStageBytes = 32768;             // hi part, then lo part
constexpr int kPartFloats = kStageBytes / 8;   // floats of one part
constexpr int kChunkFloats = kStageBytes / 4;  // floats of one chunk
constexpr int kMaxN = 256;                     // wgmma's widest N

// One hidden layer's products: N columns a consumer warpgroup, its chunks
// (each of 2048 / N weights of depth) and where they start in the scratch.
struct WgLayer {
  int n;
  int chunks;
  int chunk0;
};

struct WgPlan {
  int n_hidden;      // layers with products: all but the width-1 last
  int stride;        // activation buffer row stride, floats
  int total_chunks;  // chunks a tile streams
  WgLayer layer[kMaxLayers];
};

inline bool wg_plan(const Net& net, WgPlan* p) {
  int widest = 0, chunk = 0;
  for (int j = 0; j < net.n_layers; ++j)
    widest = net.width[j] > widest ? net.width[j] : widest;
  p->n_hidden = net.n_layers - 1;
  for (int j = 0; j < p->n_hidden; ++j) {
    const int width = net.width[j + 1];
    if (width > kConsumers * kMaxN) return false;
    int n = 64;
    while (n * kConsumers < width) n *= 2;
    const int kc = 2048 / n;
    p->layer[j].n = n;
    p->layer[j].chunks = (net.width[j] + kc - 1) / kc;
    p->layer[j].chunk0 = chunk;
    chunk += p->layer[j].chunks;
  }
  p->stride = act_stride(widest);
  p->total_chunks = chunk;
  return true;
}

// Shared memory: the ring, the activation buffer, then the barriers.
inline long long wg_smem(const WgPlan& p) {
  return kRing * kStageBytes + 4LL * kRows * p.stride + 16 * kRing;
}

// ---- barriers, bulk copies and warpgroup MMAs (PTX)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// A K-major B operand of N x 8 TF32 values at `addr`, no swizzle: core
// matrices of 8 columns x 16 bytes, the second half of k 128 bytes on
// (leading byte offset), the next 8 columns 256 bytes on (stride byte
// offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// The compiler may not move register reads or writes across the
// warpgroup's asynchronous products: tie each register to a barrier.
template <int M>
__device__ __forceinline__ void hold(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int S>
__device__ __forceinline__ void hold(unsigned (&r)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[s][i])::"memory");
}

// d += A * B for a 64 x N tile, A [64, 8] from registers (each warp of
// the warpgroup 16 rows, as mma.sync's m16n8k8 A fragment), B [N, 8]
// K-major at descriptor b.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const unsigned (&a)[4],
                                      uint64_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    static_assert(N == 256, "N is 64, 128 or 256");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
        "%122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// The consumers' view of the ring: `it` counts the chunks taken so far,
// as the producer counts the chunks it loaded.
struct Ring {
  uint32_t stages, full, empty;
  uint32_t it;
  // Waits for the next chunk; returns its stage.
  __device__ uint32_t take() {
    mbar_wait(full + 8 * (it % kRing), (it / kRing) & 1);
    return stages + (it++ % kRing) * kStageBytes;
  }
  // Each warp, once its products on the last chunk taken have retired.
  __device__ void release(int lane) const {
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kRing));
  }
};

// One hidden layer over the tile: this consumer warpgroup's N columns
// (wg * N ...) of act(buf @ W^T + b), written over buf once both
// warpgroups have read it; columns width .. round_up(width, 8) get zeros.
// The next chunk's A is read from buf while the chunk's products run.
template <int N>
__device__ __forceinline__ void layer(float* buf, int stride, int depth,
                                      int width, int chunks,
                                      const float* __restrict__ bias, int act,
                                      int wg, int wq, int lane, Ring& ring) {
  constexpr int kKc = 2048 / N;    // depth of a chunk
  constexpr int kSteps = kKc / 8;  // k8 steps a chunk
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wq + g;
  const int depth8 = round_up(depth, 8);
  float a[kSteps][4];  // one chunk's A values, as mma.sync's A fragment
  auto fetch = [&](int c) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int k0 = c * kKc + 8 * s;
      if (k0 >= depth8) break;
      const float* p = buf + r0 * stride + k0 + t;
      a[s][0] = p[0];
      a[s][1] = p[8 * stride];
      a[s][2] = p[4];
      a[s][3] = p[8 * stride + 4];
    }
  };
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fetch(0);
  for (int c = 0; c < chunks; ++c) {
    unsigned ah[kSteps][4], al[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[s][i], ah[s][i], al[s][i]);
    const uint32_t hi = ring.take() + wg * 32 * N;
    const uint32_t lo = hi + kStageBytes / 2;
    hold(acc);
    hold(ah);
    hold(al);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (c * kKc + 8 * s >= depth8) break;
      const uint64_t bh = b_desc(hi + s * 64 * N);
      const uint64_t bl = b_desc(lo + s * 64 * N);
      wgmma<N>(acc, al[s], bh);
      wgmma<N>(acc, ah[s], bl);
      wgmma<N>(acc, ah[s], bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c + 1 < chunks) fetch(c + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold(acc);
    ring.release(lane);
  }
  consumers_sync();  // both warpgroups have read the layer's input
  const int width8 = round_up(width, 8);
  with_act(act, [&](auto A) {
    constexpr int kA = decltype(A)::value;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = wg * N + 8 * j + 2 * t;
      if (col - 2 * t >= width8) break;
      const float b0 = col < width ? bias[col] : 0.f;
      const float b1 = col + 1 < width ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = activate<kA>(acc[4 * j + 2 * h] + b0);
        const float v1 = activate<kA>(acc[4 * j + 2 * h + 1] + b1);
        *reinterpret_cast<float2*>(buf + (r0 + 8 * h) * stride + col) =
            make_float2(col < width ? v0 : 0.f, col + 1 < width ? v1 : 0.f);
      }
    }
  });
  consumers_sync();
}

// Rows a consumer warp takes at once in the LayerNorm and the output
// layer: four independent chains of loads and shuffles hide each other's
// latency (a row at a time left the warps waiting).
constexpr int kRowsAtOnce = 4;
constexpr int kRowStep = 4 * kConsumers;  // a warp's rows: cw, cw + 8, ...

// LayerNorm of the tile's rows in place: each row by one consumer warp,
// with layer_norm_rows' arithmetic and order of sums.
__device__ __forceinline__ void norm_rows(float* buf, int stride, int in,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          int cw, int lane) {
  const float inv_in = 1.f / in;
  for (int r = cw; r < kRows; r += kRowStep * kRowsAtOnce) {
    float* h[kRowsAtOnce];
    float sum[kRowsAtOnce], ss[kRowsAtOnce], mu[kRowsAtOnce],
        rs[kRowsAtOnce];
#pragma unroll
    for (int i = 0; i < kRowsAtOnce; ++i) {
      h[i] = buf + (r + kRowStep * i) * stride;
      sum[i] = ss[i] = 0.f;
    }
#pragma unroll 2
    for (int k = lane; k < in; k += 32)
#pragma unroll
      for (int i = 0; i < kRowsAtOnce; ++i) {
        const float v = h[i][k];
        sum[i] += v;
        ss[i] += v * v;
      }
#pragma unroll
    for (int i = 0; i < kRowsAtOnce; ++i) {
      sum[i] = warp_sum(sum[i]);
      ss[i] = warp_sum(ss[i]);
      mu[i] = sum[i] * inv_in;
      rs[i] = rsqrtf(fmaxf(ss[i] * inv_in - mu[i] * mu[i], 0.f) + kEps);
    }
#pragma unroll 2
    for (int k = lane; k < in; k += 32) {
      const float sc = __ldg(scale + k), bi = __ldg(bias + k);
#pragma unroll
      for (int i = 0; i < kRowsAtOnce; ++i)
        h[i][k] = (h[i][k] - mu[i]) * rs[i] * sc + bi;
    }
  }
}

// The width-1 output layer: each row's dot product by one consumer warp.
__device__ __forceinline__ void score_rows(const float* buf, int stride,
                                           int in, const Layer& L, int valid,
                                           float* __restrict__ out, int cw,
                                           int lane) {
  for (int r = cw; r < kRows; r += kRowStep * kRowsAtOnce) {
    float acc[kRowsAtOnce] = {};
#pragma unroll 2
    for (int k = lane; k < in; k += 32) {
      const float w = __ldg(L.w + k);
#pragma unroll
      for (int i = 0; i < kRowsAtOnce; ++i)
        acc[i] += buf[(r + kRowStep * i) * stride + k] * w;
    }
#pragma unroll
    for (int i = 0; i < kRowsAtOnce; ++i) {
      acc[i] = warp_sum(acc[i]);
      const int row = r + kRowStep * i;
      if (lane == 0 && row < valid) out[row] = acc[i] + L.b[0];
    }
  }
}

// The tile's rows of x into buf: zeros past `valid` rows and past f up to
// round_up(f, 8); vectors of 4 where f and x allow.
__device__ __forceinline__ void load_rows(const float* __restrict__ x, int f,
                                          int valid, float* buf, int stride,
                                          int ct) {
  const int fp = round_up(f, 8);
  if (f % 4 == 0 && aligned16(x)) {
    const int per_row = fp / 4;
    for (int i = ct; i < kRows * per_row; i += 128 * kConsumers) {
      const int r = i / per_row, k = (i - r * per_row) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid && k < f)
        v = __ldg(reinterpret_cast<const float4*>(
            x + static_cast<long long>(r) * f + k));
      *reinterpret_cast<float4*>(buf + r * stride + k) = v;
    }
  } else {
    for (int i = ct; i < kRows * fp; i += 128 * kConsumers) {
      const int r = i / fp, k = i - r * fp;
      buf[r * stride + k] =
          r < valid && k < f ? __ldg(x + static_cast<long long>(r) * f + k)
                             : 0.f;
    }
  }
}

// One block an SM; block b takes the tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_kernel_wgmma(const float* __restrict__ x, float* __restrict__ out,
                     const float* __restrict__ w_split, int n_rows, Net net,
                     WgPlan plan, int act, int use_norm) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* buf = reinterpret_cast<float*>(smem + kRing * kStageBytes);
  const uint32_t stages = smem_addr(smem);
  const uint32_t full = smem_addr(buf + kRows * plan.stride);
  const uint32_t empty = full + 8 * kRing;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    // The producer warpgroup: one thread streams every tile's chunks; the
    // others' registers go to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kProducer) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int c = 0; c < plan.total_chunks; ++c, ++it) {
          const uint32_t s = it % kRing;
          mbar_wait(empty + 8 * s, ((it / kRing) & 1) ^ 1);
          mbar_expect(full + 8 * s, kStageBytes);
          bulk_load(stages + s * kStageBytes,
                    w_split + static_cast<long long>(c) * kChunkFloats,
                    kStageBytes, full + 8 * s);
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = threadIdx.x / 32, lane = threadIdx.x % 32;  // consumer warp
  const int wg = cw / 4, wq = cw % 4;  // warpgroup, its warp
  const int stride = plan.stride;
  Ring ring{stages, full, empty, 0};
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kRows;
    const int valid =
        n_rows - row0 < kRows ? static_cast<int>(n_rows - row0) : kRows;
    load_rows(x + row0 * net.width[0], net.width[0], valid, buf, stride,
              threadIdx.x);
    consumers_sync();
    for (int j = 0; j < net.n_layers; ++j) {
      const Layer& L = net.layer[j];
      const int in = net.width[j];
      if (use_norm) {
        norm_rows(buf, stride, in, L.scale, L.bias, cw, lane);
        consumers_sync();
      }
      if (j == plan.n_hidden) break;
      const int width = net.width[j + 1], chunks = plan.layer[j].chunks;
      switch (plan.layer[j].n) {
        case 64:
          layer<64>(buf, stride, in, width, chunks, L.b, act, wg, wq, lane,
                    ring);
          break;
        case 128:
          layer<128>(buf, stride, in, width, chunks, L.b, act, wg, wq, lane,
                     ring);
          break;
        default:
          layer<256>(buf, stride, in, width, chunks, L.b, act, wg, wq, lane,
                     ring);
          break;
      }
    }
    score_rows(buf, stride, net.width[plan.n_hidden],
               net.layer[plan.n_hidden], valid, out + row0, cw, lane);
    consumers_sync();  // the next tile's rows go where these were
  }
}

// Every hidden layer's W [out, in] as hi and lo TF32 parts in the order
// the tile streams them (see the design note): chunk by chunk, in each
// the hi part then the lo part, in each k8 step by step, in each the 2N
// columns as core matrices of 8 columns x 4 k. Zeros past the layer's
// width and depth.
__global__ void wg_split_weights(Net net, WgPlan plan,
                                 float* __restrict__ dst) {
  const long long total =
      static_cast<long long>(plan.total_chunks) * kChunkFloats;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int chunk = static_cast<int>(i / kChunkFloats);
    const int e = static_cast<int>(i % kChunkFloats);
    const int part = e / kPartFloats, q = e % kPartFloats;
    int j = 0;
    while (j + 1 < plan.n_hidden && chunk >= plan.layer[j + 1].chunk0) ++j;
    const int n_wg = plan.layer[j].n, kc = 2048 / n_wg;
    const int s = q / (16 * n_wg), r = q % (16 * n_wg);
    const int n = (r / 64) * 8 + (r % 32) / 4;
    const int k = (chunk - plan.layer[j].chunk0) * kc + 8 * s +
                  ((r % 64) / 32) * 4 + r % 4;
    const int depth = net.width[j], width = net.width[j + 1];
    const float v = n < width && k < depth
                        ? net.layer[j].w[static_cast<long long>(n) * depth + k]
                        : 0.f;
    unsigned hi, lo;
    split_tf32(v, hi, lo);
    dst[i] = __uint_as_float(part ? lo : hi);
  }
}

bool plan_of(const int* widths, int n_layers, const void* const* params,
             Net* net, WgPlan* plan) {
  const void* none[4 * kMaxLayers] = {};
  return make_net(widths, n_layers, params ? params : none, net) &&
         wg_plan(*net, plan);
}

}  // namespace

extern "C" {

// Dynamic shared memory K1's wgmma instance needs for these widths; 0
// where it has none (invalid widths, or a hidden layer wider than 512).
long long ultra_mlp_fwd_wg_smem_bytes(const int* widths, int n_layers) {
  Net net;
  WgPlan plan;
  return plan_of(widths, n_layers, nullptr, &net, &plan) ? wg_smem(plan) : 0;
}

// Floats of the split weights' scratch for these widths (0 if invalid).
long long ultra_mlp_fwd_wg_scratch_floats(const int* widths, int n_layers) {
  Net net;
  WgPlan plan;
  return plan_of(widths, n_layers, nullptr, &net, &plan)
             ? static_cast<long long>(plan.total_chunks) * kChunkFloats
             : 0;
}

// Scores n_rows rows of x [n_rows, widths[0]] into out [n_rows] on
// `stream` with the wgmma instance, on at most `blocks` blocks (one an
// SM): first the weights' split into `scratch` (scratch_floats floats,
// `ultra_mlp_fwd_wg_scratch_floats`), then the tiles. widths and params
// as ultra_mlp_fwd's. Returns cudaGetLastError() after the launches.
int ultra_mlp_fwd_wg(const float* x, const void* const* params, float* out,
                     float* scratch, long long scratch_floats, int n_rows,
                     const int* widths, int n_layers, int act, int use_norm,
                     int blocks, void* stream) {
  Net net;
  WgPlan plan;
  if (!plan_of(widths, n_layers, params, &net, &plan) || n_rows < 1 ||
      blocks < 1 ||
      scratch_floats !=
          static_cast<long long>(plan.total_chunks) * kChunkFloats)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.total_chunks) {
    const long long total = scratch_floats;
    const int split_blocks =
        static_cast<int>(total / 256 < 4096 ? (total + 255) / 256 : 4096);
    wg_split_weights<<<split_blocks, 256, 0, s>>>(net, plan, scratch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long bytes = wg_smem(plan);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  mlp_fwd_kernel_wgmma<<<n_tiles < blocks ? n_tiles : blocks, kThreads,
                         bytes, s>>>(x, out, scratch, n_rows, net, plan, act,
                                     use_norm);
  return cudaGetLastError();
}

}  // extern "C"
