#!/usr/bin/env python3
"""Where K1 and K2 (the port's fused MLP kernels) spend their time, and how
close they come to float64, on the card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 torch_mlp_probe.py
    python3 torch_mlp_probe.py --package DIR   # the witness only, for the
                                               # port package under DIR

It prints, each as one line:

* the issue rate of ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``
  (the instruction K1 and K2 multiply with), from a microbenchmark kernel
  built here with nvcc: 16 warps an SM, eight independent accumulators a
  warp, SM clocks counted with ``clock64``;
* K1's device time (CUDA graph replay) at a training step's 2,560 rows and
  the 32,768-row serving bucket, as it runs, without its activation and
  without LayerNorm (the same launch with those parts switched off), for
  the mma.sync instance of the plan's tile and, at 32,768 rows, the wgmma
  instance the plan takes there;
* K1's device time, without and with saving the residuals for K2, and
  K2's on those residuals, at 128, 1,000, 2,560, 30,720 (the online
  family's whole lists, 256 x 120) and 32,768 rows, and at 6,000, 10,000,
  12,800 and 25,600 rows, where ``rows_per_block``'s tile cost moved the
  choice from 16-row tiles to 64 or 32, with each tile size forced
  (``_rows``), in two rounds of opposite order, so that the gap between
  the rounds shows the noise, against the one ``rows_per_block`` picks,
  and which tile was fastest; where K1 takes its wgmma instance, its time
  too;
* K2's device time at 2,560 rows with 2, 4 and 8 dW blocks per SM
  (``_dw_per_sm``), and torch.profiler's split of it into its kernels;
* the witness: on the odd widths (F = 37, hidden [300, 70, 5]) with sigmoid
  and LayerNorm, where a LayerNorm over 5 sigmoid outputs amplifies
  rounding, how far K2's gradients and those of the float32 plain version
  (autograd) lie from float64 autograd, each relative to the float64
  tensor's largest magnitude, and the same for K1's and the plain scores.
  ``--package DIR`` runs it on the port package under DIR (for example an
  earlier commit unpacked there), so two versions of K2 meet the same
  inputs.

Widths are the bench's DNN: F = 136, hidden [512, 256, 128], weights from
``--seed``. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

from chip_smoke import (FEATURES, HIDDEN, device_events, graph_ms,  # noqa: E402
                        seeded_dnn)

MMA_SOURCE = r"""
#include <cuda_runtime.h>

__global__ void mma_rate_kernel(float* out, long long* cycles, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  b[0] = 0x3f800000u + threadIdx.x;
  b[1] = b[0] + 7;
  float d[8][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(float* out, long long* cycles, int blocks,
                        int threads, int iters, void* stream) {
  mma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, cycles, iters);
  return cudaGetLastError();
}
"""

# The witness: widths that are no multiple of 8 with a 5-wide last hidden
# layer, sigmoid (outputs near 0.5) and LayerNorm; N values with their
# seeds.
WITNESS_HP, WITNESS_F = "hidden_layer_sizes=[300, 70, 5]", 37
WITNESS_ROWS = (1000, 2559, 2560, 32768)
ACTS = {"elu": F.elu, "relu": F.relu, "selu": F.selu, "tanh": torch.tanh,
        "sigmoid": torch.sigmoid}


def mma_rate(mlp, n_sms: int) -> None:
    from ultra_pytorch_tpu_torch.ops.kernels import build

    src = build.BUILD_DIR / "probe" / "mma_rate.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_SOURCE)
    lib = ctypes.CDLL(str(build.build_library("mma_rate", [src]).path))
    lib.mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    threads, iters = 512, 4096
    out = torch.empty(n_sms * threads, device="cuda")
    cycles = torch.empty(n_sms, dtype=torch.int64, device="cuda")

    def run():
        assert lib.mma_rate(out.data_ptr(), cycles.data_ptr(), n_sms,
                            threads, iters,
                            torch.cuda.current_stream().cuda_stream) == 0

    ms = graph_ms(run, 5)
    per_sm = threads // 32 * iters * 8
    clocks = cycles.double().mean().item()
    tflops = n_sms * per_sm * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12
    print(f"[mma] m16n8k8 TF32 mma.sync: {clocks / per_sm:.3f} SM clocks per "
          f"instruction per SM (16 warps, 8 independent accumulators); "
          f"{tflops:.1f} TFLOP/s TF32, {tflops / 3:.1f} TFLOP/s as 3xTF32 "
          f"float32 products", flush=True)


def k1_parts(mlp, model, gen) -> None:
    """K1 as launched, and with its activation (code -1) or LayerNorm
    switched off: the library's own entry points, called directly, for the
    mma.sync instance the plan's tile takes and, where the plan takes it,
    the wgmma instance."""
    lib, _ = mlp._library()
    layers = model.layers
    n_layers = len(layers)
    for n in (2560, 32768):
        x = torch.randn(n, FEATURES, generator=gen).cuda()
        out = torch.empty(n, device="cuda")
        sms = mlp._sm_count(x.device)
        plan = mlp._fwd_plan(mlp._widths(layers), n, sms)
        scratch = torch.empty(plan.scratch_floats, device="cuda")
        ptrs = mlp._param_pointers(layers, x.device)
        table = (ctypes.c_void_p * len(ptrs))(*ptrs)

        def mma_sync(act, use_norm):
            err = lib.ultra_mlp_fwd(
                x.data_ptr(), table, out.data_ptr(), None, 0, n,
                plan.c_widths, n_layers, plan.rows, act, use_norm,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        def wgmma(act, use_norm):
            err = lib.ultra_mlp_fwd_wg(
                x.data_ptr(), table, out.data_ptr(), scratch.data_ptr(),
                plan.scratch_floats, n, plan.c_widths, n_layers, act,
                use_norm, sms, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        calls = 50 if n <= 4096 else 10
        elu = mlp.ACTIVATION_CODES["elu"]
        for name, launch in (("mma.sync", mma_sync), ("wgmma", wgmma)):
            if name == "wgmma" and not plan.wgmma:
                continue
            full = graph_ms(lambda: launch(elu, 1), calls)
            no_act = graph_ms(lambda: launch(-1, 1), calls)
            no_norm = graph_ms(lambda: launch(elu, 0), calls)
            print(f"[k1] {n} rows ({plan.rows} a block, {name}): "
                  f"{full:.4f} ms; without the activation {no_act:.4f} ms; "
                  f"without LayerNorm {no_norm:.4f} ms (device time a call)",
                  flush=True)


def tile_sizes(mlp, model, gen, n: int) -> None:
    x = torch.randn(n, FEATURES, generator=gen).cuda()
    g = torch.randn(n, generator=gen).cuda()
    plan = mlp._fwd_plan(mlp._widths(model.layers), n,
                         mlp._sm_count(x.device))
    chosen = plan.rows
    chosen_k2 = mlp._bwd_plan(mlp._widths(model.layers), n,
                              mlp._sm_count(x.device))[0]
    residual = mlp.new_residual(model.layers, x, True)
    calls = 50 if n <= 4096 else 5
    times = {rows: [] for rows in mlp.ROWS_PER_BLOCK}
    order = list(mlp.ROWS_PER_BLOCK)
    for rnd in (order, order[::-1]):
        for rows in rnd:
            with torch.inference_mode():
                k1 = graph_ms(lambda: mlp.mlp_forward(
                    model.layers, x, "elu", True, _rows=rows), calls)
                k1s = graph_ms(lambda: mlp.mlp_forward(
                    model.layers, x, "elu", True, _rows=rows,
                    residual=residual), calls)
            k2 = graph_ms(lambda: mlp.mlp_backward(
                model.layers, x, g, "elu", True, _rows=rows,
                residual=residual), min(calls, 20))
            times[rows].append((k1, k1s, k2))
    for rows, runs in times.items():
        text = ", ".join(
            f"{name} " + " / ".join(f"{t[i]:.4f}" for t in runs)
            for i, name in enumerate(("K1", "K1 saving", "K2")))
        print(f"[tiles] {n} rows, {rows} a block ({-(-n // rows)} blocks"
              f"{', K1/K2 choice' if rows == chosen == chosen_k2 else ''}"
              f"): {text} ms (two rounds; K2 on the saved residual)",
              flush=True)
    if plan.wgmma:
        with torch.inference_mode():
            wg = [graph_ms(lambda: mlp.mlp_forward(
                model.layers, x, "elu", True, _rows=mlp.WGMMA), calls)
                for _ in range(2)]
        print(f"[tiles] {n} rows, the wgmma instance (64-row tiles, K1's "
              f"choice without a residual): K1 {wg[0]:.4f} / {wg[1]:.4f} ms",
              flush=True)
    fastest = [min(times, key=lambda r: sum(t[i] for t in times[r]))
               for i in range(3)]
    print(f"[tiles] {n} rows: fastest tile by the rounds' sum K1 "
          f"{fastest[0]}, K1 saving {fastest[1]}, K2 {fastest[2]}; "
          f"rows_per_block picks K1 {chosen}"
          f"{' (wgmma without a residual)' if plan.wgmma else ''}, K2 "
          f"{chosen_k2}", flush=True)


def k2_chunks(mlp, model, gen) -> None:
    n = 2560
    x = torch.randn(n, FEATURES, generator=gen).cuda()
    g = torch.randn(n, generator=gen).cuda()
    widths = mlp._widths(model.layers)
    residual = mlp.new_residual(model.layers, x, True)
    with torch.inference_mode():
        mlp.mlp_forward(model.layers, x, "elu", True, residual=residual)
    for per_sm in (2, 4, 8):
        def call():
            return mlp.mlp_backward(model.layers, x, g, "elu", True,
                                    _dw_per_sm=per_sm, residual=residual)

        ms = graph_ms(call, 20)
        split = {}
        for name, us in device_events(lambda: [call() for _ in range(10)]):
            hit = re.search(r"mlp_bwd_\w+_kernel", name)
            key = hit.group(0) if hit else "other"
            split[key] = split.get(key, 0.0) + us / 10e3
        parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        chunks = mlp.dw_chunks(n, widths, mlp._sm_count(x.device), per_sm)
        print(f"[k2] {n} rows, {per_sm} dW blocks an SM ({chunks} chunks): "
              f"{ms:.4f} ms; per kernel (ms): {parts}", flush=True)


def float64_chain(layers, x, g, activation: str, use_norm: bool):
    """Scores, dx and the parameter gradients (per layer LayerNorm scale,
    bias, W [out, in], b) of the fused MLP, by autograd in float64 with the
    same clamped one-pass variance."""
    params = [p.detach().double().requires_grad_(True) for layer in layers
              for p in (layer.norm.weight, layer.norm.bias,
                        layer.linear.weight, layer.linear.bias)]
    xr = x.detach().double().requires_grad_(True)
    with torch.enable_grad():
        h = xr
        for j in range(len(layers)):
            scale, bias, w, b = params[4 * j: 4 * j + 4]
            if use_norm:
                mu = h.mean(-1, keepdim=True)
                var = (h * h).mean(-1, keepdim=True) - mu * mu
                h = (h - mu) * torch.rsqrt(var.clamp_min(0.0) + 1e-5) \
                    * scale + bias
            h = h @ w.t() + b
            if j != len(layers) - 1:
                h = ACTS[activation](h)
        grads = torch.autograd.grad(h[:, 0], [xr] + params, g.double(),
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip([xr] + params, grads)]
    return h[:, 0].detach(), grads


def off_by(got, ref):
    """(worst over tensors of max abs error / the reference's largest
    magnitude, the index of that tensor)."""
    rels = [(a.double() - b).abs().max().item()
            / max(b.abs().max().item(), 1e-12) for a, b in zip(got, ref)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    return rels[worst], worst


def witness(mlp, label: str) -> None:
    from ultra_pytorch_tpu_torch.models.dnn import DNN

    act, use_norm = "sigmoid", True
    for n in WITNESS_ROWS:
        gen = torch.Generator().manual_seed(n)
        model = DNN(WITNESS_HP, WITNESS_F, generator=gen)
        with torch.no_grad():
            for layer in model.layers:
                k = layer.norm.weight.shape[0]
                layer.norm.weight.add_(0.1 * torch.randn(k, generator=gen))
                layer.norm.bias.add_(0.1 * torch.randn(k, generator=gen))
        model = model.cuda()
        x = torch.randn(n, WITNESS_F, generator=gen).cuda()
        g = torch.randn(n, generator=gen).cuda()
        dx, grads = mlp.mlp_backward(model.layers, x, g, act, use_norm)
        ref_dx, ref_grads = mlp.mlp_backward_reference(model.layers, x, g,
                                                       act, use_norm)
        with torch.inference_mode():
            k1 = mlp.fused_mlp_score(model.layers, x, act, use_norm)
            plain = mlp.fused_mlp_score_reference(model.layers, x, act,
                                                  use_norm)
        s64, exact = float64_chain(model.layers, x, g, act, use_norm)
        torch.cuda.synchronize()
        k2_rel, k2_at = off_by([dx] + list(grads), exact)
        ref_rel, ref_at = off_by([ref_dx] + list(ref_grads), exact)
        vs_plain, vs_at = off_by([dx] + list(grads),
                                 [t.double() for t in [ref_dx] + ref_grads])
        k1_err = (k1.double() - s64).abs().max().item()
        plain_err = (plain.double() - s64).abs().max().item()
        print(f"[witness] {label}: sigmoid/LayerNorm, widths "
              f"{WITNESS_F}-300-70-5-1, N={n}: off float64 by (of its "
              f"largest magnitude) K2 {k2_rel:.3e} (tensor {k2_at}), plain "
              f"float32 {ref_rel:.3e} (tensor {ref_at}); K2 vs plain "
              f"{vs_plain:.3e} (tensor {vs_at}; limit 2e-4) | scores max abs "
              f"off float64: K1 {k1_err:.3e}, plain {plain_err:.3e}",
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--package", default=None,
                        help="run only the witness, on the port package "
                             "under this directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_mlp_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.package or ROOT))
    from ultra_pytorch_tpu_torch.ops.kernels import mlp

    if args.package:
        witness(mlp, args.package)
        return 0
    gen = torch.Generator().manual_seed(args.seed)
    model = seeded_dnn(HIDDEN, gen, "cuda")
    mma_rate(mlp, mlp._sm_count(torch.device("cuda")))
    with torch.inference_mode():
        k1_parts(mlp, model, gen)
    for n in (128, 1000, 2560, 6000, 10000, 12800, 25600, 30720, 32768):
        tile_sizes(mlp, model, gen, n)
    k2_chunks(mlp, model, gen)
    witness(mlp, "this checkout")
    return 0


if __name__ == "__main__":
    sys.exit(main())
