#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ultra_pytorch_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: K1 (``ops/kernels/csrc/mlp_fwd.cu``) with nvcc, and ptxas's
   register / shared-memory / spill report.
3. Kernel parity: K1 against its plain PyTorch version on the card at the
   full serving width (F = 136, hidden [512, 256, 128]).
4. Serving: a seeded full-width DNN written as a checkpoint, loaded by
   ``Scorer.from_checkpoint`` (auto mode, so K1), served over HTTP through
   a ``MicroBatcher``; every reply checked against the plain version, and
   the K1 launch count of that run must be positive.
5. Timing: kernel, plain version and a chain of library calls at the
   serving buckets (8x16, 256x16, 256x128 rows), with FLOPs, bytes and the
   least time the card could take; and one ``Scorer`` call per bucket,
   with K1 and with the plain DNN path (host clock).
6. Kernels: one JSON line per the port's kernel table, then the result line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
FEATURES = 136                 # MSLR-WEB10K's feature count
HIDDEN = "hidden_layer_sizes=[512, 256, 128]"
BUCKETS = ((8, 16), (256, 16), (256, 128))   # (queries, docs) per call
# K1 against its plain version: the same float32 arithmetic, but each
# dot product over K <= 512 is summed in another order (per thread in the
# kernel, blocked in cuBLAS), so results differ by a few ulps per layer.
TOL = 2e-4
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def seeded_dnn(hparams: str, gen: torch.Generator, device):
    """A DNN with torch-default init on `gen` and a non-trivial LayerNorm
    affine (as after training), on `device`."""
    from ultra_pytorch_tpu_torch.models.dnn import DNN

    model = DNN(hparams, FEATURES, generator=gen)
    with torch.no_grad():
        for layer in model.layers:
            n = layer.norm.weight.shape[0]
            layer.norm.weight.add_(0.1 * torch.randn(n, generator=gen))
            layer.norm.bias.add_(0.1 * torch.randn(n, generator=gen))
    return model.to(device)


def mlp_work(model, n_rows: int):
    """(operations, bytes) of one fused forward over `n_rows` rows: per
    layer 2*in*out + out for the Linear, 6*in for the LayerNorm (sum, sum
    of squares, subtract, two multiplies, add) and `out` for the
    activation; bytes read the features and weights once and write the
    scores once."""
    use_norm = model.hparams.norm == "layer"
    ops = 0
    for j, layer in enumerate(model.layers):
        d_in, d_out = layer.linear.in_features, layer.linear.out_features
        ops += 2 * d_in * d_out + d_out + (6 * d_in if use_norm else 0)
        if j != len(model.layers) - 1:
            ops += d_out
    n_params = sum(p.numel() for p in model.parameters())
    return n_rows * ops, 4 * (n_rows * FEATURES + n_params + n_rows)


def time_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events, after a warm-up). Weights stay in L2 between calls, as they do
    in a server that scores request after request."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def library_chain(model, x):
    """The same function as library calls (F.layer_norm's two-pass
    variance, F.linear, F.elu): the yardstick, never called by the port."""
    h = x
    for j, layer in enumerate(model.layers):
        h = F.layer_norm(h, (h.shape[-1],), layer.norm.weight,
                         layer.norm.bias, eps=1e-5)
        h = F.linear(h, layer.linear.weight, layer.linear.bias)
        if j != len(model.layers) - 1:
            h = F.elu(h)
    return h[:, 0]


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)


def phase_build(mlp):
    t0 = time.perf_counter()
    built = mlp.build_kernel()
    print(f"[build] K1 {built.path.name}: nvcc {built.seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s", flush=True)
    for line in built.log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem")):
            print(f"[build] ptxas: {line.strip()}", flush=True)


def phase_parity(mlp, gen, dev):
    cases = (("elu/norm", HIDDEN, 32768), ("elu/norm ragged", HIDDEN, 1000),
             ("relu/no-norm", HIDDEN + ",activation_func=relu,norm=none",
              32768))
    worst = 0.0
    for name, hp, n in cases:
        model = seeded_dnn(hp, gen, dev)
        act, use_norm = model.hparams.activation_func, \
            model.hparams.norm == "layer"
        x = torch.randn(n, FEATURES, generator=gen).to(dev)
        with torch.inference_mode():
            got = mlp.fused_mlp_score(model.layers, x, act, use_norm)
            ref = mlp.fused_mlp_score_reference(model.layers, x, act,
                                                use_norm)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            rel = (err / ref.abs().clamp_min(1e-12)).max().item()
            worst = max(worst, err.max().item())
            print(f"[parity] {name} N={n}: max abs {err.max().item():.3e} "
                  f"max rel {rel:.3e} (limit rtol=atol={TOL})", flush=True)
            check(got.shape == (n,) and bool(torch.isfinite(got).all()),
                  f"{name}: non-finite or misshapen scores")
            check(torch.allclose(got, ref, rtol=TOL, atol=TOL),
                  f"{name}: K1 disagrees with its plain version")
    model = seeded_dnn(HIDDEN, gen, dev)
    try:
        mlp.fused_mlp_score(model.layers, torch.zeros(4, FEATURES,
                                                      device=dev))
        check(False, "a forward that needs gradients did not raise")
    except NotImplementedError as exc:
        print(f"[parity] gradient request refused: {exc}", flush=True)
    return worst


def phase_serving(mlp, gen, dev):
    from ultra_pytorch_tpu_torch.models.dnn import params_to_jax
    from ultra_pytorch_tpu_torch.serve import MicroBatcher, Scorer, \
        make_server
    from ultra_pytorch_tpu_torch.utils.checkpoint import save_checkpoint

    model_dir = os.path.join(ROOT, "build", "chip_smoke", "model")
    model = seeded_dnn(HIDDEN, gen, "cpu")
    save_checkpoint(os.path.join(model_dir, "DLA.ckpt"), params_to_jax(model),
                    metadata={"serve": {
                        "exp_settings": {
                            "ranking_model": "ultra.ranking_model.DNN",
                            "ranking_model_hparams": HIDDEN,
                            "learning_algorithm":
                                "ultra.learning_algorithm.DLA"},
                        "feature_size": FEATURES, "max_label": 4.0}})
    scorer = Scorer.from_checkpoint(model_dir)
    check(scorer.device.type == "cuda" and scorer.ranker.hparams.use_pallas,
          "auto mode did not select K1 on CUDA")

    rng = np.random.default_rng(0)
    requests = [[rng.normal(size=(rng.integers(10, 201), FEATURES))
                 .astype(np.float32) for _ in range(rng.integers(1, 17))]
                for _ in range(8)]
    requests.append([rng.normal(size=(1000, FEATURES)).astype(np.float32)])
    bodies = [json.dumps({"queries": [q.tolist() for q in qs]}).encode()
              for qs in requests]

    batcher = MicroBatcher(scorer)
    server = make_server(scorer, port=0, batcher=batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d/v1/rank" % server.server_address

    def post(body):
        t0 = time.perf_counter()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.perf_counter() - t0

    try:
        mlp.fused_mlp_score.launches = 0
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(post, bodies))
        launches = mlp.fused_mlp_score.launches
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)

    worst = 0.0
    with torch.inference_mode():
        for qs, (out, _) in zip(requests, replies):
            check(len(out["ranked"]) == len(qs), "reply lost queries")
            for q, ranked, scores in zip(qs, out["ranked"], out["scores"]):
                n = len(q)
                check(sorted(ranked) == list(range(n)),
                      "ranked row is not a permutation")
                got = torch.tensor(scores, dtype=torch.float32)
                ref = mlp.fused_mlp_score_reference(
                    scorer.ranker.layers, torch.from_numpy(q).to(dev)).cpu()
                check(got.shape == (n,) and bool(torch.isfinite(got).all()),
                      "non-finite or misshapen scores")
                worst = max(worst, (got - ref).abs().max().item())
                check(torch.allclose(got, ref, rtol=TOL, atol=TOL),
                      "served scores disagree with the plain version")
                check(bool((got[ranked][1:] <= got[ranked][:-1]).all()),
                      "ranking is not by descending score")
    lat = sorted(dt for _, dt in replies)
    n_docs = sum(len(q) for qs in requests for q in qs)
    print(f"[serving] {len(requests)} requests, "
          f"{sum(len(qs) for qs in requests)} queries, {n_docs} docs; "
          f"{batcher.device_calls} device calls, {launches} K1 launches; "
          f"latency p50 {1e3 * lat[len(lat) // 2]:.1f} ms max "
          f"{1e3 * lat[-1]:.1f} ms; max abs err {worst:.3e}", flush=True)
    check(launches > 0, "the served requests never launched K1")
    check(launches == batcher.device_calls,
          "K1 launches != device calls (one launch per call expected)")
    return launches, model_dir


def scorer_ms(scorer, feats, iters: int = 20) -> float:
    """Host-clock time of one ``Scorer`` call (pad, copy in, score, mask,
    argsort, copy out); the copy out waits for the device."""
    for _ in range(3):
        scorer._score_ranked(feats, None)
    t0 = time.perf_counter()
    for _ in range(iters):
        scorer._score_ranked(feats, None)
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_timing(mlp, gen, dev, model_dir):
    from ultra_pytorch_tpu_torch.serve import Scorer

    model = seeded_dnn(HIDDEN, gen, dev)
    layers = model.layers
    with_k1 = Scorer.from_checkpoint(model_dir)
    without = Scorer.from_checkpoint(model_dir, use_pallas=False)
    rng = np.random.default_rng(1)
    rows = {}
    with torch.inference_mode():
        for q, docs in BUCKETS:
            n = q * docs
            x = torch.randn(n, FEATURES, generator=gen).to(dev)
            iters = 200 if n <= 4096 else 50
            ms = time_ms(lambda: mlp.fused_mlp_score(layers, x), iters)
            plain_ms = time_ms(
                lambda: mlp.fused_mlp_score_reference(layers, x), iters)
            lib_ms = time_ms(lambda: library_chain(model, x), iters)
            lib_diff = (library_chain(model, x)
                        - mlp.fused_mlp_score(layers, x)).abs().max().item()
            ops, nbytes = mlp_work(model, n)
            bound = {name: 1e3 * max(ops / peak, nbytes / PEAK_BYTES)
                     for name, peak in (("f32", PEAK_F32),
                                        ("tf32", PEAK_TF32),
                                        ("bf16", PEAK_BF16))}
            by = "operations" if ops / PEAK_F32 >= nbytes / PEAK_BYTES \
                else "bytes"
            rows[(q, docs)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=bound["f32"], bound_by=by)
            print(f"[timing] {q}x{docs} ({n} rows): K1 {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms | "
                  f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB | bound "
                  f"f32 {bound['f32']:.4f} ms ({by}), tf32 "
                  f"{bound['tf32']:.4f} ms, bf16 {bound['bf16']:.4f} ms | "
                  f"K1 at {100 * bound['f32'] / ms:.1f}% of the f32 bound, "
                  f"{ops / ms / 1e9:.2f} TFLOP/s | library vs K1 max abs "
                  f"{lib_diff:.2e}", flush=True)
            feats = rng.normal(size=(q, docs, FEATURES)).astype(np.float32)
            k1_call, plain_call = scorer_ms(with_k1, feats), \
                scorer_ms(without, feats)
            print(f"[scorer] {q}x{docs}: Scorer call with K1 "
                  f"{k1_call:.3f} ms ({1e3 * q / k1_call:.0f} queries/s), "
                  f"plain DNN path {plain_call:.3f} ms "
                  f"({1e3 * q / plain_call:.0f} queries/s)", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ultra_pytorch_tpu_torch.ops.kernels import mlp

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    phase_device()
    phase_build(mlp)
    max_err = phase_parity(mlp, gen, dev)
    launches, model_dir = phase_serving(mlp, gen, dev)
    timing = phase_timing(mlp, gen, dev, model_dir)[BUCKETS[-1]]
    print(json.dumps({"kernels": [{
        "name": "K1 fused_mlp_fwd",
        "route": "cuda",
        "source": "ultra_pytorch_tpu_torch/ops/kernels/csrc/mlp_fwd.cu",
        "replaces": "ultra_pytorch_tpu/ops/pallas/mlp.py:91",
        "launches": launches,
        "max_abs_err": max_err,
        **timing,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
