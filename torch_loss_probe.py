#!/usr/bin/env python3
"""K3 and K4 (the port's fused listwise loss kernels) by block size, and
against another checkout's, on the card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 torch_loss_probe.py [--train]      # block sizes, then K3/K4
    python3 torch_loss_probe.py --package DIR [--train]   # K3/K4 of the
                                               # port package under DIR

It prints the card's name and power limit, then each as one line:

* the launch floor: device time (CUDA graph replay) of a one-element
  ``zero_()``;
* without ``--package``: K3's and K4's device time with the block capped
  at 64, 128, 256 and 512 threads (``_threads``; the wrappers use
  ``K3_THREADS`` and ``K4_THREADS``), at [256, 10] (a training step's
  loss), [16384, 10], [1024, 200] and [64, 1300], in two rounds of
  opposite order so that the gap between the rounds shows the noise; each
  result held to the default launch's within 1e-5;
* K3's and K4's device time at [256, 10] and [16384, 10] as the wrappers
  launch them, for this checkout or for the one under ``--package`` (an
  earlier commit unpacked there, whose K4 may take no residual);
* the host's time a call (host clock over 500 calls and a synchronize,
  three rounds) at [256, 10] of K3's wrapper, K4's wrapper and
  ``fused_softmax_loss`` with its gradient through autograd, on
  contiguous scores and on DLA's stride-0 broadcast of one row;
* with ``--train``: the queries/s of ``chip_smoke``'s training run
  (4 x 50 DLA steps at full width, windows 2-4) with the kernels on and
  off, in turns (on, off, off, on).

Run a checkout and the one under ``--package`` in turns (the other, this,
this, the other) to compare them on one card.

Inputs are ``chip_smoke.loss_inputs`` from ``--seed``: a fully masked
list, a zero-denominator list and a half-masked one in every batch.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

from chip_smoke import graph_ms, loss_inputs  # noqa: E402

SHAPES = ((256, 10), (16384, 10), (1024, 200), (64, 1300))
THREADS = (64, 128, 256, 512)


def k3_k4_ms(ll, s, y, w, m, calls: int, **cap):
    """(K3 ms, K4 ms), device time a call; `cap` is ``_threads`` or
    nothing."""
    one = torch.tensor(1.0, device=s.device)
    if not hasattr(ll, "LossStats"):   # a K4 that recomputes its statistics
        return (graph_ms(lambda: ll.listwise_loss_forward(s, y, w, m), calls),
                graph_ms(lambda: ll.listwise_loss_backward(s, y, w, m, one),
                         calls))
    _, stats = ll.listwise_loss_forward(s, y, w, m, return_stats=True, **cap)
    return (graph_ms(lambda: ll.listwise_loss_forward(
                s, y, w, m, return_stats=True, **cap), calls),
            graph_ms(lambda: ll.listwise_loss_backward(
                s, y, w, m, one, stats, **cap), calls))


def block_sizes(ll, gen) -> None:
    for batch, length in SHAPES:
        s, y, w, m = loss_inputs(batch, length, gen, torch.device("cuda"))
        g = torch.tensor(1.0, device="cuda")
        want, want_stats = ll.listwise_loss_forward(s, y, w, m,
                                                    return_stats=True)
        want_ds = ll.listwise_loss_backward(s, y, w, m, g, want_stats)
        calls = 50 if batch * length <= 4096 else 20
        times = {t: [] for t in THREADS}
        for rnd in (THREADS, THREADS[::-1]):
            for threads in rnd:
                times[threads].append(k3_k4_ms(ll, s, y, w, m, calls,
                                               _threads=threads))
        for threads, runs in times.items():
            loss, stats = ll.listwise_loss_forward(
                s, y, w, m, return_stats=True, _threads=threads)
            ds = ll.listwise_loss_backward(s, y, w, m, g, stats,
                                           _threads=threads)
            err = max(abs(loss.item() - want.item()) / abs(want.item()),
                      (ds - want_ds).abs().max().item()
                      / want_ds.abs().max().item())
            assert err <= 1e-5, (batch, length, threads, err)
            geo = ll.launch_geometry(batch, length, threads)
            k3s = " / ".join(f"{k3:.4f}" for k3, _ in runs)
            k4s = " / ".join(f"{k4:.4f}" for _, k4 in runs)
            chosen = [k for k, n in (("K3", ll.K3_THREADS),
                                     ("K4", ll.K4_THREADS)) if n == threads]
            print(f"[blocks] [{batch}, {length}], at most {threads} threads "
                  f"a block ({geo.blocks} blocks of {geo.threads}, "
                  f"{geo.lanes} lanes a list"
                  f"{''.join(f', the choice of {k}' for k in chosen)}): "
                  f"K3 {k3s} ms, K4 {k4s} ms (two rounds); off the default "
                  f"by {err:.1e}", flush=True)


def host_ms(fn, calls: int = 500, rounds: int = 3):
    """Host milliseconds a call of `fn` over `calls` calls ended by a
    synchronize, once per round."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / calls)
    return out


def host_costs(ll, gen, label: str) -> None:
    dev = torch.device("cuda")
    s, y, w, m = loss_inputs(256, 10, gen, dev)
    row = torch.randn(10, generator=gen).to(dev)
    one = torch.tensor(1.0, device=dev)
    new = hasattr(ll, "LossStats")
    if new:
        _, stats = ll.listwise_loss_forward(s, y, w, m, return_stats=True)
        k3 = host_ms(lambda: ll.listwise_loss_forward(s, y, w, m,
                                                      return_stats=True))
        k4 = host_ms(lambda: ll.listwise_loss_backward(s, y, w, m, one,
                                                       stats))
    else:
        k3 = host_ms(lambda: ll.listwise_loss_forward(s, y, w, m))
        k4 = host_ms(lambda: ll.listwise_loss_backward(s, y, w, m, one))
    both = {}
    for name, scores in (("contiguous", s),
                         ("stride-0", row[None].expand(256, 10))):
        sr = scores.detach().requires_grad_(True)
        both[name] = host_ms(lambda: torch.autograd.grad(
            ll.fused_softmax_loss(sr, y, w, m), sr))

    def text(v):
        return " / ".join(f"{x:.4f}" for x in v)

    print(f"[host] {label}: [256, 10] host ms a call (three rounds): K3 "
          f"wrapper {text(k3)}; K4 wrapper {text(k4)}; loss and gradient "
          f"through autograd {text(both['contiguous'])}, with stride-0 "
          f"scores {text(both['stride-0'])}", flush=True)


def train_rates(label: str) -> None:
    import chip_smoke

    click_json = chip_smoke.click_model_file()
    data = {"train": chip_smoke.synthetic(4096, 0),
            "valid": chip_smoke.synthetic(1024, 1)}
    rates = {True: [], False: []}
    w = chip_smoke.WINDOW * chip_smoke.BATCH * (chip_smoke.WINDOWS - 1)
    for kernels in (True, False, False, True):
        secs = chip_smoke.train_run(kernels, torch.device("cuda"),
                                    click_json, data, 0)[0]
        rates[kernels].append(w / sum(secs[1:]))
    on, off = (" / ".join(f"{r:.0f}" for r in rates[k]) for k in (True,
                                                                   False))
    print(f"[train] {label}: queries/s (host clock, windows 2-4, turns "
          f"on/off/off/on): kernels on {on}, plain {off}; ratio of the "
          f"means {sum(rates[True]) / sum(rates[False]):.2f}x", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--package", default=None,
                        help="time only K3/K4 of the port package under "
                             "this directory")
    parser.add_argument("--train", action="store_true",
                        help="also time chip_smoke's training run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_loss_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sys.path.insert(0, os.path.abspath(args.package or ROOT))
    from ultra_pytorch_tpu_torch.ops.kernels import listwise_loss as ll

    gen = torch.Generator().manual_seed(args.seed)
    tiny = torch.empty(1, device="cuda")
    print(f"[floor] one-element zero_(): {graph_ms(tiny.zero_, 50):.4f} ms "
          "(device time a call)", flush=True)
    if not args.package:
        block_sizes(ll, gen)
    label = args.package or "this checkout"
    for batch, length in SHAPES[:2]:
        s, y, w, m = loss_inputs(batch, length, gen, torch.device("cuda"))
        k3, k4 = k3_k4_ms(ll, s, y, w, m, 50 if batch <= 256 else 20)
        print(f"[kernels] {label}: [{batch}, {length}] K3 {k3:.4f} ms, K4 "
              f"{k4:.4f} ms (device time a call)", flush=True)
    host_costs(ll, gen, label)
    if args.train:
        train_rates(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
