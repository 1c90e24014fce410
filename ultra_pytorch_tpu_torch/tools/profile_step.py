"""Break the DLA training step into feed / train / full timings.

The port's counterpart of the JAX package's ``tools/profile_step.py``.
Three programs on the JAX bench protocol
(``bench_common.make_bench_setup``: B = 256 x L = 10 x F = 136, PBM
clicks, DLA with the DNN at [512, 256, 128], the kernel hparams off as
in the JAX tool; ``--kernels`` turns K1-K5 on), µs a step:

  feed  - the window's plan (query sampling, the clicks, the compact
          resampling) and each step's feature gather, every output
          summed so that each is read;
  train - the algorithm's step alone (the ranker's forward and backward,
          the losses, the optimizers) on one fixed batch held in the same
          buffers throughout;
  full  - the real training window (``Experiment.train_steps_device``).

On the card each program of CHUNK steps is one CUDA graph
(``run/window.capture`` / ``WindowGraphs``, the counterpart of JAX's
scanned chunk), replayed; each is also timed eager (``*_eager_us``).
``busy_share`` is the card's busy time under ``torch.profiler`` over one
replayed full window, over that window's unprofiled time (null where
the profiler records no device activity); ``launches`` counts K1-K5 in
the timed runs, ``allow_tf32`` says whether float32 products may run in
TF32 (the library path's cuBLAS calls read it). On the CPU there are no
graphs: the graph figures are null and the programs run eager. ``prng``
is the JAX tool's ``--prng``, the shape of the data key; ``generator``
names the draws' own stream.

feed + train > full is expected where the full window overlaps the two.

Usage: python -m ultra_pytorch_tpu_torch.tools.profile_step
           [--steps 200] [--prng rbg] [--kernels] [--device cuda]
"""

from __future__ import annotations

import json
import time
from typing import Callable

import torch

from ultra_pytorch_tpu_torch.tools import bench_common as bc

CHUNK = 25     # steps a program, as the JAX tool's scanned chunk
PRNG = "rbg"   # the JAX tool's --prng default


def _per_step_us(run: Callable[[], object], chunks: int, steps: int,
                 device) -> float:
    """µs a step of `chunks` calls of `run` (one warm call first), host
    clock, ending with the device's work done."""
    run()
    bc.sync(device)
    t0 = time.perf_counter()
    for _ in range(chunks):
        run()
    bc.sync(device)
    return (time.perf_counter() - t0) / steps * 1e6


def profile(device, steps: int = 200, batch: int = bc.BATCH,
            list_size: int = bc.LIST, features: int = bc.FEATURES,
            hidden: str = bc.HIDDEN, chunk: int = CHUNK, prng: str = PRNG,
            kernels: bool = False):
    """The three programs' µs a step, graph and eager, the busy share and
    the kernels' launches in the timed runs, on the protocol, with K1-K5
    where `kernels`."""
    from ultra_pytorch_tpu_torch.algorithms.base import window_plan
    from ultra_pytorch_tpu_torch.run.window import capture

    device = torch.device(device)
    cuda = device.type == "cuda"
    exp = bc.make_bench_setup(
        device, batch, list_size, features, prng=prng, hidden=hidden,
        **bc.extras(kernels))
    alg, feed, state = exp.algorithm, exp.feeds["train"], exp.state
    gen = torch.Generator(device=device)
    start = torch.zeros((), dtype=torch.int64, device=device)
    chunks = max(steps // chunk, 1)
    n_steps = chunks * chunk
    before = bc.launch_counts()

    def feed_chunk():
        plan = window_plan(alg, feed, gen, start, chunk)
        total = torch.zeros((), device=device)
        for i in range(chunk):
            for v in feed.batch_from_plan(plan, i).values():
                total = total + v.float().sum()
        return total

    batch_fixed = feed.batch_from_plan(
        window_plan(alg, feed, gen.manual_seed(5), start, 1), 0)
    tensors = alg.state_tensors(state)
    saved = [t.detach().clone() for t in tensors]

    def restore():
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        state.step = 0

    def train_chunk():
        loss = None
        for _ in range(chunk):
            _, metrics = alg.train_step(state, batch_fixed, gen)
            loss = metrics["loss"]
        return loss

    def full_chunk(fuse: bool):
        return lambda: exp.train_steps_device(chunk, fuse_window=fuse)

    out = {"protocol": {"batch": batch, "list_size": list_size,
                        "features": features, "hidden": hidden,
                        "chunk": chunk, "steps": n_steps, "kernels": kernels},
           "device": str(device), "graphs": cuda, "prng": prng,
           # torch's generator on the device: Philox4x32-10 on the card,
           # the Mersenne Twister on the CPU
           "generator": "philox4x32-10" if cuda else "mt19937",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    eager = {"feed": feed_chunk, "train": train_chunk,
             "full": full_chunk(False)}
    for name, run in eager.items():
        gen.manual_seed(1)
        out[f"{name}_eager_us"] = _per_step_us(run, chunks, n_steps, device)
    restore()
    if cuda:
        graphs = {}
        for name, fn in (("feed", feed_chunk), ("train", train_chunk)):
            graphs[name], _ = capture(fn, [gen], restore)
        for name, graph in graphs.items():
            gen.manual_seed(1)
            out[f"{name}_us"] = _per_step_us(graph.replay, chunks, n_steps,
                                             device)
        restore()
        out["full_us"] = _per_step_us(full_chunk(True), chunks, n_steps,
                                      device)
        busy = sum(us for _, us in bc.device_events(full_chunk(True)))
        out["busy_share"] = busy / chunk / out["full_us"] or None
    else:
        out.update(feed_us=None, train_us=None, full_us=None,
                   busy_share=None)
    out["launches"] = bc.launches_since(before)
    return out


def main(argv=None) -> dict:
    p = bc.tool_parser(__doc__.splitlines()[0], kernels=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--prng", default=PRNG, choices=bc.PRNGS)
    p.add_argument("--batch", type=int, default=bc.BATCH)
    p.add_argument("--list-size", type=int, default=bc.LIST)
    p.add_argument("--features", type=int, default=bc.FEATURES)
    p.add_argument("--hidden", default=bc.HIDDEN)
    args = p.parse_args(argv)
    device = bc.start(args)
    out = profile(device, args.steps, args.batch, args.list_size,
                  args.features, args.hidden, prng=args.prng,
                  kernels=args.kernels)
    for name in ("feed", "train", "full"):
        graph = out[f"{name}_us"]
        print(f"  {name:5s} "
              + ("" if graph is None else f"{graph:10.2f} us/step graph, ")
              + f"{out[f'{name}_eager_us']:10.2f} us/step eager", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
