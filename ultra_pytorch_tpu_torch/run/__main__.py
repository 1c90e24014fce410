"""The port's training CLI, flag-compatible with the JAX package's
``main.py``, plus ``--device`` (default ``cuda``; without a card that is an
error, not the CPU):

    python -m ultra_pytorch_tpu_torch.run --data_dir=./tests/data/ \\
        --setting_file=configs/dla.json --model_dir=./model/ \\
        --max_train_iteration=1000 [--device cpu]
    python -m ultra_pytorch_tpu_torch.run ... --test_only

Training runs windows of ``--steps_per_checkpoint`` steps; after each it
validates, logs, and checkpoints the full state when the objective
improves. On the card each window is one replayed CUDA graph
(``run/window.py``), a data-parallel rank's under NCCL with its
all-reduces inside, and each validation pass another; the run prints
once whether its windows are captured, or why they run eager (the CPU, or
a gloo group).

The loop is pipelined one window deep, as the JAX trainer's: it dispatches
window k + 1 and its validation (and the test split's under
``--test_while_train``) before it reads window k's results back, so the
host waits for window k while the card already has the next one. Window
k's checkpoint is decided then, from a device copy of its state taken at
its end (``Experiment.snapshot_state``), so it saves exactly the state its
validation measured. ``--sync_readback`` reads each window back before it
dispatches the next; both loops print the same metrics and save the same
checkpoints. A window's queries/s is over its ``window.device`` span
(``utils/spans.py``: the card's clock at the graph's first and last
node), so a checkpoint saved while the next window trains does not
inflate it; a window without that span (eager on the CPU or a gloo
group, or the stamp kernel unable to run) has its rate from the previous
read-back to its own. A window whose mean loss is nan or +inf
(:func:`diverged_loss`, as the JAX ``main.py`` reads it: -inf does not
stop a run) stops the run
before its checkpoint decision, so it never overwrites the best
checkpoint, and the window already dispatched after it is never read. A
run that wrote no checkpoint, diverged or not, saves its final state at
its end, as ``main.py`` does. ``--test_only`` restores the checkpoint,
prints the test metrics and writes a TREC ranklist. ``--profile_steps N``
traces the first N steps with ``torch.profiler`` into
``<model_dir>/profile``: ``trace.json`` with the program's ranges and
``spans.json``.

Data parallelism, one process a device:

* ``--dp N`` (or ``auto``: every visible card when the batch divides by
  their count) spawns N ranks on this host, rank i on ``cuda:i`` (or all
  on the CPU with ``--device cpu``); only rank 0 prints.
* ``ULTRA_COORDINATOR=host:port ULTRA_NUM_PROCESSES=N ULTRA_PROCESS_ID=i``
  (the JAX trainer's multi-host launch; ``run/launch.py`` starts such
  processes) makes this process rank i of N, on ``cuda:{i mod the visible
  cards}``, and each rank keeps only its stripe of the train split.
  ``ULTRA_COORDINATOR`` may also be a ``file://`` store.
* ``--shard_data`` keeps only each rank's stripe of the train split; it
  needs a group of more than one rank.

``--prng rbg`` and ``unsafe_rbg`` give the data key the JAX trainer's
rbg shape (four 32-bit words) and are recorded in the checkpoint, which a
run under another ``--prng`` refuses to restore; the draws are Philox
whatever the flag.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import torch

from ultra_pytorch_tpu_torch.parallel import (
    close_data_parallel, init_data_parallel)
from ultra_pytorch_tpu_torch.run import launch
from ultra_pytorch_tpu_torch.run.experiment import (
    KEY_WORDS, PRNG_IMPL, Experiment, resolve_dp)
from ultra_pytorch_tpu_torch.utils import spans
from ultra_pytorch_tpu_torch.utils.logging_utils import (
    MetricLogger, profile_ctx)

# The shown list's metrics that the online family's steps report.
ONLINE_METRICS = ("online_reward", "online_ndcg")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ULTRA-TPU PyTorch/CUDA port")
    p.add_argument("--data_dir", type=str, default="./tests/data/")
    p.add_argument("--train_data_prefix", type=str, default="train")
    p.add_argument("--valid_data_prefix", type=str, default="valid")
    p.add_argument("--test_data_prefix", type=str, default="test")
    p.add_argument("--model_dir", type=str, default="./tmp_model/")
    p.add_argument("--output_dir", type=str, default="./tmp_output/")
    p.add_argument("--setting_file", type=str,
                   default="./example/offline_setting/dla_exp_settings.json")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--data_format", type=str, default="ULTRA",
                   choices=["ULTRA", "ULTRE"])
    p.add_argument("--click_model_dir", type=str, default=None)
    p.add_argument("--max_list_cutoff", type=int, default=0,
                   help="0 = no cutoff on candidate lists")
    p.add_argument("--selection_bias_cutoff", type=int, default=10)
    p.add_argument("--max_train_iteration", type=int, default=10000)
    p.add_argument("--start_saving_iteration", type=int, default=0)
    p.add_argument("--start_checkpoint", type=str, default="")
    p.add_argument("--steps_per_checkpoint", type=int, default=50)
    p.add_argument("--test_while_train", action="store_true")
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", type=str, default="auto",
                   help="data-parallel ranks: 'auto' (every visible card "
                        "when >1 and batch_size divides), 'off', or a count")
    p.add_argument("--shard_data", action="store_true")
    p.add_argument("--log_dir", type=str, default="",
                   help="JSONL metric log (default <model_dir>/logs)")
    p.add_argument("--profile_steps", type=int, default=0)
    p.add_argument("--restore_params_only", action="store_true")
    p.add_argument("--sync_readback", action="store_true")
    p.add_argument("--prng", type=str, default=PRNG_IMPL,
                   choices=list(KEY_WORDS))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def build_experiment(args, splits, hosts: int = 1) -> Experiment:
    with open(args.setting_file) as fin:
        exp_settings = json.load(fin)
    if args.selection_bias_cutoff > 0:
        exp_settings.setdefault("selection_bias_cutoff",
                                args.selection_bias_cutoff)
    if args.click_model_dir:
        exp_settings["click_model_dir"] = args.click_model_dir
    exp = Experiment(
        exp_settings, args.data_dir, args.model_dir,
        batch_size=args.batch_size, data_format=args.data_format,
        seed=args.seed,
        rank_cut=args.max_list_cutoff if args.max_list_cutoff > 0 else None,
        dp=args.dp, shard_data=args.shard_data,
        split_prefixes={"train": args.train_data_prefix,
                        "valid": args.valid_data_prefix,
                        "test": args.test_data_prefix},
        device=args.device, prng_impl=args.prng)
    exp.setup(splits=splits)
    if exp.data_parallel:
        print(f"Data parallelism: {exp.world_size}-device mesh "
              f"({hosts} host(s))", flush=True)
    return exp


def _restore(exp: Experiment, args) -> bool:
    restored = exp.restore(args.start_checkpoint or None,
                           params_only=args.restore_params_only)
    if restored:
        what = "ranker params" if args.restore_params_only else "checkpoint"
        print(f"Restored {what} from "
              f"{args.start_checkpoint or exp.ckpt_path}")
    return restored


def diverged_loss(loss: Optional[float]) -> bool:
    """Whether a window's mean loss stops the run: nan or +inf, as
    ``main.py`` tests it (a missing loss or -inf does not)."""
    return loss is not None and (loss != loss or loss == float("inf"))


def _line(summary) -> str:
    return ", ".join(f"{k}={v:.5f}" for k, v in sorted(summary.items()))


class _Fetch:
    """Device vectors on their way to the host: the copy is enqueued at
    once (into pinned memory on the card) and :meth:`values` waits for it
    alone, not for the work dispatched after it."""

    def __init__(self, vectors: List[Optional[torch.Tensor]]):
        parts = [v for v in vectors if v is not None]
        self.sizes = [None if v is None else v.numel() for v in vectors]
        flat = torch.cat([v.reshape(-1).float() for v in parts])
        self.done = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host = flat

    def values(self) -> List[Optional[List[float]]]:
        if self.done is not None:
            self.done.synchronize()
        flat, out, off = self.host.tolist(), [], 0
        for n in self.sizes:
            out.append(None if n is None else flat[off: off + n])
            off += n or 0
        return out


def train(args, hosts: int = 1) -> None:
    splits = ("train", "valid", "test") if args.test_while_train else (
        "train", "valid")
    exp = build_experiment(args, splits, hosts)
    exp.init_state()
    _restore(exp, args)
    lead = exp.rank == 0   # the one rank that writes logs and traces
    logger = MetricLogger((args.log_dir or os.path.join(
        args.model_dir, "logs")) if lead else None)
    objective = exp.exp_settings.get("objective_metric", "ndcg_10")
    best, step = None, 0
    if args.profile_steps > 0:
        with profile_ctx(os.path.join(args.model_dir, "profile")
                         if lead else None):
            exp.train_steps(args.profile_steps)
        step += args.profile_steps
    t_flush = time.perf_counter()

    def flush(entry) -> bool:
        """Read one window's results back, print and log them, and decide
        its checkpoint; False when the window diverged."""
        nonlocal best, t_flush
        train_h, summary_h, test_h = entry["fetch"].values()
        device_ms = spans.latest_ms("window.device", entry["start"])
        seconds = (time.perf_counter() - t_flush if device_ms is None
                   else device_ms / 1e3)
        qps = entry["window"] * args.batch_size / seconds
        metrics = dict(zip(entry["train_keys"], train_h))
        summary = dict(zip(entry["keys"], summary_h))
        at = entry["step"]
        online = "".join(f" {k} {metrics[k]:.5f}" for k in ONLINE_METRICS
                         if k in metrics)
        print(f"step {at} loss {metrics.get('loss', float('nan')):.5f} "
              f"({qps:.0f} queries/s){online} | {_line(summary)}",
              flush=True)
        logger.log("train", at, dict(metrics, queries_per_sec=qps))
        logger.log("valid", at, summary)
        if test_h is not None:
            test_summary = dict(zip(entry["keys"], test_h))
            logger.log("test", at, test_summary)
            print("  test: " + _line(test_summary))
        # The divergence check comes before the checkpoint decision: a
        # window whose loss went inf/nan never overwrites the best one.
        diverged = diverged_loss(metrics.get("loss"))
        obj = summary.get(objective)
        if (not diverged and obj is not None and obj == obj
                and (best is None or obj > best)
                and at >= args.start_saving_iteration):
            best = obj
            exp.save({"step": at, objective: obj},
                     state_and_rng=entry["snap"])
            print(f"  saved checkpoint ({objective}={obj:.5f})")
        # Taken after the save, so its host time is not billed to the
        # next window's rate.
        t_flush = time.perf_counter()
        if diverged:
            print("Divergence detected (loss inf/nan); stopping.")
        return not diverged

    pending = None
    while step < args.max_train_iteration:
        window = min(args.steps_per_checkpoint,
                     args.max_train_iteration - step)
        start = exp.state.step   # the window's id in the spans
        train_keys, metrics_dev = exp.train_steps_device(window)
        keys, summary_dev = exp.validate_device("valid")
        test_dev = (exp.validate_device("test")[1]
                    if args.test_while_train else None)
        step += window
        entry = {"step": step, "start": start, "window": window,
                 "train_keys": train_keys, "keys": keys,
                 "fetch": _Fetch([metrics_dev, summary_dev, test_dev]),
                 # Read back at once, the live state is the window's own.
                 "snap": None if args.sync_readback else exp.snapshot_state()}
        if args.sync_readback:
            if not flush(entry):
                break
            continue
        if pending is not None and not flush(pending):
            # The window dispatched after it trained from the diverged
            # state: it is never read, so it cannot overwrite the best
            # checkpoint.
            pending = None
            break
        pending = entry
    if pending is not None:
        flush(pending)
    if best is None:
        exp.save({"step": step})
    logger.close()
    print(f"Training done at step {step}; best {objective}={best}")


def test(args, hosts: int = 1) -> None:
    exp = build_experiment(args, ("test",), hosts)
    exp.init_state()
    if not _restore(exp, args):
        print("WARNING: no checkpoint found; testing from random init")
    summary = exp.validate("test")
    for k in sorted(summary):
        print(f"{k}: {summary[k]:.5f}")
    if exp.rank == 0:
        os.makedirs(args.output_dir, exist_ok=True)
        path, _ = exp.write_ranklist("test", args.output_dir)
        print(f"Wrote {path}")


def run(args, hosts: int = 1) -> None:
    """Test or train in this process (a rank, when it has joined a
    process group)."""
    if args.test_only:
        test(args, hosts)
    else:
        train(args, hosts)


def main(argv=None) -> None:
    args = parse_args(argv)
    os.makedirs(args.model_dir, exist_ok=True)
    coordinated = launch.coordinated_rank()
    if coordinated is not None:
        rank, world, init_method = coordinated
        if resolve_dp(args.dp, args.batch_size, "cpu") not in (1, world):
            raise ValueError(f"--dp {args.dp} under ULTRA_NUM_PROCESSES="
                             f"{world}: one process is one rank")
        # Each process is a host here: it keeps its stripe of the train
        # split, as the JAX trainer's hosts do.
        args.shard_data = args.shard_data or world > 1
        init_data_parallel(world, rank, launch.rank_device(args.device, rank),
                           init_method=init_method)
        try:
            run(args, hosts=world)
        finally:
            close_data_parallel()
        return
    world = 1 if args.test_only else resolve_dp(args.dp, args.batch_size,
                                                args.device)
    if world > 1:
        launch.spawn_cli(args, world)
    else:
        run(args)


if __name__ == "__main__":
    main()
