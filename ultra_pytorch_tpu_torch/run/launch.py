"""Start the training CLI as the ranks of one data-parallel run.

The port's counterpart of the JAX package's ``tools/run_multihost.py``.
:func:`launch` starts N local processes of ``python -m
ultra_pytorch_tpu_torch.run`` under the JAX trainer's multi-host
variables, ``ULTRA_COORDINATOR`` (here a ``file://`` store in the log
directory, so no port is taken), ``ULTRA_NUM_PROCESSES`` and
``ULTRA_PROCESS_ID``, each with ``--device cpu`` or ``cuda`` (rank i on
``cuda:i``), and collects their return codes and the tails of their
output::

    python -m ultra_pytorch_tpu_torch.run.launch --processes 2 \\
        --device cpu --log_dir /tmp/ranks -- --data_dir ./tests/data/ \\
        --setting_file configs/dla.json --model_dir /tmp/dp_model

Across hosts, start one process a card on each host yourself with
``ULTRA_COORDINATOR=host:port`` (a ``tcp://`` rendezvous at rank 0's host).
The CLI's ``--dp N`` on one host spawns its ranks in-process instead
(:func:`spawn_cli`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ultra_pytorch_tpu_torch.parallel import (
    close_data_parallel, init_data_parallel, spawn_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VARS = ("ULTRA_COORDINATOR", "ULTRA_NUM_PROCESSES", "ULTRA_PROCESS_ID")
TAIL_CHARS = 4000   # of each rank's output, in launch's result


def coordinated_rank() -> Optional[Tuple[int, int, str]]:
    """(rank, world size, init method) of a process launched under
    ``ULTRA_COORDINATOR`` (``host:port``, or a URL such as ``file://...``
    taken as it is), ``ULTRA_NUM_PROCESSES`` and ``ULTRA_PROCESS_ID``;
    None when ``ULTRA_COORDINATOR`` is unset."""
    addr = os.environ.get("ULTRA_COORDINATOR")
    if not addr:
        return None
    missing = [v for v in ENV_VARS[1:] if v not in os.environ]
    if missing:
        raise SystemExit(
            f"ULTRA_COORDINATOR is set but {' and '.join(missing)} "
            f"{'is' if len(missing) == 1 else 'are'} missing: a multi-process "
            f"launch needs all of {', '.join(ENV_VARS)}")
    init_method = addr if "://" in addr else f"tcp://{addr}"
    return (int(os.environ["ULTRA_PROCESS_ID"]),
            int(os.environ["ULTRA_NUM_PROCESSES"]), init_method)


def rank_device(device: str, rank: int) -> torch.device:
    """Rank `rank`'s device: ``cuda:{rank mod the visible cards}`` for a
    bare ``cuda``; any other device as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def host_threads(ranks_on_host: int) -> int:
    """Intra-op threads a rank when `ranks_on_host` ranks share this host's
    cores: ranks that each take every core oversubscribe them, and CPU
    ranks then spend most of a step waiting for one another."""
    return max(1, (os.cpu_count() or 1) // ranks_on_host)


def _cli_rank(rank: int, world_size: int, args, init_method: str) -> None:
    from ultra_pytorch_tpu_torch.run import __main__ as cli

    torch.set_num_threads(host_threads(world_size))
    with open(os.devnull, "w") as sink, contextlib.ExitStack() as stack:
        if rank:
            stack.enter_context(contextlib.redirect_stdout(sink))
        init_data_parallel(world_size, rank, rank_device(args.device, rank),
                           init_method=init_method)
        try:
            cli.run(args)
        finally:
            close_data_parallel()


def spawn_cli(args, world_size: int) -> None:
    """Run the parsed CLI `args` as `world_size` ranks on this host, each
    a spawned process; only rank 0 prints."""
    store = tempfile.mkdtemp(prefix="ultra_dp_")
    try:
        spawn_ranks(_cli_rank, world_size,
                    (args, f"file://{os.path.join(store, 'rendezvous')}"),
                    timeout=None)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def launch(cli_args: Sequence[str], processes: int = 2, device: str = "cpu",
           log_dir: Optional[str] = None, timeout: float = 600.0
           ) -> Dict[str, List]:
    """Run the CLI with `cli_args` in `processes` processes under the
    ``ULTRA_*`` variables (and ``OMP_NUM_THREADS``, unless set, at
    ``host_threads``); returns ``{"returncodes", "logs", "tails"}`` (each
    process's output in ``<log_dir>/rank<i>.log``). A run past `timeout`
    seconds kills every process and raises RuntimeError."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="ultra_launch_")
    os.makedirs(log_dir, exist_ok=True)
    store = os.path.join(log_dir, "rendezvous")
    if os.path.exists(store):   # a stale store would hang the rendezvous
        os.remove(store)
    pythonpath = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    procs, logs = [], []
    deadline = time.monotonic() + timeout
    try:
        for rank in range(processes):
            env = dict(os.environ, PYTHONPATH=pythonpath,
                       OMP_NUM_THREADS=os.environ.get(
                           "OMP_NUM_THREADS", str(host_threads(processes))),
                       ULTRA_COORDINATOR=f"file://{store}",
                       ULTRA_NUM_PROCESSES=str(processes),
                       ULTRA_PROCESS_ID=str(rank))
            logs.append(os.path.join(log_dir, f"rank{rank}.log"))
            with open(logs[-1], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ultra_pytorch_tpu_torch.run",
                     *cli_args, "--device", device],
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        rcs = []
        for proc in procs:
            try:
                rcs.append(proc.wait(max(deadline - time.monotonic(), 1.0)))
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"the ranks did not finish within {timeout:.0f} s; "
                    f"their output is in {log_dir}") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tails = []
    for path in logs:
        with open(path, errors="replace") as fin:
            tails.append(fin.read()[-TAIL_CHARS:])
    return {"returncodes": rcs, "logs": logs, "tails": tails}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--log_dir", default=None)
    p.add_argument("--timeout", type=float, default=3600.0)
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="the training CLI's arguments, after --")
    a = p.parse_args(argv)
    cli_args = a.cli_args[1:] if a.cli_args[:1] == ["--"] else a.cli_args
    out = launch(cli_args, a.processes, a.device, a.log_dir, a.timeout)
    print(json.dumps({"returncodes": out["returncodes"],
                      "logs": out["logs"]}))
    ok = all(rc == 0 for rc in out["returncodes"])
    if not ok:
        for tail in out["tails"]:
            print("=" * 60 + "\n" + tail)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
