"""Data parallelism over ``torch.distributed``: one process a device.

The port's counterpart of the JAX package's ``parallel/mesh.py``. Where
the JAX package builds a device mesh and runs its step under
``shard_map`` with ``lax.pmean`` over the data axis, the port runs one
process a device (a rank), joined in a process group:

* parameters and every algorithm's aux state are replicated: each rank
  holds the same copy and applies the same update;
* each rank draws its own batch of B / N queries (the feed's per-rank
  batch size) from its shard generator, simulates clicks and takes its
  local gradient;
* the algorithm's ``grad_sync`` hook is bound to :func:`all_reduce_mean`,
  so the flat gradient is averaged once a step before the clip and the
  optimizer, and the batch statistics of Regression-EM, PairDebias,
  LambdaRank and the DBGD family are averaged where the JAX package
  averages them;
* two generators a step: the replica generator, the same on every rank
  (the DBGD family's candidate noises, NSGD's combinations), and the
  shard generator, seeded from the replica generator's seed and the rank
  (:func:`shard_seed`, the counterpart of ``fold_in(key, axis_index)``;
  the feed's draws, Regression-EM's uniforms, the DBGD family's winners,
  the ranker's dropout). With one rank both are the same generator.

:func:`dp_train_steps` runs such a window eagerly. Under NCCL on the card
the Experiment captures the same window as one CUDA graph instead
(``run/window.WindowGraphs`` with ``sync=all_reduce_mean``), every
all-reduce inside it, as ``make_dp_train_step(window=W)`` compiles the
``pmean``s into one program; a gloo collective runs on the host, so a
gloo window stays eager.

JAX's ``host_stacked_dataset`` and ``device_sharded_dataset`` express "a
different stripe on each device" in JAX's global-array model. With one
process a device, each rank simply holds its own stripe
(:func:`shard_queries_for_host`) on its own device, so neither has a
counterpart here.

The backend follows the device: NCCL for CUDA, gloo for the CPU. Gloo
also reduces CUDA tensors (through the host), which lets two ranks share
one card; it is chosen only when the caller passes ``backend="gloo"``.
Gloo on CUDA tensors offers ``all_reduce`` and ``broadcast`` only, so the
shared path uses nothing else.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue as queue_lib
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ultra_pytorch_tpu_torch.algorithms.base import train_window

_SHARD_TAG = 0x5A4D       # mixed into a shard generator's seed
_MASK64 = (1 << 64) - 1
# How long a rank waits at the rendezvous and in a collective.
_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_data_parallel(world_size: int, rank: int, device,
                       backend: Optional[str] = None,
                       init_method: str = "env://") -> str:
    """Join this process to the default process group as `rank` of
    `world_size` on `device`; returns the backend. `init_method` is a
    ``tcp://host:port`` address, a ``file://`` store or ``env://``."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if device.index is None else device.index)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=_GROUP_TIMEOUT)
    return dist.get_backend()


def close_data_parallel() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def group_size() -> int:
    """The default group's size; 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def all_reduce_mean(x: Union[torch.Tensor, Sequence[torch.Tensor]]
                    ) -> Union[torch.Tensor, List[torch.Tensor]]:
    """The mean over the ranks (``lax.pmean``) of a tensor, or of a list of
    tensors in one collective; new tensors, the inputs are left alone."""
    if not isinstance(x, torch.Tensor):
        flat = all_reduce_mean(torch.cat([t.reshape(-1) for t in x]))
        return [piece.view(t.shape) for piece, t in zip(
            torch.split(flat, [t.numel() for t in x]), x)]
    out = x.detach().clone()
    if dist.get_backend() == "nccl":
        dist.all_reduce(out, op=dist.ReduceOp.AVG)
    else:   # gloo has no AVG
        dist.all_reduce(out)
        out /= dist.get_world_size()
    return out


def shard_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s shard generator for a window whose replica
    generator is seeded `seed`."""
    return int(np.random.SeedSequence(
        [seed & _MASK64, rank, _SHARD_TAG]).generate_state(1, np.uint64)[0])


def shard_generator(generator: torch.Generator, rank: int,
                    world_size: int) -> torch.Generator:
    """Rank `rank`'s shard generator for a window whose replica generator
    is `generator`: a generator on the same device seeded from its seed
    and the rank (:func:`shard_seed`); `generator` itself when there is
    one rank."""
    if world_size <= 1:
        return generator
    return torch.Generator(device=generator.device).manual_seed(
        shard_seed(generator.initial_seed(), rank))


def same_on_every_rank(leaves, device) -> bool:
    """Whether `leaves` (numpy arrays, e.g. ``state_leaves``) hold the same
    bytes on this rank as on rank 0: rank 0's bytes are broadcast on
    `device` and compared bit for bit (gloo on CUDA tensors has broadcast
    but no all_gather)."""
    raw = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                          for a in leaves])
    raw = np.concatenate([raw, np.zeros(-raw.size % 4, np.uint8)])
    mine = torch.from_numpy(raw.view(np.int32)).to(device)
    theirs = mine.clone()
    dist.broadcast(theirs, 0)
    return bool(torch.equal(mine, theirs))


def shard_queries_for_host(dataset, host_id: int, num_hosts: int):
    """Stripe `host_id` of `num_hosts` of a RankingDataset (a new one).

    Each stripe holds exactly ceil(Q/H) queries: stripe h takes queries
    ``h * ceil(Q/H) ...`` wrapped into the global range (Q=13, H=4 gives
    host 3 the queries 12, 0, 1, 2), and only the feature rows they
    reference, zero-padded to the largest stripe's row count (the padding
    rows are named ``"_PAD_"`` and never referenced). So every stripe has
    the same shapes, as the JAX package's stripes must.
    """
    if num_hosts <= 1:
        return dataset
    q = dataset.num_queries
    if q < num_hosts:
        raise ValueError(f"{q} queries cannot stripe over {num_hosts} hosts")
    qh = -(-q // num_hosts)

    def stripe_sel(h: int) -> np.ndarray:
        return np.arange(h * qh, (h + 1) * qh) % q

    def used_rows(sel: np.ndarray) -> np.ndarray:
        il = dataset.initial_list[sel]
        return np.unique(il[il >= 0])

    max_rows = max(used_rows(stripe_sel(h)).size for h in range(num_hosts))
    sel = stripe_sel(host_id)
    il = dataset.initial_list[sel]
    used = used_rows(sel)
    remap = -np.ones(dataset.features.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    feats = dataset.features[used]
    if feats.shape[0] < max_rows:
        feats = np.concatenate(
            [feats, np.zeros((max_rows - feats.shape[0], feats.shape[1]),
                             feats.dtype)], axis=0)
    return dataclasses.replace(
        dataset,
        features=feats,
        initial_list=np.where(il >= 0, remap[np.maximum(il, 0)], -1),
        labels=dataset.labels[sel],
        initial_scores=(dataset.initial_scores[sel]
                        if dataset.initial_scores is not None else None),
        qids=[dataset.qids[i] for i in sel],
        dids=[dataset.dids[i] for i in used] + ["_PAD_"] * (
            max_rows - used.size),
        initial_list_lengths=None,
    )


def dp_train_steps(algorithm, feed, state, generator: torch.Generator,
                   num_steps: int):
    """`num_steps` data-parallel steps on this rank (``make_dp_train_step``
    with a window): the feed (built with the group's size, so it draws B /
    N queries) draws from this rank's shard generator, each step's
    ``sync`` is :func:`all_reduce_mean`, and the window's mean metrics are
    averaged over the ranks. `generator` is the window's replica
    generator. Returns the state, the metric names and their means as one
    device tensor."""
    rank, world = dist.get_rank(), dist.get_world_size()
    algorithm.grad_sync = all_reduce_mean
    algorithm.shard_generator = shard_generator(generator, rank, world)
    try:
        state, keys, means = train_window(algorithm, feed, state, generator,
                                          num_steps)
    finally:
        algorithm.grad_sync = None
        algorithm.shard_generator = None
    return state, keys, all_reduce_mean(means)


def _rank_entry(fn, rank, world_size, args, results) -> None:
    try:
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable[..., Any], world_size: int,
                args: Tuple = (), timeout: Optional[float] = 120.0
                ) -> List[Any]:
    """``fn(rank, world_size, *args)`` in `world_size` processes started
    with the spawn method (a parent that holds CUDA cannot fork); returns
    their results in rank order. `fn`, `args` and the results are pickled
    (`fn` by its import path). A rank that raises or dies, or a run past
    `timeout` seconds (None: no limit), kills every rank and raises
    RuntimeError."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, args, results))
             for r in range(world_size)]
    out: List[Any] = [None] * world_size
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        pending = set(range(world_size))
        while pending:   # drain the queue before joining
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"ranks {sorted(pending)} did not finish "
                                   f"within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_lib.Empty:
                dead = [r for r in pending
                        if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(None if deadline is None
                   else max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
    return out
