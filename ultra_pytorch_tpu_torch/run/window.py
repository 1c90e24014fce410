"""A training window and a validation pass as captured CUDA graphs.

The port's counterpart of the JAX trainer's ``_train_multi_fn`` /
``train_steps_device`` and ``_fused_validate_fn`` / ``validate_device``
(the JAX package's ``run/experiment.py``). JAX compiles a checkpoint
window into one ``jax.jit`` program, the window's plan and a ``lax.scan``
over its steps; here the window's launches (the plan with K5, or the
online feed's batch a step, each step's K1-K4 and every library launch
between them) are recorded once into a ``torch.cuda.CUDAGraph`` and
replayed with one host call. A graph replays into the addresses it
recorded, which is why every step updates the state in place
(``algorithms/base.py``; the DBGD family's scratch candidate is written in
place too, and is scratch, not state).

What a replay needs that the recording fixed:

* the window's start step, a 0-dim int64 tensor on the card refilled
  before each replay (the dynamic-bias eta of the plan reads it, and the
  online feed's eta reads the start plus the step's index);
* the window's generator, registered with the graph
  (``CUDAGraph.register_generator_state``): a replay draws from the
  generator's seed and offset at replay time, so reseeding it from the
  data key before each replay gives the draws of the eager window. A
  data-parallel window of more than one rank has a second one, this
  rank's shard generator: the graphs own it, register it beside the
  replica generator and reseed it from the window's seed as
  ``parallel.shard_generator`` seeds the eager window's fresh one;
* the counters, one table: the spans' registry (``utils/spans.py``; the
  kernels' launches, the DBGD family's ``online.*`` passes). They count
  in Python, so a capture counts each once; :class:`Replayable` adds
  what the capture counted on every replay, and the warm-up's count is
  taken off. A new counter is one ``spans.count`` call where it counts,
  replayed with its graph with no further edit here.

A data-parallel window under NCCL is captured whole, the counterpart of
``make_dp_train_step(window=W)``: the gradient's and the batch
statistics' all-reduces and the final one of the window's means are NCCL
kernels inside the graph. The warm-up creates the communicator (NCCL
makes it at the first collective, which capture refuses).

Capture refuses a host read (``.item()``, ``.tolist()``, a ``bool`` of a
device tensor) and a copy from pageable host memory; the run then raises.
Nothing falls back to the eager window.

Spans (``utils/spans.py``): a capture's host time in parts, under
``capture.<name>``; a window's graph holds seven stamp nodes, eight in
an online window (the device clock at the window's edges, the plan's end
and its last step's phases), none where the stamp kernel cannot run.
"""

from __future__ import annotations

import collections
import gc
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ultra_pytorch_tpu_torch.algorithms.base import TrainState, train_window
from ultra_pytorch_tpu_torch.utils import spans


def read_launches() -> List[int]:
    """K1-K5's launch counts, in that order, from the spans' registry."""
    counted = spans.counters()
    return [counted[name] for name in spans.KERNEL_LAUNCHES]


class Replayable:
    """A captured graph (anything with ``replay()``) and what its capture
    counted into the spans' registry (`counts`, by name): :meth:`replay`
    replays it and adds those counts to the registry and to
    ``Replayable.replayed`` (every replay's counts, in this process)."""

    replayed: Dict[str, int] = collections.Counter()

    def __init__(self, graph, counts: Dict[str, int]):
        self.graph = graph
        self.counts = dict(counts)

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.counts.items():
            spans.count(name, n)
            Replayable.replayed[name] += n


def capture(fn: Callable[[], object],
            generators: Sequence[torch.Generator] = (),
            restore: Optional[Callable[[], None]] = None, pool=None,
            name: str = "graph"):
    """`fn()` as one CUDA graph: returns (a :class:`Replayable`, what the
    captured `fn()` returned: the graph's static outputs).

    `fn` first runs once eagerly on a side stream, its warm-up (lazy
    initialisation, a library's first-call set-up and the kernels' builds
    may not happen under capture); then every generator's state is put
    back and `restore()` undoes what else that run changed. The capture
    runs with garbage collection off. The spans' counters end as they
    began: a replay adds what the capture counted. Each of `generators`
    is registered with the graph, so reseed it before each replay.
    `pool` (``torch.cuda.graph_pool_handle()``) shares one memory
    pool between graphs that never replay at once. A call that capture
    refuses inside `fn` raises here.

    `name` names the graph's host spans (``utils/spans.py``):
    ``capture.<name>`` around ``capture.warmup``, ``capture.restore``,
    ``capture.generators`` and ``capture.record`` (``capture.sync``,
    ``capture.trace``, ``capture.instantiate``); a training window is
    ``window.<steps>``, a validation pass ``validate.<split>``, a serving
    bucket ``serve.<bq>x<bl>``."""
    with spans.span(f"capture.{name}"):
        before = spans.counters()
        with spans.span("capture.warmup"):
            states = [g.get_state() for g in generators]
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn()
            current.wait_stream(side)
        with spans.span("capture.restore"):
            for g, state in zip(generators, states):
                g.set_state(state)
            if restore is not None:
                restore()
        warmed = spans.counters()
        with spans.span("capture.generators"):
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
        # No garbage collection under capture: one may free an unreachable
        # graph (a dropped Scorer's, held in a reference cycle), and
        # destroying a graph is a call that capture refuses, so this
        # capture would fail.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with spans.span("capture.record"):
                with spans.span("capture.sync"):
                    recording = torch.cuda.graph(graph, pool=pool)
                    recording.__enter__()
                try:
                    with spans.span("capture.trace"):
                        out = fn()
                except BaseException:
                    recording.__exit__(*sys.exc_info())
                    raise
                with spans.span("capture.instantiate"):
                    recording.__exit__(None, None, None)
        finally:
            if collecting:
                gc.enable()
        counts = {k: n - warmed.get(k, 0)
                  for k, n in spans.counters().items()
                  if n != warmed.get(k, 0)}
        spans.set_counters(before)
    return Replayable(graph, counts), out


class WindowGraphs:
    """Training windows of one algorithm, feed and state as CUDA graphs,
    one a window length (a CLI run has at most two: the checkpoint window
    and the tail). A length seen for the first time is captured there,
    after a warm-up window on a copy of the state that is then put back,
    so the warm-up advances no training.

    A data-parallel rank passes `sync`, the cross-rank mean
    (``parallel.all_reduce_mean``): it is the algorithm's ``grad_sync``
    while the window is captured, and the window's means go through it
    last. With more than one rank it also passes `shard_seed`, which maps
    the window's seed to this rank's shard generator's seed
    (``functools.partial(parallel.shard_seed, rank=r)``); the graphs then
    own that generator."""

    def __init__(self, algorithm, feed, state: TrainState,
                 generator: torch.Generator,
                 sync: Optional[Callable] = None,
                 shard_seed: Optional[Callable[[int], int]] = None):
        self.algorithm, self.feed, self.state = algorithm, feed, state
        self.generator = generator
        self.sync, self.shard_seed = sync, shard_seed
        self.shard = (None if shard_seed is None
                      else torch.Generator(device=generator.device))
        # Registered with every graph; one when there is no shard
        # generator (one rank's shard generator is the replica one).
        self.generators = [generator] + (
            [] if self.shard is None else [self.shard])
        self.start = torch.zeros((), dtype=torch.int64,
                                 device=generator.device)
        self.graphs: Dict[int, Tuple[Replayable, List[str],
                                     torch.Tensor]] = {}
        # Each graph's stamps (None: captured without them).
        self.marks: Dict[int, Optional[spans.Marks]] = {}

    def reseed(self, seed: int) -> None:
        """Seed the generators for the window whose seed is `seed`."""
        self.generator.manual_seed(seed)
        if self.shard is not None:
            self.shard.manual_seed(self.shard_seed(seed))

    def window(self, num_steps: int) -> Tuple[List[str], torch.Tensor]:
        """The window that is captured, from the step in ``self.start``:
        the metric names and their window means (over the ranks under
        `sync`) as one tensor. Runs eagerly where called outside a
        capture; advances ``state.step`` on the host."""
        alg = self.algorithm
        alg.grad_sync, alg.shard_generator = self.sync, self.shard
        try:
            _, keys, means = train_window(alg, self.feed, self.state,
                                          self.generator, num_steps,
                                          start=self.start)
        finally:
            alg.grad_sync = alg.shard_generator = None
        return keys, means if self.sync is None else self.sync(means)

    def _capture(self, num_steps: int):
        state = self.state
        step = state.step
        tensors = self.algorithm.state_tensors(state)
        saved = [t.detach().clone() for t in tensors]

        def restore():
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            state.step = step

        with spans.marking() as marks:
            graph, (keys, means) = capture(lambda: self.window(num_steps),
                                           self.generators, restore,
                                           name=f"window.{num_steps}")
        self.marks[num_steps] = marks
        state.step = step   # the capture ran the Python side of the window
        return graph, keys, means

    def run(self, seed: int, num_steps: int
            ) -> Tuple[List[str], torch.Tensor]:
        """Replay the window of `num_steps` steps from ``state.step`` with
        the generators seeded from `seed`; advances ``state.step``.
        Returns the metric names and a copy of their window means (the
        graph's own output is overwritten by its next replay). The replay
        is window ``state.step`` of the spans (``utils/spans.replay``),
        which first reads the earlier replays that have ended."""
        window = self.state.step
        if num_steps not in self.graphs:
            with spans.in_window(window, num_steps):
                self.graphs[num_steps] = self._capture(num_steps)
        graph, keys, means = self.graphs[num_steps]
        self.start.fill_(window)
        self.reseed(seed)
        spans.replay(graph.replay, self.marks[num_steps], window, num_steps)
        self.state.step += num_steps
        return keys, means.clone()
