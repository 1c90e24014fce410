"""Spans and counters inside the port: one registry a process.

A span is a named interval with the name of the span around it (its
parent) and the window it belongs to: ``state.step`` at the window's
start, so the spans of one window share that id. Each sample also keeps
the window's step count and whether a profiler was recording. There are
two clocks:

* host spans (:func:`span`): ``time.perf_counter_ns`` at both ends, in
  ms of that clock;
* device spans: the card's global timer (``%globaltimer``, ns), written
  by a one-thread kernel (``ops/kernels/csrc/timer.cu``, a "stamp") into
  pinned host memory and read lazily. A training window's graph
  (``run/window.py`` ``WindowGraphs``) holds seven stamp nodes, eight
  in an online window (:func:`mark`, captured from
  ``algorithms/base.py`` and ``algorithms/dbgd.py``) that write the
  replay's row of a ring of :data:`MARK_ROWS` rows; the first also writes
  the replay's number into the row, so a row is read only when it holds
  that replay's last stamp. Each replay, after its launch, and
  :func:`snapshot` read every replay whose row has landed. A row written
  over before it was read (more than :data:`MARK_ROWS` - 1 replays of the
  graph in flight) is lost and counted in ``spans.device_unread``.
  Stamps, not CUDA events: with seven event-record nodes the card's
  ``cudaGraphLaunch`` took 50-100 µs longer and ``elapsed_time`` 15-20 µs
  a read, 0.6-1.3% of the shortest window; a stamp node launches as any
  kernel node does, costs the card about 3 µs, and a read is a load from
  host memory. Nothing is stamped outside the graph. Where the stamp
  kernel cannot be built, loaded or launched (no ``nvcc``, a card its
  build does not run on), a warning says so once and windows run and
  record their host spans as before, with no device span.

The spans of a window: ``window.device``, the graph's first stamp to its
last; ``window.launch_wait``, the previous window's last stamp to this
window's first (the card waiting between two windows: the launch, and
the host's work between them; in the CLI also the validation passes
between them), recorded where the previous window replayed just before
and was read; ``window.plan``; and ``step.forward`` (the batch's gather
from the plan and ``algorithm.losses``), ``step.backward``
(``gradients``) and ``step.update`` (``apply_gradients``, ``update_aux``
and the stacking and adding of the step's metrics) of the window's last
step alone, since a mark a step would add about 250 nodes to a graph.
Algorithms whose step is the base ``_step`` (DLA, IPW, Regression-EM and
the rest of the offline family) get those three phases. The DBGD family
(DBGD, MGD, NSGD) overrides ``train_step`` and splits its step at its
own points (:data:`ONLINE_POINTS`), in place of ``step.forward`` and
``step.backward``: ``step.feed``, from ``step.start`` to the start of
``train_step`` (the online feed's batch: its ranking of the whole lists
with the current ranker, its Plackett-Luce draw and its click rounds);
``step.candidates`` (the noises, and the current ranker and each
candidate scored); ``step.multileave`` (the rankers' rankings, the
draft, the click uniforms and clicks, and the credit by
``infer_winners``; the nDCG credit under ``need_interleave=false``); and
``step.update``, which there runs from ``step.multileave`` (the noise
update, NSGD's memory, the loss and the metrics). An offline window's
graph keeps its seven stamp nodes; an online one has eight. Host spans:
``window.replay`` (the replay's ``cudaGraphLaunch``) and, under
``capture.<name>``, ``capture.warmup``, ``capture.restore``,
``capture.generators`` and ``capture.record``, which holds
``capture.sync`` (``torch.cuda.graph``'s entry: a synchronise and the
allocator's cache freed), ``capture.trace`` (the function run under
capture) and ``capture.instantiate`` (its exit: the capture ended and
the graph instantiated).

Counters: one table, the registry's (:func:`count`), and every count the
program keeps is in it under its name. The kernel wrappers
(``ops/kernels``) count K1-K5's launches (:data:`KERNEL_LAUNCHES`,
``launches.K1`` ... ``launches.K5``), ``launches.K1_saved``, K1's launches
that saved the forward's residuals for K2 (over ``launches.K2``, the share
of K2's launches fed by them), and ``launches.K1_wgmma``, K1's launches
through its wgmma instance; :func:`counters` and :func:`snapshot` report
these seven (:data:`LAUNCHES`) at 0 before their first count. The DBGD
family counts its passes of a ranker over whole lists, in passes and not
in K1 launches, so they read the same with ``use_pallas`` off:
``online.feed_scored``, the online feed's (one a step), and
``online.rankers_scored``, the algorithm's (1 + ``ranker_num`` a step).
``spans.device_unread`` counts the lost rows. A counter counted while a
graph is captured is counted again at each of its replays
(``run/window.py`` ``Replayable``): a new counter is one :func:`count`
call where it counts, and nothing more.

While ``torch.profiler`` records, each host span and each phase of
:func:`mark` is also a ``record_function`` range of the same name, so
the program's ranges share the device trace's timeline (in an online
step the range that ``step.start`` opens keeps the offline family's
first name, ``step.forward``, and holds the feed's batch). Without a
profiler no range is opened. Memory is bounded: the last :data:`RING`
samples of each name.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

RING = 4096
MARK_ROWS = 4
# The stamp's code for sm_90 and PTX for compute_75, which the driver
# compiles for any later card.
STAMP_FLAGS = ("-gencode", "arch=compute_90,code=sm_90",
               "-gencode", "arch=compute_75,code=compute_75",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

# The points of a window that mark() takes, in order: the ranges each
# closes and opens. The window's edges and the plan's end are marked in
# every captured window, the step's points at its last step alone. The
# DBGD family's step marks ONLINE_POINTS in place of step.forward and
# step.backward; they come last, so an offline window's slots are as
# they were.
POINTS = {
    "window.start": ((), ("window", "window.plan")),
    "window.plan": (("window.plan",), ()),
    "step.start": ((), ("step.forward",)),
    "step.forward": (("step.forward",), ("step.backward",)),
    "step.backward": (("step.backward",), ("step.update",)),
    "step.update": (("step.forward", "step.backward", "step.update"), ()),
    "window.end": (("window",), ()),
    "step.feed": (("step.forward",), ("step.candidates",)),
    "step.candidates": (("step.candidates",), ("step.multileave",)),
    "step.multileave": (("step.multileave",), ("step.update",)),
}
EDGES = ("window.start", "window.plan", "window.end")
ONLINE_POINTS = ("step.feed", "step.candidates", "step.multileave")

# A window's device spans between two of its points: (name, from, to,
# parent); a span whose two points the graph did not stamp is not
# recorded, so step.update runs from step.backward in an offline window
# and from step.multileave in an online one. window.launch_wait runs
# from the previous window's end.
DEVICE_SPANS = (
    ("window.device", "window.start", "window.end", None),
    ("window.plan", "window.start", "window.plan", "window.device"),
    ("step.forward", "step.start", "step.forward", "window.device"),
    ("step.backward", "step.forward", "step.backward", "window.device"),
    ("step.update", "step.backward", "step.update", "window.device"),
    ("step.feed", "step.start", "step.feed", "window.device"),
    ("step.candidates", "step.feed", "step.candidates", "window.device"),
    ("step.multileave", "step.candidates", "step.multileave",
     "window.device"),
    ("step.update", "step.multileave", "step.update", "window.device"),
)

# The kernels' launch counters: K1-K5's, then K1's that saved residuals
# for K2 and K1's through its wgmma instance.
KERNEL_LAUNCHES = tuple(f"launches.K{i}" for i in range(1, 6))
LAUNCHES = KERNEL_LAUNCHES + ("launches.K1_saved", "launches.K1_wgmma")


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) records."""
    return torch._C._autograd._profiler_enabled()


@functools.lru_cache(maxsize=None)
def _library():
    from ultra_pytorch_tpu_torch.ops.kernels import build

    built = build.build_library("timer", [build.CSRC_DIR / "timer.cu"],
                                flags=STAMP_FLAGS)
    lib = ctypes.CDLL(str(built.path))
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.ultra_stamp.argtypes = [ptr, num, num, num, ptr, num, ptr]
    lib.ultra_stamp.restype = ctypes.c_int
    lib.ultra_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ultra_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Marks:
    """The stamp nodes of one captured window graph: a row of
    pinned host memory a replay, one slot a point of :data:`POINTS` and a
    last slot for the replay's number, in a ring of :data:`MARK_ROWS`
    rows. A device counter picks the row: the stamp of ``window.start``
    advances it and writes it to the row, so the n-th replay writes row
    n % MARK_ROWS. ``recorded`` holds the points the capture stamped,
    ``replays`` the graph's launches, ``owners`` the unread replay of
    each row."""

    def __init__(self):
        lib = _library()
        self.slot = {p: i for i, p in enumerate(POINTS)}
        width = len(POINTS) + 1
        self.host = torch.zeros(MARK_ROWS, width, dtype=torch.int64,
                                pin_memory=True)
        self.ns = self.host.numpy()      # a view: reads see the card's
        self.seq = torch.zeros(1, dtype=torch.int32, device="cuda")
        base, seq = self.host.data_ptr(), self.seq.data_ptr()
        self.launch = {p: functools.partial(
            lib.ultra_stamp, base, i, width, MARK_ROWS, seq, int(i == 0))
            for p, i in self.slot.items()}
        self.recorded: List[str] = []
        self.replays = 0
        self.owners: List[Optional[_Replay]] = [None] * MARK_ROWS

    def stamp(self, point: str, stream: int) -> None:
        """Write the timer to `point`'s slot when `stream` (a
        ``cudaStream_t``) reaches this launch."""
        err = self.launch[point](stream)
        if err != 0:
            raise RuntimeError(f"stamp launch failed: "
                               f"{_library().ultra_cuda_error_string(err)} "
                               f"(CUDA error {err})")

    def landed(self, replay: "_Replay") -> Optional[List[int]]:
        """`replay`'s row once it holds the replay's last stamp, else
        None: the row's number is the replay's, and its end is later than
        its start (an end left from the row's previous replay is not)."""
        row = [int(t) for t in self.ns[replay.n % MARK_ROWS]]
        start, end = (row[self.slot[p]] for p in ("window.start",
                                                    "window.end"))
        return row if row[-1] == replay.n and end > start else None


class _Replay:
    """One replay of a window graph: its `n`-th, launched just `after`
    the replay given (None: after a replay without stamps); `marks` is
    None once its row was written over unread, `end` its last stamp once
    read."""

    __slots__ = ("window", "steps", "profiled", "marks", "n", "after",
                 "end")

    def __init__(self, window, steps, profiled, marks, n, after):
        self.window, self.steps, self.profiled = window, steps, profiled
        self.marks, self.n, self.after, self.end = marks, n, after, None


class Registry:
    """The spans and counters of a process (:data:`REGISTRY`); the module
    functions act on it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()   # the open host spans, a thread
        self.samples: Dict[str, collections.deque] = {}
        self.clocks: Dict[str, str] = {}
        self.counters: Dict[str, int] = collections.Counter()
        self.window = None                # (id, steps) while one runs
        self._pending: List[_Replay] = []
        self._last: Optional[_Replay] = None   # the last replay launched
        # Set while a window's graph is captured, and at its last step.
        self.marks: Optional[Marks] = None
        self.sampled = False
        self._ranges: Dict[str, object] = {}
        self.stamps_off: Optional[str] = None  # why no device spans

    def clear(self) -> None:
        """Drop every sample, pending replay and counter."""
        for entry in self._pending:
            if entry.marks is not None:
                entry.marks.owners[entry.n % MARK_ROWS] = None
        self.__init__()

    # -- records --------------------------------------------------------
    def add(self, name: str, clock: str, start: float, end: float,
            parent: Optional[str], window=None, steps=None,
            profiled: bool = False) -> None:
        with self._lock:
            ring = self.samples.get(name)
            if ring is None:
                ring = self.samples[name] = collections.deque(maxlen=RING)
                self.clocks[name] = clock
            ring.append((start, end, parent, window, steps, profiled))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def read_counters(self) -> Dict[str, int]:
        """A copy of the counters, :data:`LAUNCHES` at 0 before their
        first count."""
        with self._lock:
            return {**dict.fromkeys(LAUNCHES, 0), **self.counters}

    def set_counters(self, values: Dict[str, int]) -> None:
        """Put the counters back to `values` (a capture takes its count
        off)."""
        with self._lock:
            self.counters = collections.Counter(values)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around the enclosed code; its parent is the host
        span open around it in this thread."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        window, steps = self.window or (None, None)
        profiled = profiling()
        rf = _enter_range(name) if profiled else None
        stack.append(name)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.add(name, "host", t0 / 1e6, t1 / 1e6, parent, window,
                     steps, profiled)

    @contextlib.contextmanager
    def in_window(self, window: int, steps: int):
        """Spans recorded inside belong to the window `window` (its start
        step) of `steps` steps."""
        was, self.window = self.window, (window, steps)
        try:
            yield
        finally:
            self.window = was

    # -- marks inside a window -----------------------------------------
    @contextlib.contextmanager
    def marking(self):
        """Around a window's capture: :meth:`mark` records the graph's
        stamp nodes into the :class:`Marks` it yields. It yields None
        where the stamp kernel cannot be built, loaded or launched here
        (``stamps_off`` says why, a warning once): the window is captured
        without stamps."""
        marks = None
        if self.stamps_off is None:
            try:
                marks = Marks()
                # Loads the stamp kernel outside the capture; the slot is
                # written again by the replay whose row it is.
                marks.stamp("window.plan",
                            torch.cuda.current_stream().cuda_stream)
            except (RuntimeError, OSError) as err:
                marks, self.stamps_off = None, str(err)
                warnings.warn(f"no device spans: the stamp kernel cannot "
                              f"run here ({err})", stacklevel=3)
        self.marks, self.sampled = marks, False
        try:
            yield marks
        finally:
            self.marks = None

    def mark(self, point: str, last: bool = True) -> None:
        """A point of :data:`POINTS` in a window (``step.start`` with
        `last` whether the step is the window's last). Under a window's
        capture it records the point's stamp node (the edges always, a
        step's points at the last step); while a profiler records it
        closes and opens the point's ranges. Otherwise nothing."""
        if point == "step.start":
            self.sampled = last
        marks = self.marks
        if marks is not None and (self.sampled or point in EDGES) \
                and torch.cuda.is_current_stream_capturing():
            marks.stamp(point, torch.cuda.current_stream().cuda_stream)
            marks.recorded.append(point)
        if self._ranges or profiling():
            closes, opens = POINTS[point]
            if point == "window.start":   # ranges a failed window left
                closes = tuple(self._ranges)
            for name in closes:
                rf = self._ranges.pop(name, None)
                if rf is not None:
                    rf.__exit__(None, None, None)
            if profiling():
                for name in opens:
                    self._ranges[name] = _enter_range(name)

    # -- a window's replay ---------------------------------------------
    def replay(self, launch, marks: Optional[Marks], window: int,
               steps: int) -> None:
        """`launch()` (a graph's replay) as window `window` of `steps`
        steps: the host span ``window.replay`` around it; then, while the
        card runs it, the reading of the earlier replays that have landed
        and the bookkeeping of this one's row of `marks` (None: no
        stamps)."""
        profiled = profiling()
        rf = _enter_range("window.replay") if profiled else None
        t0 = time.perf_counter_ns()
        launch()
        t1 = time.perf_counter_ns()
        if rf is not None:
            rf.__exit__(None, None, None)
        stack = self._stack()
        self.add("window.replay", "host", t0 / 1e6, t1 / 1e6,
                 stack[-1] if stack else None, window, steps, profiled)
        self.resolve()
        if marks is None or "window.end" not in marks.recorded:
            self._last = None
            return
        marks.replays += 1
        entry = self._last = _Replay(window, steps, profiled, marks,
                                     marks.replays, self._last)
        row = entry.n % MARK_ROWS
        lost = marks.owners[row]
        if lost is not None:         # this replay writes over its row
            lost.marks = None
            self.count("spans.device_unread")
        marks.owners[row] = entry
        self._pending.append(entry)

    def resolve(self) -> None:
        """Read every replay whose row has landed (one stream: they land
        in order)."""
        while self._pending:
            entry = self._pending[0]
            marks = entry.marks
            row = None if marks is None else marks.landed(entry)
            if marks is not None and row is None:
                return
            self._pending.pop(0)
            after, entry.after = entry.after, None   # read in order
            if row is None:           # written over unread
                continue
            marks.owners[entry.n % MARK_ROWS] = None
            origin = row[marks.slot["window.start"]]
            entry.end = row[marks.slot["window.end"]]
            at = {p: (row[marks.slot[p]] - origin) / 1e6
                  for p in marks.recorded}
            args = (entry.window, entry.steps, entry.profiled)
            if after is not None and after.end is not None:
                self.add("window.launch_wait", "device",
                         (after.end - origin) / 1e6, 0.0, None, *args)
            for name, a, b, parent in DEVICE_SPANS:
                if a in at and b in at:
                    self.add(name, "device", at[a], at[b], parent, *args)

    # -- reading --------------------------------------------------------
    def latest_ms(self, name: str, window: int) -> Optional[float]:
        """The newest sample of `name` in window `window`, in ms; None
        without one."""
        self.resolve()
        with self._lock:
            for start, end, _, at, _, _ in reversed(
                    self.samples.get(name, ())):
                if at == window:
                    return end - start
        return None

    def snapshot(self) -> Dict:
        """Every name's samples (``start``, ``end`` and ``ms``; host spans
        on the host clock, device spans in ms from their window's first
        stamp) with their ``parent``, ``window``, ``steps`` and
        ``profiled``, and every counter, :data:`LAUNCHES` included."""
        self.resolve()
        keys = ("start", "end", "parent", "window", "steps", "profiled")
        with self._lock:
            spans = {name: {"clock": self.clocks[name], "samples": [
                dict(zip(keys, s), ms=s[1] - s[0]) for s in ring]}
                for name, ring in self.samples.items()}
        return {"spans": spans, "counters": self.read_counters()}


def _enter_range(name: str):
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


REGISTRY = Registry()


def span(name: str):
    return REGISTRY.span(name)


def mark(point: str, last: bool = True) -> None:
    REGISTRY.mark(point, last)


def marking():
    return REGISTRY.marking()


def in_window(window: int, steps: int):
    return REGISTRY.in_window(window, steps)


def replay(launch, marks: Optional[Marks], window: int, steps: int) -> None:
    REGISTRY.replay(launch, marks, window, steps)


def count(name: str, n: int = 1) -> None:
    REGISTRY.count(name, n)


def counters() -> Dict[str, int]:
    return REGISTRY.read_counters()


def set_counters(values: Dict[str, int]) -> None:
    REGISTRY.set_counters(values)


def snapshot() -> Dict:
    return REGISTRY.snapshot()


def latest_ms(name: str, window: int) -> Optional[float]:
    return REGISTRY.latest_ms(name, window)


def reset() -> None:
    """Drop every sample, pending replay and counter, the kernels' launch
    counts included (for tests)."""
    REGISTRY.clear()
