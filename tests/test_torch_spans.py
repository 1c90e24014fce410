"""The port's spans and counters (``utils/spans.py``).

On the CPU: the registry's ring, parents and window ids, the launch
counters in its snapshot, no ``record_function`` without a profiler, the
window's ranges under the CPU profiler for a DNN and for SetRank, the
``spans.json`` that ``--profile_steps`` writes, the reading of replays'
rows (written here by the test in the card's stead), and a window run
where the stamp kernel cannot be built. On the card (``gpu``): the seven
stamp nodes of a captured window, its phases against its device time,
the wait between two windows, a pipelined replay that loses its stamps,
the launch counters, a window with the stamps bit for bit the window
without them and the window whose stamp library failed, and the CLI's
rate after a checkpoint save.

The file imports nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py -q
"""

import json
import os
import re
import statistics
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
from ultra_pytorch_tpu_torch.run import __main__ as cli
from ultra_pytorch_tpu_torch.run import window
from ultra_pytorch_tpu_torch.run.experiment import Experiment
from ultra_pytorch_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLICK_JSON = os.path.join(REPO, "example", "ClickModel",
                          "pbm_0.1_1.0_4_1.0.json")
F, L, B, STEPS = 16, 5, 16, 6
SETRANK = "d_model=16,num_heads=2,num_layers=1,diff=8"
PHASES = ("step.forward", "step.backward", "step.update")
ONLINE_PHASES = ("step.forward", "step.candidates", "step.multileave",
                 "step.update")
# The stamp nodes of a captured window, in the order the window marks
# them: an offline one's seven (as before the online points), an online
# one's eight.
STAMPED = {
    "DLA": ["window.start", "window.plan", "step.start", "step.forward",
            "step.backward", "step.update", "window.end"],
    "MGD": ["window.start", "window.plan", "step.start", "step.feed",
            "step.candidates", "step.multileave", "step.update",
            "window.end"],
}


@pytest.fixture(autouse=True)
def _fresh_registry():
    spans.reset()
    yield
    spans.reset()


def _data(num_queries, seed):
    rng = np.random.default_rng(seed)
    d = num_queries * L
    labels = rng.integers(0, 3, size=(num_queries, L)).astype(np.float32)
    labels[:, 0] = np.maximum(labels[:, 0], 1.0)
    return RankingDataset(
        features=rng.normal(size=(d, F)).astype(np.float32),
        initial_list=np.arange(d, dtype=np.int64).reshape(num_queries, L),
        labels=labels, qids=[str(i) for i in range(num_queries)],
        dids=[f"d{i}" for i in range(d)], feature_size=F, rank_list_size=L,
        max_label=2.0)


def _experiment(dev, tmp_path, ranker="DNN", kernels=False):
    hparams = {"DNN": "hidden_layer_sizes=[32, 16]", "SetRank": SETRANK}
    settings = {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={CLICK_JSON}"
                               + (",use_pallas_click=true" if kernels
                                  else ""),
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": ranker,
        "ranking_model_hparams": hparams[ranker]
                                 + (",use_pallas=true" if kernels else ""),
        "learning_algorithm": "DLA",
        "learning_algorithm_hparams":
            "loss_func=fused_softmax_loss" if kernels else "",
        "metrics": ["ndcg"], "metrics_topn": [3, 5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": L,
    }
    exp = Experiment(settings, "unused", str(tmp_path), batch_size=B,
                     device=dev)
    exp.setup(datasets={"train": _data(64, 0), "valid": _data(40, 1)})
    exp.init_state()
    return exp


def _online_experiment(dev, tmp_path, kernels=False):
    """MGD over the stochastic online feed, scoring whole lists of L."""
    settings = {
        "train_input_feed": "StochasticOnlineSimulationFeed",
        "train_input_hparams": f"click_model_json={CLICK_JSON}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": "DNN",
        "ranking_model_hparams": "hidden_layer_sizes=[32, 16]"
                                 + (",use_pallas=true" if kernels else ""),
        "learning_algorithm": "MGD",
        "learning_algorithm_hparams": f"click_model_json={CLICK_JSON}",
        "metrics": ["ndcg"], "metrics_topn": [3, 5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 3,
    }
    exp = Experiment(settings, "unused", str(tmp_path), batch_size=B,
                     device=dev)
    exp.setup(datasets={"train": _data(64, 0), "valid": _data(40, 1)})
    exp.init_state()
    return exp


def _samples(name):
    return spans.snapshot()["spans"].get(name, {"samples": []})["samples"]


class _CountingRange:
    """Stands in for ``torch.profiler.record_function``: counts entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _CountingRange.entered += 1
        return self

    def __exit__(self, *exc):
        return False


# -- the registry on the CPU ----------------------------------------------

def test_the_ring_keeps_the_last_samples_of_each_name():
    for i in range(spans.RING + 10):
        spans.REGISTRY.add("a", "host", float(i), i + 0.5, None)
    with spans.span("b"):
        pass
    got = spans.snapshot()["spans"]
    starts = [s["start"] for s in got["a"]["samples"]]
    assert starts == [float(i) for i in range(10, spans.RING + 10)]
    assert got["a"]["samples"][0]["ms"] == 0.5
    assert len(got["b"]["samples"]) == 1 and got["b"]["clock"] == "host"


def test_parents_and_window_ids():
    with spans.span("outer"):
        with spans.in_window(42, 7):
            with spans.span("capture.window.7"):
                with spans.span("capture.warmup"):
                    pass
    got = {name: v["samples"] for name, v in spans.snapshot()["spans"]
           .items()}
    (outer,), (cap,), (warm,) = (got["outer"], got["capture.window.7"],
                                 got["capture.warmup"])
    assert outer["parent"] is None and outer["window"] is None
    assert cap["parent"] == "outer" and warm["parent"] == "capture.window.7"
    assert (cap["window"], cap["steps"]) == (42, 7)
    assert (warm["window"], warm["steps"]) == (42, 7)
    assert warm["start"] >= cap["start"] and warm["end"] <= cap["end"]
    assert not warm["profiled"]


def test_snapshot_holds_the_launch_counters():
    for name, n in zip(spans.KERNEL_LAUNCHES, [3, 1, 4, 1, 5]):
        spans.count(name, n)
    spans.count("launches.K1_saved", 2)
    spans.REGISTRY.count("spans.device_unread", 2)
    counters = spans.snapshot()["counters"]
    assert [counters[f"launches.K{i}"] for i in range(1, 6)] == \
        window.read_launches() == [3, 1, 4, 1, 5]
    assert counters["launches.K1_saved"] == 2
    assert counters["launches.K1_wgmma"] == 0
    assert counters["spans.device_unread"] == 2


def test_snapshot_holds_the_wgmma_launches():
    """``launches.K1_wgmma`` beside ``launches.K1_saved``: K1's launches
    through its wgmma instance, in the same table."""
    spans.count("launches.K1_saved")
    spans.count("launches.K1_wgmma", 300)
    counters = spans.snapshot()["counters"]
    assert counters["launches.K1_wgmma"] == 300
    assert counters["launches.K1_saved"] == 1


def test_a_snapshot_loads_no_run_module():
    """``utils/spans.py`` sits below the run layer: a snapshot in a fresh
    interpreter imports nothing of ``ultra_pytorch_tpu_torch.run`` and
    reports the seven launch counters at 0."""
    code = ("import json, sys\n"
            "from ultra_pytorch_tpu_torch.utils import spans\n"
            "counters = spans.snapshot()['counters']\n"
            "run = [m for m in sys.modules\n"
            "       if m.startswith('ultra_pytorch_tpu_torch.run')]\n"
            "print(json.dumps([counters, run]))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    counters, run = json.loads(done.stdout.splitlines()[-1])
    assert run == []
    assert counters == dict.fromkeys(
        ["launches.K1", "launches.K2", "launches.K3", "launches.K4",
         "launches.K5", "launches.K1_saved", "launches.K1_wgmma"], 0)


def test_no_range_without_a_profiler(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    _CountingRange.entered = 0
    exp = _experiment("cpu", tmp_path)
    exp.train_steps(3)
    with spans.span("host"):
        pass
    assert _CountingRange.entered == 0
    # The same calls under a profiler do enter ranges.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        exp.train_steps(3)
        with spans.span("host"):
            pass
    assert _CountingRange.entered == 2 + 3 * 3 + 1


@pytest.mark.parametrize("ranker", ["DNN", "SetRank"])
def test_the_window_ranges_under_the_cpu_profiler(tmp_path, ranker):
    exp = _experiment("cpu", tmp_path, ranker)
    exp.train_steps(1)   # first-call set-up outside the trace
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        exp.train_steps(STEPS)
    ranges = {}
    for e in prof.events():
        if e.name in ("window", "window.plan") + PHASES:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    (win,), (plan,) = ranges["window"], ranges["window.plan"]
    assert win[0] <= plan[0] and plan[1] <= win[1]
    steps = list(zip(*(sorted(ranges[p]) for p in PHASES)))
    assert len(steps) == STEPS
    last = plan[1]
    for fwd, bwd, upd in steps:
        assert last <= fwd[0] <= fwd[1] <= bwd[0] <= bwd[1] <= upd[0] \
            <= upd[1] <= win[1]
        last = upd[1]
    assert not spans.REGISTRY._ranges   # every range closed


def test_profile_steps_writes_spans_json(tmp_path):
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={CLICK_JSON}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": "DNN", "ranking_model_hparams":
            "hidden_layer_sizes=[16]",
        "learning_algorithm": "DLA", "learning_algorithm_hparams": "",
        "metrics": ["ndcg"], "metrics_topn": [5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 5}))
    model = tmp_path / "model"
    cli.main(["--data_dir", os.path.join(REPO, "tests", "data") + "/",
              "--setting_file", str(settings), "--model_dir", str(model),
              "--batch_size", "8", "--device", "cpu", "--profile_steps", "2",
              "--max_train_iteration", "4", "--steps_per_checkpoint", "2"])
    got = json.loads((model / "profile" / "spans.json").read_text())
    assert set(got) == {"spans", "counters"}
    assert [f"launches.K{i}" in got["counters"] for i in range(1, 6)] == \
        [True] * 5
    trace = json.loads((model / "profile" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"window", "window.plan"} | set(PHASES) <= names


def _host_marks(recorded=tuple(spans.POINTS)):
    """A :class:`spans.Marks` whose rows this test writes in the card's
    stead, the points `recorded` (every point by default) recorded."""
    marks = object.__new__(spans.Marks)
    marks.slot = {p: i for i, p in enumerate(spans.POINTS)}
    marks.ns = np.zeros((spans.MARK_ROWS, len(spans.POINTS) + 1), np.int64)
    marks.recorded = list(recorded)
    marks.replays = 0
    marks.owners = [None] * spans.MARK_ROWS
    return marks


def _land(marks, n, start_ns):
    """Replay `n`'s stamps as the card writes them: 1 µs apart from
    `start_ns`, then its number."""
    row = marks.ns[n % spans.MARK_ROWS]
    for i in range(len(spans.POINTS)):
        row[i] = start_ns + 1000 * i
    row[-1] = n


def test_replays_are_read_in_order_and_a_lost_row_is_counted():
    marks = _host_marks()
    for i in range(spans.MARK_ROWS + 1):   # the last writes over the first
        spans.replay(lambda: None, marks, 10 * i, 10)
    counters = spans.snapshot()["counters"]
    assert counters["spans.device_unread"] == 1
    assert not _samples("window.device")   # nothing has landed
    # The second's row holds its start and the row's previous end: unread.
    marks.ns[2, marks.slot["window.start"]] = 2_000_000
    marks.ns[2, marks.slot["window.end"]] = 1_000
    marks.ns[2, -1] = 2
    assert not _samples("window.device")
    for n in range(2, spans.MARK_ROWS + 2):
        _land(marks, n, 1_000_000 * n)
    got = [(s["window"], s["ms"]) for s in _samples("window.device")]
    assert got == [(10 * i, 0.006) for i in range(1, spans.MARK_ROWS + 1)]
    assert [s["ms"] for s in _samples("step.backward")] == [0.001] * 4
    # The wait runs from the previous window's end, where it was read.
    waits = [(s["window"], s["ms"]) for s in _samples("window.launch_wait")]
    assert waits == [(10 * i, 0.994) for i in range(2, spans.MARK_ROWS + 1)]
    assert marks.owners == [None] * spans.MARK_ROWS
    assert not spans.REGISTRY._pending


def test_a_window_runs_without_the_stamp_library(monkeypatch, tmp_path):
    """Where the stamp kernel cannot be built or loaded (no nvcc, a card
    its build does not run on) a window graph is captured and replayed as
    before, with its host spans and no device span; the library is tried
    once, with one warning. The capture stands in for CUDA's here."""
    tried = []

    def broken():
        tried.append(1)
        raise RuntimeError("nvcc not found")

    class _Graph:
        """Replays `fn` as a graph does: the host's step stays."""

        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            step = exp.state.step
            self.fn()
            exp.state.step = step

    def captured(fn, generators=(), restore=None, pool=None, name=""):
        out = fn()
        restore()
        return window.Replayable(_Graph(fn), {}), out

    monkeypatch.setattr(spans, "_library", broken)
    monkeypatch.setattr(window, "capture", captured)
    exp = _experiment("cpu", tmp_path)
    graphs = window.WindowGraphs(exp.algorithm, exp.feeds["train"],
                                 exp.state, exp._generator)
    with pytest.warns(UserWarning, match="no device spans"):
        keys, means = graphs.run(1, STEPS)
    graphs.run(2, STEPS)
    graphs.run(3, 2)
    assert tried == [1] and "nvcc not found" in spans.REGISTRY.stamps_off
    assert graphs.marks == {STEPS: None, 2: None}
    assert exp.state.step == 2 * STEPS + 2
    assert "loss" in keys and bool(torch.isfinite(means).all())
    assert [s["window"] for s in _samples("window.replay")] == [
        0, STEPS, 2 * STEPS]
    assert not any(spans.snapshot()["spans"].get(name) for name in
                   ("window.device", "window.launch_wait"))


class _RecordingMarks:
    """Stands in for a capture's :class:`spans.Marks`: launches nothing;
    ``mark`` records the points it stamps."""

    def __init__(self):
        self.recorded = []

    def stamp(self, point, stream):
        pass


@pytest.mark.parametrize("algorithm", sorted(STAMPED))
def test_a_window_stamps_its_last_step_alone(monkeypatch, tmp_path,
                                             algorithm):
    """The stamp nodes a window's capture records, the capture standing
    in for CUDA's: the edges, the plan's end and the last step's points
    alone; an offline window's seven as before the online points, an
    online window's eight."""
    exp = (_experiment if algorithm == "DLA" else _online_experiment)(
        "cpu", tmp_path)
    exp.train_steps(1)
    marks = _RecordingMarks()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0}))
    spans.REGISTRY.marks, spans.REGISTRY.sampled = marks, False
    exp.train_steps_device(STEPS)
    assert marks.recorded == STAMPED[algorithm]


def test_an_online_row_gives_the_online_phases():
    """An online window's row: step.feed from step.start, then
    step.candidates and step.multileave, and step.update closing after
    step.multileave; no step.forward or step.backward."""
    marks = _host_marks(STAMPED["MGD"])
    spans.replay(lambda: None, marks, 0, STEPS)
    at_us = dict(zip(STAMPED["MGD"], (0, 100, 300, 1300, 4300, 4800, 4900,
                                      5000)))
    row = marks.ns[1]
    for point, us in at_us.items():
        row[marks.slot[point]] = 7_000_000 + 1000 * us
    row[-1] = 1
    got = {name: [s["ms"] for s in _samples(name)] for name in
           ("step.feed", "step.candidates", "step.multileave",
            "step.update", "window.device", "step.forward",
            "step.backward")}
    assert got == {"step.feed": [1.0], "step.candidates": [3.0],
                   "step.multileave": [0.5],
                   "step.update": [pytest.approx(0.1)],
                   "window.device": [5.0], "step.forward": [],
                   "step.backward": []}


def test_the_online_passes_are_counted_and_replayed(tmp_path):
    """The feed's pass and the rankers' (1 + ranker_num) a step, in an
    eager window; a replay adds what its capture counted."""
    exp = _online_experiment("cpu", tmp_path)
    exp.train_steps(STEPS)
    counters = spans.snapshot()["counters"]
    assert counters["online.feed_scored"] == STEPS
    assert counters["online.rankers_scored"] == 5 * STEPS
    graph = window.Replayable(type("Graph", (), {"replay": lambda s: None})(),
                              {"online.feed_scored": 50,
                               "online.rankers_scored": 250})
    graph.replay()
    graph.replay()
    counters = spans.snapshot()["counters"]
    assert counters["online.feed_scored"] == STEPS + 100
    assert counters["online.rankers_scored"] == 5 * STEPS + 500


def test_the_online_window_ranges_under_the_cpu_profiler(tmp_path):
    """Each online step's ranges in order: the feed's batch (under the
    name step.start opens, step.forward), the candidates, the
    multileave and the update."""
    exp = _online_experiment("cpu", tmp_path)
    exp.train_steps(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        exp.train_steps(STEPS)
    ranges = {}
    for e in prof.events():
        if e.name in ("window",) + ONLINE_PHASES:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    (win,) = ranges["window"]
    steps = list(zip(*(sorted(ranges[p]) for p in ONLINE_PHASES)))
    assert len(steps) == STEPS and "step.backward" not in ranges
    last = win[0]
    for phases in steps:
        for start, end in phases:
            assert last <= start <= end <= win[1]
            last = end
    assert not spans.REGISTRY._ranges


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs exist only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_replay_resolves_the_seven_stamp_nodes(cuda, tmp_path):
    exp = _experiment(cuda, tmp_path, kernels=True)
    exp.train_steps(STEPS)        # captured, then replayed once
    torch.cuda.synchronize()
    marks = exp._window_graphs.marks[STEPS]
    assert marks.recorded == STAMPED["DLA"]
    got = {name: _samples(name) for name, *_ in spans.DEVICE_SPANS
           if name not in spans.ONLINE_POINTS}
    for name, samples in got.items():
        assert len(samples) == 1, name
        assert (samples[0]["window"], samples[0]["steps"]) == (0, STEPS)
        assert samples[0]["ms"] >= 0.0
    ms = {name: samples[0]["ms"] for name, samples in got.items()}
    for name in ("window.plan",) + PHASES:
        assert ms[name] > 0.0, name
    assert ms["window.plan"] + STEPS * sum(ms[p] for p in PHASES) \
        <= ms["window.device"] * 1.05
    assert ms["window.plan"] + sum(ms[p] for p in PHASES) \
        <= ms["window.device"]
    (replay,) = _samples("window.replay")
    assert replay["window"] == 0 and replay["ms"] > 0.0
    assert not _samples("window.launch_wait")   # no window before it
    counters = spans.snapshot()["counters"]
    assert set(counters) == set(spans.LAUNCHES)
    assert [counters[k] for k in spans.KERNEL_LAUNCHES] == \
        window.read_launches()
    assert len(_samples(f"capture.window.{STEPS}")) == 1
    for part in ("warmup", "restore", "generators", "record", "sync",
                 "trace", "instantiate"):
        assert len(_samples(f"capture.{part}")) == 1, part
    exp.train_steps(STEPS)        # a second replay: the wait between
    (wait,) = _samples("window.launch_wait")
    assert wait["window"] == STEPS and 0.0 < wait["ms"] < 1e3


@pytest.mark.gpu
def test_an_online_graph_stamps_and_replays_its_counts(cuda, tmp_path):
    """An MGD window's graph: its eight stamp nodes, the online phases
    within its device time, and the passes and K1 launches its capture
    counted added on every replay."""
    exp = _online_experiment(cuda, tmp_path, kernels=True)
    for _ in range(3):
        exp.train_steps(STEPS)
    torch.cuda.synchronize()
    marks = exp._window_graphs.marks[STEPS]
    assert marks.recorded == STAMPED["MGD"]
    ms = {name: [s["ms"] for s in _samples(name)] for name in
          ("step.feed", "step.candidates", "step.multileave",
           "step.update", "window.device")}
    assert all(len(v) == 3 and min(v) > 0 for v in ms.values()), ms
    assert sum(ms[p][0] for p in ("step.feed", "step.candidates",
                                  "step.multileave", "step.update")) \
        <= ms["window.device"][0]
    assert not _samples("step.backward")
    graph = exp._window_graphs.graphs[STEPS][0]
    # K1 a pass: the feed's and the five rankers' a step.
    assert graph.counts == {"launches.K1": 6 * STEPS,
                            "online.feed_scored": STEPS,
                            "online.rankers_scored": 5 * STEPS}
    counters = spans.snapshot()["counters"]
    assert counters["online.feed_scored"] == 3 * STEPS
    assert counters["online.rankers_scored"] == 15 * STEPS


@pytest.mark.gpu
def test_pipelined_replays_keep_their_stamps(cuda, tmp_path):
    """Replays launched while earlier ones still run: each keeps its row
    of the graph's stamps, but the row of a replay that MARK_ROWS later
    replays passed unread is lost, and counted."""
    exp = _experiment(cuda, tmp_path, kernels=True)
    exp.train_steps(STEPS)        # the capture and a first replay
    torch.cuda.synchronize()
    spans.reset()
    first = exp.state.step
    torch.cuda._sleep(500_000_000)   # the first window cannot end first
    for _ in range(spans.MARK_ROWS + 1):
        exp.train_steps_device(STEPS)
    torch.cuda.synchronize()
    counters = spans.snapshot()["counters"]
    windows = [first + i * STEPS for i in range(spans.MARK_ROWS + 1)]
    assert counters["spans.device_unread"] == 1
    assert [s["window"] for s in _samples("window.device")] == windows[1:]
    assert [s["window"] for s in _samples("window.launch_wait")] == \
        windows[2:]
    assert all(s["ms"] > 0 for s in _samples("step.backward"))


@pytest.mark.gpu
def test_the_launch_counters_read_as_before(cuda, tmp_path):
    exp = _experiment(cuda, tmp_path, kernels=True)
    before = window.read_launches()
    saved = spans.counters()["launches.K1_saved"]
    for _ in range(3):
        exp.train_steps(STEPS)
    graph = exp._window_graphs.graphs[STEPS][0]
    launches = [graph.counts.get(k, 0) for k in spans.KERNEL_LAUNCHES]
    assert launches == [STEPS, STEPS, 2 * STEPS, 2 * STEPS, 1]
    assert [a - b for a, b in zip(window.read_launches(), before)] == [
        3 * n for n in launches]
    counters = spans.snapshot()["counters"]
    assert [counters[f"launches.K{i}"] for i in range(1, 6)] == \
        window.read_launches()
    # Every K1 launch of a training step saves the residuals its K2 reads,
    # so none runs the wgmma instance.
    assert graph.counts["launches.K1_saved"] == STEPS
    assert "launches.K1_wgmma" not in graph.counts
    assert counters["launches.K1_saved"] - saved == 3 * STEPS
    assert counters["launches.K1_wgmma"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("ranker", ["DNN", "SetRank"])
def test_the_stamps_change_no_bit(cuda, tmp_path, monkeypatch, ranker):
    """Three runs: with the stamps, with no mark, and with the stamp
    library failing (no stamp at all, a warning)."""
    runs = []
    for variant in ("marked", "no mark", "no library"):
        if variant == "no mark":
            monkeypatch.setattr(spans, "mark", lambda *a, **k: None)
        if variant == "no library":
            monkeypatch.undo()
            spans.reset()
            monkeypatch.setattr(spans, "_library", _no_library)
        exp = _experiment(cuda, tmp_path, ranker, kernels=ranker == "DNN")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            metrics = [exp.train_steps(n) for n in (STEPS, STEPS, 4)]
        marks = exp._window_graphs.marks[STEPS]
        if variant == "no library":
            assert marks is None and not _samples("window.device")
            assert any("no device spans" in str(w.message) for w in caught)
        else:
            assert len(marks.recorded) == (7 if variant == "marked" else 0)
        runs.append((exp.algorithm.state_leaves(exp.state)
                     + [exp._data_key], metrics))
    ours, ours_metrics = runs[0]
    for bare, bare_metrics in runs[1:]:
        assert ours_metrics == bare_metrics
        for a, b in zip(ours, bare):
            np.testing.assert_array_equal(a, b)


def _no_library():
    raise RuntimeError("no stamp library")


@pytest.mark.gpu
def test_the_cli_rate_after_a_save(cuda, tmp_path, capsys):
    """The rate of a window read back after a checkpoint save is on the
    device's clock, so it is within 10% of the others (the host clock
    read it far higher: the window trained while the host saved)."""
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={CLICK_JSON}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": "DNN", "ranking_model_hparams":
            "hidden_layer_sizes=[64, 32]",
        "learning_algorithm": "DLA", "learning_algorithm_hparams": "",
        "metrics": ["ndcg"], "metrics_topn": [5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 5}))
    cli.main(["--data_dir", os.path.join(REPO, "tests", "data") + "/",
              "--setting_file", str(settings),
              "--model_dir", str(tmp_path / "model"), "--batch_size", "32",
              "--max_train_iteration", "600", "--steps_per_checkpoint",
              "25"])
    lines = capsys.readouterr().out.splitlines()
    rates, after_save = [], []
    for i, line in enumerate(lines):
        found = re.match(r"step \d+ loss \S+ \((\d+) queries/s\)", line)
        if found:
            rates.append(float(found.group(1)))
            # The window read back after the one this line's save follows.
            if i + 1 < len(lines) and "saved checkpoint" in lines[i + 1]:
                after_save.append(len(rates))
    after_save = [i for i in after_save if 1 <= i < len(rates)]
    assert len(rates) == 24 and after_save
    typical = statistics.median(rates[1:])
    for i in after_save:
        assert abs(rates[i] / typical - 1.0) <= 0.10, (i, rates)
