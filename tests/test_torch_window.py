"""The port's training window on the CPU: the state updated in place, the
window split into its plan and its steps, the pipelined CLI loop and the
launch counters of a replayed graph (``run/window.py``).

Small sizes throughout: the DNN at ``[16, 8]``, F = 8, B = 8, L = 5 and
toy data. The window's CUDA graph itself needs a card
(``tests/test_torch_window_gpu.py``); here every window runs eager, which
is the path a graph window is held to there.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu_torch.data.dataset import RankingDataset  # noqa
from ultra_pytorch_tpu_torch.run import __main__ as cli  # noqa: E402
from ultra_pytorch_tpu_torch.run import window  # noqa: E402
from ultra_pytorch_tpu_torch.run.experiment import (  # noqa: E402
    Experiment, create_algorithm)
from ultra_pytorch_tpu_torch.sim.click_models import (  # noqa: E402
    click_model_json_numpy)
from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt_lib  # noqa
from ultra_pytorch_tpu_torch.utils import spans  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLICK_JSON = os.path.join(REPO, "example", "ClickModel",
                          "pbm_0.1_1.0_4_1.0.json")
# The state after windows of 4 and 3 steps, written by the window code as
# it was before its state moved to in-place updates.
EXPECTED = os.path.join(REPO, "tests", "torch_window_expected.npz")
F, B, L = 8, 8, 5
TOL = 1e-4
ALGORITHMS = ("DLA", "NaiveAlgorithm", "RegressionEM", "PairDebias",
              "LambdaRank", "PRSrank")
# Adagrad's first step turns a gradient at float noise into a full step
# of either sign; l2_loss gives the shift-invariant losses' biases a real
# gradient. LambdaRank and PRS have no l2_loss: they take sgd.
WITH_L2 = ("DLA", "NaiveAlgorithm", "RegressionEM", "PairDebias")
# The windows' configs whose loss is shift-invariant take sgd: the
# gradient of the output bias and of the last LayerNorm's bias is float
# noise, which Adagrad turns into a full step of either sign even with
# l2_loss (it drives those biases to zero, where the noise leads again),
# and sgd into a step of the noise's size.
SHIFT_INVARIANT = ("DLA", "PairDebias")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def estimator_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("estimator") / "randomized_pbm.json"
    path.write_text(json.dumps({
        "IPW_list": [1.0, 1.11, 1.42, 2.0, 2.43],
        "click_model": click_model_json_numpy("pbm", 0.1, 1.0, 4, 1.0)}))
    return str(path)


def _algorithm_settings(algo, estimator_json):
    hp = ["grad_strategy=ada,l2_loss=0.001" if algo in WITH_L2
          else "grad_strategy=sgd"]
    if algo == "PRSrank":
        hp.append(f"propensity_estimator_json={estimator_json}")
    return {"ranking_model": "DNN",
            "ranking_model_hparams": "hidden_layer_sizes=[16, 8]",
            "learning_algorithm": algo,
            "learning_algorithm_hparams": ",".join(hp),
            "max_candidate_num": L, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        mask = np.ones((B, L), np.float32)
        mask[: B // 4, 3:] = 0.0
        clicks = (rng.random((B, L)) < 0.4).astype(np.float32) * mask
        clicks[:, 0] = 1.0
        out.append({
            "features": rng.normal(size=(B, L, F)).astype(np.float32),
            "labels": clicks, "mask": mask,
            "initial_scores": np.zeros((B, L), np.float32)})
    return out


def _perturbed_norms(params):
    """The LayerNorm affine away from ones/zeros, as after training."""
    rng = np.random.default_rng(1)
    layers = []
    for layer in params["layers"]:
        n = layer["norm"]["scale"].shape[0]
        layers.append({"linear": layer["linear"], "norm": {
            "scale": (1 + 0.2 * rng.normal(size=n)).astype(np.float32),
            "bias": (0.2 * rng.normal(size=n)).astype(np.float32)}})
    return {"layers": layers}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_steps_in_place_match_jax(estimator_json, algo):
    """One and three steps equal the JAX package's to 1e-4, the ranker,
    the flat optimizer state and the aux state included, and every state
    tensor is the one it was before the steps (updated in place)."""
    settings = _algorithm_settings(algo, estimator_json)
    jalg = jax_create_algorithm(settings, F, 1.0)
    jstate = jalg.init_state(jax.random.PRNGKey(0), F)
    jstate = jstate.replace(params=_perturbed_norms(jstate.params))
    alg = create_algorithm(settings, F, 1.0, device="cpu")
    state = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(0)), _leaves(jstate))
    ptrs = [t.data_ptr() for t in alg.state_tensors(state)]
    jstep = jax.jit(jalg.train_step)
    for i, batch in enumerate(_batches(3)):
        rng = jax.random.PRNGKey(100 + i)
        jstate, jmetrics = jstep(jstate, batch, rng)
        torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        if algo == "RegressionEM":   # JAX's own uniforms of the step
            u = torch.from_numpy(np.array(jax.random.uniform(rng, (B, L))))
            state, metrics = alg.step_with_uniforms(state, torch_batch, u)
        else:
            state, metrics = alg.train_step(state, torch_batch)
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(jmetrics["loss"]), rtol=TOL,
                                   atol=TOL)
        if i in (0, 2):
            got, want = alg.state_leaves(state), _leaves(jstate)
            assert [np.shape(a) for a in got] == [np.shape(b) for b in want]
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert state.step == 3
    assert [t.data_ptr() for t in alg.state_tensors(state)] == ptrs


def _dataset(num_queries, seed):
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


def _window_settings(algo):
    """Every kernel hparam on (their plain versions on the CPU)."""
    return {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={CLICK_JSON},"
                               "use_pallas_click=true",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": "DNN",
        "ranking_model_hparams": "hidden_layer_sizes=[16, 8],use_pallas=true",
        "learning_algorithm": algo,
        "learning_algorithm_hparams": ",".join(
            (["loss_func=fused_softmax_loss"] if algo == "DLA" else [])
            + (["grad_strategy=sgd"] if algo in SHIFT_INVARIANT else [])),
        "metrics": ["ndcg"], "metrics_topn": [3, 5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": L,
    }


def _experiment(algo, tmp_path, valid_queries=20):
    exp = Experiment(_window_settings(algo), "unused", str(tmp_path),
                     batch_size=B, seed=3, device="cpu")
    exp.setup(datasets={"train": _dataset(48, 0),
                        "valid": _dataset(valid_queries, 1)})
    exp.init_state()
    return exp


@pytest.mark.parametrize("algo", ["DLA", "RegressionEM", "PairDebias"])
def test_windows_give_the_state_before_the_in_place_refactor(tmp_path,
                                                             algo):
    """``train_steps`` over a window of 4 steps and its tail of 3 gives
    the metrics, state and data key that the window code wrote before the
    state moved to in-place updates (saved in EXPECTED)."""
    exp = _experiment(algo, tmp_path)
    metrics = [exp.train_steps(4), exp.train_steps(3)]
    leaves = exp.algorithm.state_leaves(exp.state) + [exp._data_key]
    with np.load(EXPECTED) as want:
        names = list(want[f"{algo}/metric_names"])
        assert names == sorted(metrics[0])
        np.testing.assert_allclose(
            [[m[k] for k in names] for m in metrics], want[f"{algo}/metrics"],
            rtol=1e-5, atol=1e-7)
        stored = sorted(k for k in want.files
                        if k.startswith(f"{algo}/leaf_"))
        assert len(stored) == len(leaves)
        for key, leaf in zip(stored, leaves):
            np.testing.assert_allclose(leaf, want[key], rtol=1e-5,
                                       atol=1e-7)


@pytest.fixture
def toy_cli(toy_data_dir, click_model_json, tmp_path):
    """The CLI on the toy data with DLA and every kernel hparam on: 25
    steps in windows of 10 (an uneven tail); returns the metric log."""
    settings = _window_settings("DLA")
    settings["train_input_hparams"] = (f"click_model_json={click_model_json}"
                                       ",use_pallas_click=true")
    setting_file = tmp_path / "settings.json"
    setting_file.write_text(json.dumps(settings))

    def run(model_dir, extra=()):
        cli.main(["--device", "cpu", "--data_dir", toy_data_dir,
                  "--setting_file", str(setting_file), "--model_dir",
                  str(model_dir), "--batch_size", str(B),
                  "--max_train_iteration", "25", "--steps_per_checkpoint",
                  "10", "--seed", "7"] + list(extra))
        with open(model_dir / "logs" / "metrics.jsonl") as fin:
            return [json.loads(line) for line in fin]

    return run


def _logged(entries):
    """(split, step, key) -> value, without the wall-clock keys."""
    return {(e["split"], e["step"], k): v for e in entries
            for k, v in e.items()
            if k not in ("split", "step", "time", "queries_per_sec")}


def test_pipelined_and_sync_readback_agree(toy_cli, tmp_path, capsys):
    """The one-window-deep pipelined loop and ``--sync_readback`` log the
    same per-window metrics (an uneven tail window included), print the
    same lines and save the same checkpoint."""
    logs, lines, ckpts = {}, {}, {}
    for mode, extra in (("pipelined", []), ("sync", ["--sync_readback"])):
        model_dir = tmp_path / mode
        logs[mode] = _logged(toy_cli(model_dir, extra))
        lines[mode] = [line.split(" (")[0] + line.split(")", 1)[-1]
                       for line in capsys.readouterr().out.splitlines()
                       if line.startswith(("step ", "  saved"))]
        with np.load(model_dir / "DLA.ckpt.npz") as arrays:
            ckpts[mode] = {k: arrays[k] for k in arrays.files}
    assert {k[1] for k in logs["sync"]} == {10, 20, 25}
    assert logs["pipelined"] == logs["sync"]
    assert lines["pipelined"] == lines["sync"] and len(lines["sync"]) >= 3
    assert ckpts["pipelined"].keys() == ckpts["sync"].keys()
    for k, v in ckpts["sync"].items():
        np.testing.assert_array_equal(ckpts["pipelined"][k], v)


def test_a_diverged_window_is_never_flushed(toy_cli, tmp_path, monkeypatch,
                                            capsys):
    """Window 2's loss goes nan: the pipelined loop has already dispatched
    window 3, never reads it back, and keeps window 1's checkpoint."""
    real = Experiment.train_steps_device
    calls = []

    def diverging(self, num_steps, fuse_window=True):
        keys, means = real(self, num_steps, fuse_window)
        calls.append(num_steps)
        if len(calls) == 2:
            means = means.clone()
            means[keys.index("loss")] = float("nan")
        return keys, means

    monkeypatch.setattr(Experiment, "train_steps_device", diverging)
    model_dir = tmp_path / "model"
    logged = toy_cli(model_dir)
    out = capsys.readouterr().out
    assert len(calls) == 3                      # window 3 was dispatched
    assert sorted({e["step"] for e in logged}) == [10, 20]
    assert "Divergence detected" in out
    assert not any(line.startswith("step 25") for line in out.splitlines())
    meta = ckpt_lib.read_metadata(str(model_dir / "DLA.ckpt"))
    assert meta["step"] == 10


def test_snapshot_saves_the_state_it_was_taken_at(tmp_path):
    """A checkpoint saved from a snapshot after a further window holds the
    snapshot's state, step and data key, not the live ones."""
    exp = _experiment("PairDebias", tmp_path)
    exp.train_steps(3)
    want = exp.algorithm.state_leaves(exp.state) + [exp._data_key.copy()]
    snap = exp.snapshot_state()
    exp.train_steps(2)
    exp.save({"step": 3}, state_and_rng=snap)
    fresh = _experiment("PairDebias", tmp_path)
    assert fresh.restore()
    got = fresh.algorithm.state_leaves(fresh.state) + [fresh._data_key]
    assert fresh.state.step == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_validate_device_is_the_count_weighted_merge(tmp_path):
    """``validate_device`` (one device vector) read by ``validate``, and
    the batches' summaries merged by their query counts here, with the
    tie-break generator seeded from (seed, step): 20 queries are two full
    batches of 8 and a tail of 4."""
    exp = _experiment("DLA", tmp_path)
    exp.train_steps(2)
    keys, vector = exp.validate_device("valid")
    assert vector.shape == (len(keys),) and keys == sorted(keys)
    data, q = exp.device_data["valid"], 20
    gen = exp._eval_generator()
    want = np.zeros(len(keys))
    for start in range(0, q, B):
        count = min(B, q - start)
        _, summary = exp.algorithm.validation_metrics(
            exp.state, data.gather(torch.arange(start, start + count)),
            generator=gen)
        want += np.array([summary[k].item() for k in keys]) * count / q
    np.testing.assert_allclose(vector.numpy(), want, rtol=1e-6, atol=1e-7)
    assert exp.validate("valid") == dict(zip(keys, vector.tolist()))


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("name,counts", [
    ("launches.K1", {f"launches.K{i}": i for i in range(1, 6)}),
    ("launches.K1_saved", {"launches.K1": 2, "launches.K2": 2,
                           "launches.K3": 4, "launches.K4": 4,
                           "launches.K5": 1, "launches.K1_saved": 2}),
    ("launches.K1_wgmma", {"launches.K1": 6, "launches.K1_wgmma": 6}),
])
def test_replays_add_the_captured_launches(name, counts):
    """The counters count a captured launch once, at capture: each replay
    adds the capture's counts, so three replays add three times them to
    the spans' registry and to ``Replayable.replayed``, and nothing
    else."""
    before = spans.counters()
    replayed = dict(window.Replayable.replayed)
    try:
        graph = window.Replayable(_FakeGraph(), counts)
        for _ in range(3):
            graph.replay()
        assert graph.graph.replays == 3
        assert {k: n - before.get(k, 0) for k, n in spans.counters().items()
                if n != before.get(k, 0)} == {
            k: 3 * n for k, n in counts.items()}
        assert [a - before[k] for k, a in zip(
            spans.KERNEL_LAUNCHES, window.read_launches())] == [
            3 * counts.get(k, 0) for k in spans.KERNEL_LAUNCHES]
        assert window.Replayable.replayed[name] - replayed.get(name, 0) \
            == 3 * counts[name]
        assert window.Replayable(_FakeGraph(), {}).counts == {}
    finally:
        spans.set_counters(before)
        window.Replayable.replayed.clear()
        window.Replayable.replayed.update(replayed)


@pytest.mark.parametrize("name", ["launches.K1", "launches.K1_saved",
                                  "launches.K1_wgmma",
                                  "online.rankers_scored"])
def test_capture_counts_the_wgmma_launches_once(name):
    """A capture ends with the counters as they began and hands what it
    counted (the warm-up's taken off) to its Replayable."""
    before = spans.counters()

    def fn():
        spans.count(name, 2)

    class _Stream:
        def wait_stream(self, other):
            pass

    import contextlib
    from unittest import mock
    with mock.patch.object(torch.cuda, "current_stream", _Stream), \
            mock.patch.object(torch.cuda, "Stream", _Stream), \
            mock.patch.object(torch.cuda, "stream",
                              lambda s: contextlib.nullcontext()), \
            mock.patch.object(torch.cuda, "CUDAGraph", _FakeGraph), \
            mock.patch.object(torch.cuda, "graph",
                              lambda g, pool=None: contextlib.nullcontext()):
        graph, _ = window.capture(fn)
    assert graph.counts == {name: 2} and spans.counters() == before


def test_cpu_windows_run_eager_and_say_so(tmp_path, capsys):
    exp = _experiment("DLA", tmp_path)
    assert exp.eager_reason() == "CUDA graphs exist only on the card"
    exp.train_steps(2)
    exp.train_steps(2)
    out = capsys.readouterr().out
    assert out.count("Training windows: eager (CUDA graphs exist only on "
                     "the card)") == 1
    assert exp._window_graphs is None
    assert math.isfinite(exp.validate("valid")["ndcg_5"])
