"""The online family's training windows as replayed CUDA graphs on the
card (``run/window.py``): a graph window equals the eager window bit for
bit for each of the six online configs, with the launch counters exact
through the replays; a replay across a dynamic-bias interval simulates
clicks at the step's eta; and a host read under capture raises.

These need a CUDA device and skip without one. The file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_online_window_gpu.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
from ultra_pytorch_tpu_torch.run.experiment import Experiment
from ultra_pytorch_tpu_torch.utils import spans

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("naive_online", "pdgd", "dbgd", "dbgd_ndcg", "mgd", "nsgd")
F, LC, L, B, STEPS = 16, 12, 5, 16, 6
# K1 launches a step: the feed's scoring of the whole list, then Naive's
# loss forward; PDGD's no-grad pass and loss forward; the DBGD family's
# current ranker and each of its R candidates.
K1_A_STEP = {"naive_online": 2, "pdgd": 3, "dbgd": 3, "dbgd_ndcg": 3,
             "mgd": 6, "nsgd": 6}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs exist only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(num_queries, seed):
    rng = np.random.default_rng(seed)
    d = num_queries * LC
    initial = np.arange(d, dtype=np.int64).reshape(num_queries, LC)
    labels = rng.integers(0, 5, size=(num_queries, LC)).astype(np.float32)
    initial[: num_queries // 4, 9:] = -1
    labels[: num_queries // 4, 9:] = 0.0
    return RankingDataset(
        features=rng.normal(size=(d, F)).astype(np.float32),
        initial_list=initial, labels=labels,
        qids=[str(i) for i in range(num_queries)],
        dids=[f"d{i}" for i in range(d)], feature_size=F,
        rank_list_size=LC, max_label=4.0)


def _settings(config, feed_hparams=""):
    """The config with the DNN at [32, 16] through K1/K2 and Naive's
    softmax through K3/K4."""
    with open(os.path.join(REPO, "configs", f"{config}.json")) as fin:
        settings = json.loads(fin.read().replace(
            "./example/", os.path.join(REPO, "example") + "/"))
    settings.update(ranking_model_hparams="hidden_layer_sizes=[32, 16],"
                    "use_pallas=true", metrics=["ndcg"], metrics_topn=[5],
                    objective_metric="ndcg_5", selection_bias_cutoff=L)
    if config == "naive_online":
        settings["learning_algorithm_hparams"] = (
            "loss_func=fused_softmax_loss,l2_loss=0.001")
    if feed_hparams:
        settings["train_input_hparams"] += "," + feed_hparams
    return settings


def _experiment(settings, dev, tmp_path):
    exp = Experiment(dict(settings), "unused", str(tmp_path), batch_size=B,
                     device=dev)
    exp.setup(datasets={"train": _data(64, 0), "valid": _data(40, 1)})
    exp.init_state()
    return exp


def _run(settings, dev, tmp_path, fuse, lengths):
    exp = _experiment(settings, dev, tmp_path)
    metrics = [exp.train_steps(n, fuse) for n in lengths]
    return exp, metrics, (exp.algorithm.state_leaves(exp.state)
                          + [exp._data_key])


@pytest.mark.parametrize("config", CONFIGS)
def test_graph_window_equals_the_eager_window(cuda, tmp_path, config):
    """Two windows of each length (a window and its tail): the state
    (NSGD's memory included), the data key and the window metrics bit for
    bit, and each graph's launches those of its steps."""
    settings = _settings(config)
    lengths = (STEPS, STEPS, 4, 4)
    _, eager_metrics, eager = _run(settings, cuda, tmp_path, False, lengths)
    exp, graph_metrics, graph = _run(settings, cuda, tmp_path, True,
                                     lengths)
    assert exp.eager_reason() is None
    assert sorted(exp._window_graphs.graphs) == [4, STEPS]
    assert graph_metrics == eager_metrics
    assert len(graph) == len(eager)
    for a, b in zip(graph, eager):
        np.testing.assert_array_equal(a, b)
    backward = config in ("naive_online", "pdgd")
    softmax = config == "naive_online"
    for n, (held, _, _) in exp._window_graphs.graphs.items():
        assert [held.counts.get(k, 0) for k in spans.KERNEL_LAUNCHES] == [
            K1_A_STEP[config] * n, n if backward else 0,
            n if softmax else 0, n if softmax else 0, 0]


def test_a_replay_across_a_dynamic_bias_interval_follows_the_step(
        cuda, tmp_path):
    """Eta grows by 1.0 every 5 steps and windows are 4 steps, so each
    replay after the first crosses an interval: the graph run equals the
    eager run bit for bit (a replay that kept the captured step's eta
    would not), and differs from the run without the change."""
    lengths = (4, 4, 4)
    runs = {}
    for change, fuse in ((1.0, False), (1.0, True), (0.0, True)):
        settings = _settings("mgd", "dynamic_bias_eta_change="
                             f"{change},dynamic_bias_step_interval=5")
        _, metrics, leaves = _run(settings, cuda, tmp_path, fuse, lengths)
        runs[change, fuse] = (metrics, leaves)
    (eager_m, eager), (graph_m, graph) = runs[1.0, False], runs[1.0, True]
    assert graph_m == eager_m
    for a, b in zip(graph, eager):
        np.testing.assert_array_equal(a, b)
    still_m, _ = runs[0.0, True]
    assert still_m[0] == graph_m[0]     # steps 0-3: eta unchanged
    assert still_m[1:] != graph_m[1:]


def test_a_host_read_under_capture_raises(cuda, tmp_path):
    """An online feed that reads a value back to the host inside its step
    cannot be captured: the window raises and does not run eager."""
    exp = _experiment(_settings("nsgd"), cuda, tmp_path)
    feed = exp.feeds["train"]
    rank = feed._rank

    def reading(generator, scores, mask):
        float(scores.sum())      # a host read inside the step
        return rank(generator, scores, mask)

    feed._rank = reading
    with pytest.raises(RuntimeError):
        exp.train_steps(STEPS)
    torch.cuda.synchronize()
    assert exp.state.step == 0
