"""The online family's training windows on the CPU: the online feed's step
as a device scalar, NSGD's null-space sampler made of fixed-count device
ops, the DBGD family's state written in place, and the six online configs'
windows held to the window code before those changes.

Small sizes throughout: the DNN at ``[16, 8]`` (every kernel hparam on,
their plain versions on the CPU), F = 8, B = 8, Lc = 12 candidates a
query (a quarter of the lists cut to 9), L = 5, and toy data. The graph
windows themselves need a card (``tests/test_torch_online_window_gpu.py``);
here every window runs eager, the path a graph window is held to there.

EXPECTED holds the metrics, state and data key after windows of 4 and 3
steps of each config, written by the parent tree's window code, where the
online feed read ``state.step`` on the host and the DBGD family rebound
its aux state. NSGD's entry was written by that code with this tree's
``null_space_sample`` patched in, since the sampler is the one deliberate
change of the step. Each array is held within TOL of its largest
magnitude: the same code gives other bits on a CPU with another vector
width or BLAS path (Adagrad divides each update by its gradient's
size, so float noise in a small gradient moves a weight), while what
the test guards against moves them by far more (the SVD sampler in
place of this one moves NSGD's state by 0.41).
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms need it
import jax.numpy as jnp  # noqa: E402

from ultra_pytorch_tpu.algorithms.nsgd import NSGD as JaxNSGD  # noqa: E402
from ultra_pytorch_tpu_torch.algorithms import nsgd  # noqa: E402
from ultra_pytorch_tpu_torch.algorithms.base import (  # noqa: E402
    train_window)
from ultra_pytorch_tpu_torch.data.dataset import RankingDataset  # noqa
from ultra_pytorch_tpu_torch.input_layer import feeds  # noqa: E402
from ultra_pytorch_tpu_torch.models.base import LayerNorm  # noqa: E402
from ultra_pytorch_tpu_torch.run import __main__ as cli  # noqa: E402
from ultra_pytorch_tpu_torch.run.experiment import Experiment  # noqa: E402
from ultra_pytorch_tpu_torch.utils.checkpoint import (  # noqa: E402
    tree_leaves)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = os.path.join(REPO, "tests", "torch_online_window_expected.npz")
CONFIGS = ("naive_online", "pdgd", "dbgd", "dbgd_ndcg", "mgd", "nsgd")
F, B, LC, L = 8, 8, 12, 5
R = 4   # MGD's and NSGD's perturbed rankers
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dataset(num_queries, seed):
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
    """``configs/<config>.json`` with absolute click-model paths, the DNN
    at [16, 8] with K1/K2 selected, and Naive's softmax through K3/K4.
    The two gradient configs carry an l2 term of 0.01-0.05: their
    losses are shift-invariant, so the gradient of the output bias and of
    the last LayerNorm's bias would be float noise that Adagrad turns into
    a full step of either sign."""
    with open(os.path.join(REPO, "configs", f"{config}.json")) as fin:
        settings = json.loads(fin.read().replace(
            "./example/", os.path.join(REPO, "example") + "/"))
    settings.update(ranking_model_hparams="hidden_layer_sizes=[16, 8],"
                    "use_pallas=true", metrics=["ndcg"], metrics_topn=[5],
                    objective_metric="ndcg_5", selection_bias_cutoff=L)
    if config == "naive_online":
        settings["learning_algorithm_hparams"] = (
            "loss_func=fused_softmax_loss,l2_loss=0.01")
    if config == "pdgd":
        settings["learning_algorithm_hparams"] = "l2_loss=0.05"
    if feed_hparams:
        settings["train_input_hparams"] += "," + feed_hparams
    return settings


def _experiment(config, tmp_path, feed_hparams=""):
    """The config's experiment on the toy data, its LayerNorm affine moved
    away from ones and zeros (as after training), so that l2 gives the
    last LayerNorm's bias a real gradient too."""
    exp = Experiment(_settings(config, feed_hparams), "unused",
                     str(tmp_path), batch_size=B, seed=3, device="cpu")
    exp.setup(datasets={"train": _dataset(48, 0), "valid": _dataset(20, 1)})
    exp.init_state()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for norm in exp.state.params.modules():
            if isinstance(norm, LayerNorm):
                n = norm.weight.shape[0]
                norm.weight.copy_(torch.from_numpy(
                    (1 + 0.2 * rng.normal(size=n)).astype(np.float32)))
                norm.bias.copy_(torch.from_numpy(
                    (0.2 * rng.normal(size=n)).astype(np.float32)))
    return exp


def _windows(exp):
    """Windows of 4 and 3 steps: their metrics, then the state's leaves and
    the data key."""
    metrics = [exp.train_steps(4), exp.train_steps(3)]
    return metrics, exp.algorithm.state_leaves(exp.state) + [exp._data_key]


def _assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: off by {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("config", CONFIGS)
def test_windows_equal_the_parent_trees(tmp_path, config):
    """Each online config's windows give the parent tree's metrics, state
    (ranker, optimizer, NSGD's memory) and data key, and every state
    tensor is the one it was before (updated in place)."""
    exp = _experiment(config, tmp_path)
    ptrs = [t.data_ptr() for t in exp.algorithm.state_tensors(exp.state)]
    metrics, leaves = _windows(exp)
    assert [t.data_ptr()
            for t in exp.algorithm.state_tensors(exp.state)] == ptrs
    with np.load(EXPECTED) as want:
        names = list(want[f"{config}/metric_names"])
        assert names == sorted(metrics[0])
        for w, (m, row) in enumerate(zip(metrics, want[f"{config}/metrics"])):
            for k, value in zip(names, row):
                _assert_close(m[k], value, f"window {w} {k}")
        stored = sorted(k for k in want.files
                        if k.startswith(f"{config}/leaf_"))
        assert len(stored) == len(leaves)
        for key, leaf in zip(stored, leaves):
            _assert_close(leaf, want[key], key)


def _recorded_etas(monkeypatch):
    """Every eta the online feed's click sampling is given, in order."""
    etas = []
    real = feeds.cm.resampled_clicks

    def recording(model, *args):
        etas.append(model.eta.clone())
        return real(model, *args)

    monkeypatch.setattr(feeds.cm, "resampled_clicks", recording)
    return etas


@pytest.mark.parametrize("start", ["tensor", "int"])
def test_eta_follows_the_step_of_each_window_step(tmp_path, monkeypatch,
                                                  start):
    """Under ``dynamic_bias_eta_change`` the online feed's eta at step
    ``start + i`` follows the schedule (base + floor(step / interval) x
    change), whether the window's start is a 0-dim int64 tensor (a
    captured window's) or the state's int step."""
    exp = _experiment("naive_online", tmp_path,
                      "dynamic_bias_eta_change=0.5,"
                      "dynamic_bias_step_interval=3")
    etas = _recorded_etas(monkeypatch)
    exp.state.step = 4
    first = torch.tensor(4) if start == "tensor" else None
    train_window(exp.algorithm, exp.feeds["train"], exp.state,
                 torch.Generator().manual_seed(0), 5, start=first)
    base = float(exp.feeds["train"].click_model.eta)
    want = [base + ((4 + i) // 3) * 0.5 for i in range(5)]
    assert [float(e) for e in etas] == want
    assert all(e.dim() == 0 for e in etas)
    assert exp.state.step == 9


def test_a_device_step_gives_the_int_steps_batch(tmp_path):
    """``train_batch`` at a 0-dim tensor step draws the batch it draws at
    the same int step (and at ``state.step`` by default)."""
    exp = _experiment("mgd", tmp_path, "dynamic_bias_eta_change=0.3,"
                      "dynamic_bias_step_interval=2")
    feed, state = exp.feeds["train"], exp.state
    state.step = 5
    batches = [feed.train_batch(torch.Generator().manual_seed(1), state, s)
               for s in (torch.tensor(5), 5, None)]
    for other in batches[1:]:
        assert sorted(other) == sorted(batches[0])
        for k in other:
            assert torch.equal(other[k], batches[0][k]), k


# -- NSGD's null-space sampler --------------------------------------------

def _memory(rank, size, seed=0):
    """A ``[R, size]`` memory of rank `rank`: `rank` random unit rows,
    then zero rows (rankers that won) and exact multiples of the random
    rows, so that float32 leaves the rank unambiguous for the SVD."""
    rng = np.random.default_rng(seed + 10 * rank + size)
    rows = rng.normal(size=(R, size)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    for j in range(rank, R):
        rows[j] = 0.0 if j % 2 or not rank else -2.0 * rows[j % rank]
    return rows


def _span_dimension(vectors):
    s = np.linalg.svd(np.asarray(vectors, np.float64), compute_uv=False)
    return int((s > 1e-4 * max(s.max(initial=0.0), 1e-30)).sum())


def _jax_samples(bad, n):
    """`n` draws of JAX's ``_null_space_sample`` on the memory `bad`."""
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    return np.stack([np.asarray(JaxNSGD._null_space_sample(
        None, k, jnp.asarray(bad), 1.0)).reshape(-1) for k in keys])


@pytest.mark.parametrize("size", [64, 6], ids=["D64", "D6"])
@pytest.mark.parametrize("rank", range(R + 1))
def test_null_space_sampler_properties(rank, size):
    """(a) at an all-zero memory the basis is ``e_0 ... e_{R-1}``, as
    every SVD gives; (b) each noise has unit norm and is orthogonal to the
    stored rows within 1e-5; (c) the span has dimension R - rank, as that
    of JAX's SVD sampler on the same memory. D = 6 has fewer than 2R
    standard basis vectors to draw on."""
    bad = _memory(rank, size)
    memory = torch.from_numpy(bad)
    basis = nsgd.null_basis(memory)
    assert basis.shape == (R, size)
    if rank == 0:
        assert torch.equal(basis, torch.eye(R, size))
    gram = basis @ basis.t()
    kept = R - rank
    torch.testing.assert_close(gram[:kept, :kept], torch.eye(kept),
                               rtol=0, atol=1e-6)
    assert (basis[kept:] == 0).all()
    samples = torch.cat([
        nsgd.null_space_sample(torch.Generator().manual_seed(s),
                               memory.view(R, 2, size // 2))
        .reshape(R, -1) for s in range(3)])
    if kept:
        torch.testing.assert_close(samples.norm(dim=1), torch.ones(3 * R),
                                   rtol=0, atol=1e-6)
    else:   # no null space: zero noise, as the SVD sampler gives
        assert (samples == 0).all()
    rows = memory[:rank] / memory[:rank].norm(dim=1, keepdim=True)
    assert np.abs((samples @ rows.t()).numpy()).max(initial=0.0) < 1e-5
    want = _jax_samples(bad, 3 * R)
    assert np.abs(want @ rows.numpy().T).max(initial=0.0) < 1e-5
    assert _span_dimension(samples.numpy()) == kept
    assert _span_dimension(want) == kept


def test_null_space_sample_of_a_one_element_leaf_is_a_sign():
    got = nsgd.null_space_sample(torch.Generator().manual_seed(0),
                                 torch.randn(R, 1))
    assert torch.equal(got.abs(), torch.ones(R, 1))


def test_nsgd_memory_is_written_in_place(tmp_path):
    """After a step each memory tensor is the one it was (the same
    storage) and holds the losers' noises that ``updated_aux`` gives."""
    exp = _experiment("nsgd", tmp_path)
    alg, state = exp.algorithm, exp.state
    memory = state.aux["bad_noise"]
    ptrs = [t.data_ptr() for t in memory]
    captured = {}
    real = alg.updated_aux

    def keeping(state, noises, win_totals):
        captured["new"] = real(state, noises, win_totals)
        return captured["new"]

    alg.updated_aux = keeping
    batch = exp.feeds["train"].train_batch(
        torch.Generator().manual_seed(0), state)
    state, _ = alg.train_step(state, batch,
                              torch.Generator().manual_seed(1))
    assert state.aux["bad_noise"] is memory
    assert [t.data_ptr() for t in state.aux["bad_noise"]] == ptrs
    for got, want in zip(tree_leaves(state.aux),
                         tree_leaves(captured["new"])):
        assert torch.equal(got, want)


def test_fresh_candidates_draw_from_the_given_generator_only(tmp_path):
    """Under ``candidate_source=fresh`` each candidate's initialisation
    comes from the step's generator: the same seed gives the same scores,
    another seed others, and torch's global generator does not move."""
    exp = Experiment(dict(_settings("mgd"), learning_algorithm_hparams=(
        "candidate_source=fresh,click_model_json="
        + os.path.join(REPO, "example", "ClickModel",
                       "pbm_0.1_1.0_4_1.0.json"))), "unused",
        str(tmp_path), batch_size=B, seed=3, device="cpu")
    exp.setup(datasets={"train": _dataset(48, 0), "valid": _dataset(20, 1)})
    exp.init_state()
    alg, state = exp.algorithm, exp.state
    batch = exp.feeds["train"].train_batch(
        torch.Generator().manual_seed(0), state)
    noises = alg.sample_noises(state, torch.Generator().manual_seed(1))
    global_state = torch.random.get_rng_state()
    runs = [alg.candidate_scores(state, batch, noises,
                                 torch.Generator().manual_seed(seed))
            for seed in (5, 5, 6)]
    assert torch.equal(torch.random.get_rng_state(), global_state)
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0], runs[2][0])       # the current ranker
    assert not torch.equal(runs[0][1], runs[2][1])   # a fresh candidate


def test_online_windows_would_be_captured_on_the_card(tmp_path):
    """On a CUDA device only the CPU and ``--dp`` > 1 keep windows eager:
    an online feed no longer does."""
    exp = _experiment("nsgd", tmp_path)
    assert exp.eager_reason() == "CUDA graphs exist only on the card"
    exp.device = torch.device("cuda")
    assert exp.eager_reason() is None


@pytest.mark.parametrize("config", ["pdgd", "nsgd"])
def test_pipelined_and_sync_readback_agree(toy_data_dir, tmp_path, capsys,
                                           config):
    """PDGD and NSGD through the CLI: the pipelined loop and
    ``--sync_readback`` print the same lines and save the same
    checkpoint, NSGD's memory included (2 windows and a tail)."""
    settings = _settings(config)
    settings["ranking_model_hparams"] = "hidden_layer_sizes=[16, 8]"
    settings.pop("selection_bias_cutoff")
    setting_file = tmp_path / "settings.json"
    setting_file.write_text(json.dumps(settings))
    lines, ckpts = {}, {}
    for mode, extra in (("pipelined", []), ("sync", ["--sync_readback"])):
        model_dir = tmp_path / mode
        cli.main(["--device", "cpu", "--data_dir", toy_data_dir,
                  "--setting_file", str(setting_file), "--model_dir",
                  str(model_dir), "--batch_size", str(B),
                  "--max_train_iteration", "9", "--steps_per_checkpoint",
                  "4", "--seed", "7"] + extra)
        lines[mode] = [line.split(" (")[0] + line.split(")", 1)[-1]
                       for line in capsys.readouterr().out.splitlines()
                       if line.startswith(("step ", "  saved"))]
        name = settings["learning_algorithm"].rsplit(".", 1)[-1]
        with np.load(model_dir / f"{name}.ckpt.npz") as arrays:
            ckpts[mode] = {k: arrays[k] for k in arrays.files}
    assert lines["pipelined"] == lines["sync"] and len(lines["sync"]) >= 3
    assert ckpts["pipelined"].keys() == ckpts["sync"].keys()
    for k, v in ckpts["sync"].items():
        np.testing.assert_array_equal(ckpts["pipelined"][k], v)
