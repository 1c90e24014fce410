"""The port's benchmark scripts against the JAX system's: ``bench``,
``tools/bench_exp`` and ``tools/bench_kernels`` (the counterparts of
``bench.py``, ``tools/bench_exp.py`` and ``tools/bench_pallas.py``'s part
3) on the JAX protocol (``tools/bench_common.py``).

* The data: ``bench_common.synthetic`` equals ``_make_synthetic`` of
  ``__graft_entry__.py`` array for array.
* The settings: for each of ``bench_pallas.py``'s seven combinations the
  ranker's, the algorithm's and the feed's hparams that the port parses
  equal the JAX ones, and so do the list length and the cutoff.
* One DLA step at full width ([512, 256, 128], F = 136, B = 256, L = 10)
  on one batch of the protocol's data, from JAX's weights carried across
  by ``dla.params_from_jax``, for ``all_off`` and ``all_on``: the metrics,
  both towers and both optimizer states within 1e-4 of JAX's
  ``train_step``. With ``all_on`` the port's kernel hparams run their
  plain versions on the CPU and JAX runs its Pallas kernels in interpret
  mode, as its own tests run them. The step adds ``l2_loss=0.001`` and a
  LayerNorm affine away from its init to the protocol, as
  ``tests/test_torch_dla.py`` does: under the shift-invariant softmax
  loss the gradient of the last LayerNorm's bias is float noise, and
  Adagrad's first step turns noise into a step of ``lr`` (both packages
  then differ there by up to 3% of ``lr``, whichever is right).
* The output: each script's last line has the JAX script's keys (read
  from its source by AST). That each defaults to the card is
  ``tests/test_torch_isolation.py``'s.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models and algorithms need it

from __graft_entry__ import _exp_settings, _make_synthetic  # noqa: E402
from tools import bench_common as jax_bench  # noqa: E402
from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu_torch import bench  # noqa: E402
from ultra_pytorch_tpu_torch.algorithms import dla  # noqa: E402
from ultra_pytorch_tpu_torch.run.experiment import (  # noqa: E402
    create_algorithm)
from ultra_pytorch_tpu_torch.tools import bench_common  # noqa: E402
from ultra_pytorch_tpu_torch.tools import bench_exp, bench_kernels  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
COMBOS = {name: (r, a, f) for name, r, a, f in bench_kernels.COMBOS}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_source(*path):
    with open(os.path.join(ROOT, *path)) as fin:
        return ast.parse(fin.read())


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- the data and the settings ---------------------------------------------

def test_synthetic_data_is_jax_array_for_array():
    want = _make_synthetic(4096, 10, 136)
    got = bench_common.synthetic(4096, 0, 10, 136)
    for name in ("features", "labels", "initial_list"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.qids == want.qids and got.dids == want.dids
    assert (got.feature_size, got.rank_list_size, got.max_label) == (
        want.feature_size, want.rank_list_size, want.max_label)


@pytest.mark.parametrize("list_size", [10, 30])
def test_exp_settings_are_jax(list_size):
    assert bench_common.exp_settings(list_size) == _exp_settings(list_size)


def test_the_combinations_are_bench_pallas():
    """bench_kernels' combinations are bench_pallas.py's, in its order,
    with its extras (the ``combos`` list of ``part3_e2e``, read by AST)."""
    tree = _jax_source("tools", "bench_pallas.py")
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "part3_e2e")
    combos = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and n.targets[0].id == "combos")
    assert ast.literal_eval(combos.value) == [tuple(c) for c in
                                              bench_kernels.COMBOS]


def _hparams(h):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in h.values().items()}


@pytest.mark.parametrize("combo", list(COMBOS))
def test_settings_are_jax(combo):
    ranker, algo, feed = COMBOS[combo]
    alg, jfeed, _ = jax_bench.make_bench_setup(
        num_queries=64, ranker_extra=ranker, algo_extra=algo,
        feed_extra=feed)
    exp = bench_common.make_bench_setup(
        "cpu", num_queries=64, ranker_extra=ranker, algo_extra=algo,
        feed_extra=feed)
    mine, pfeed = exp.algorithm, exp.feeds["train"]
    assert _hparams(mine.ranker.hparams) == _hparams(alg.ranker.hparams)
    assert _hparams(mine.hparams) == _hparams(alg.hparams)
    want_feed, got_feed = _hparams(jfeed.hparams), _hparams(pfeed.hparams)
    jax_json, port_json = (want_feed.pop("click_model_json"),
                           got_feed.pop("click_model_json"))
    assert got_feed == want_feed
    with open(jax_json) as a, open(port_json) as b:
        assert json.load(a) == json.load(b)
    assert (mine.max_candidate_num, mine.rank_list_size) == (
        alg.max_candidate_num, alg.rank_list_size) == (10, 10)
    assert pfeed.batch_size == jfeed.batch_size == 256
    for key in ("metrics", "metrics_topn"):
        assert exp.exp_settings[key] == _exp_settings()[key]


# -- one DLA step at full width --------------------------------------------

def _protocol_batch():
    """256 queries of the protocol's data, clicks at 0.3 and always on the
    first document."""
    ds = bench_common.synthetic(4096, 0)
    rng = np.random.default_rng(2)
    qs = rng.choice(ds.initial_list.shape[0], 256, replace=False)
    clicks = (rng.random((256, 10)) < 0.3).astype(np.float32)
    clicks[:, 0] = 1.0
    return {"features": ds.features[ds.initial_list[qs]],
            "labels": clicks, "mask": np.ones((256, 10), np.float32),
            "initial_scores": np.zeros((256, 10), np.float32)}


def _step_settings(combo):
    ranker, algo, _ = COMBOS[combo]
    settings = _exp_settings(10)
    settings["ranking_model_hparams"] += ranker
    settings["learning_algorithm_hparams"] = ",".join(
        filter(None, [algo, "l2_loss=0.001"]))
    return settings


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


@pytest.mark.parametrize("combo", ["all_off", "all_on"])
def test_one_full_width_step_matches_jax(combo):
    batch = _protocol_batch()
    alg = jax_create_algorithm(_step_settings(combo), 136, 2.0)
    state0 = alg.init_state(jax.random.PRNGKey(0), 136)
    state0 = state0.replace(params=_perturbed_norms(state0.params))
    want, want_metrics = alg.train_step(state0, batch,
                                        jax.random.PRNGKey(1))
    mine = create_algorithm(_step_settings(combo), 136, 2.0, device="cpu")
    state = mine.init_state(torch.Generator().manual_seed(0))
    dla.params_from_jax(state, state0.params, state0.aux["propensity"])
    state, metrics = mine.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=TOL,
                                   atol=TOL, err_msg=k)
    got = dla.params_to_jax(state)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(got["propensity"][k],
                                   np.asarray(want.aux["propensity"][k]),
                                   rtol=TOL, atol=TOL)
    opt = dla.opt_state_to_jax(state)
    for mine_opt, theirs in ((opt["ranker"], want.opt_state),
                             (opt["propensity"],
                              want.aux["prop_opt_state"])):
        leaves = jax.tree_util.tree_leaves(theirs)
        assert len(mine_opt) == len(leaves)
        for a, b in zip(mine_opt.values(), leaves):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


# -- the scripts' output ----------------------------------------------------

def _dict_keys(tree, fn_name):
    """The keys of the dict literal that ``fn_name`` passes to
    ``json.dumps``."""
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == fn_name)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps"
                and isinstance(n.args[0], ast.Dict))
    return [k.value for k in call.args[0].keys], call.args[0]


def test_bench_prints_the_jax_line(capsys, monkeypatch):
    monkeypatch.delenv("ULTRA_REF_QPS", raising=False)
    out = bench.main(["--device", "cpu", "--steps", "4", "--chunk", "2",
                      "--baseline-steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    last, details = json.loads(lines[-1]), json.loads(lines[-2])
    keys, node = _dict_keys(_jax_source("bench.py"), "main")
    assert list(last) == keys == ["metric", "value", "unit", "vs_baseline"]
    metric = ast.literal_eval(node.values[0])
    assert last["metric"] == metric == "dla_dnn_train_throughput"
    assert last["unit"] == "queries/s" and last == out
    assert last["value"] > 0 and last["vs_baseline"] > 0
    assert details["launches"] == dict.fromkeys(bench_common.KERNELS, 0)
    assert (details["windows"], details["steps"]) == (3, 6)
    assert np.isfinite(details["loss"]) and details["pool_bytes"] is None
    assert any(line.startswith("baseline: ") for line in lines)


def test_bench_takes_the_reference_rate_from_the_environment(capsys,
                                                             monkeypatch):
    monkeypatch.setenv("ULTRA_REF_QPS", "2.0")
    out = bench.main(["--device", "cpu", "--steps", "2", "--chunk", "1",
                      "--kernels"])
    details = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    assert details["baseline_queries_per_s"] == 2.0 and details["kernels"]
    assert out["vs_baseline"] == round(details["queries_per_s"] / 2.0, 2)


def test_bench_constants_are_jax():
    tree = _jax_source("bench.py")
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign)
              and isinstance(n.targets[0], ast.Name)
              and n.targets[0].id in ("BATCH", "LIST_SIZE", "FEATURES",
                                      "BENCH_STEPS", "CHUNK")}
    assert consts == {k: getattr(bench, k) for k in consts}
    assert len(consts) == 5
    assert bench_common.KERNEL_EXTRAS == COMBOS["all_on"]


def test_bench_exp_prints_the_jax_keys(capsys):
    out = bench_exp.main(["--device", "cpu", "--steps", "2", "--chunk", "1",
                          "--batch", "8", "--features", "24",
                          "--list-size", "6", "--prng", "rbg"])
    keys, _ = _dict_keys(_jax_source("tools", "bench_exp.py"), "main")
    last = _last_json(capsys)
    assert list(last) == keys and last == out
    assert (last["features"], last["list_size"], last["prng"]) == (24, 6,
                                                                   "rbg")
    assert last["queries_per_s"] > 0


def test_bench_kernels_prints_the_combinations(capsys, monkeypatch):
    monkeypatch.setattr(bench_kernels, "CHUNK", 1)   # 3 steps a combination
    out = bench_kernels.main(["--device", "cpu", "--steps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert list(out) == list(COMBOS) and all(v > 0 for v in out.values())
    details = json.loads(lines[-2])
    # The plain versions run on the CPU, so nothing is launched here.
    assert details["launches"] == {
        name: dict.fromkeys(bench_common.KERNELS, 0) for name in COMBOS}


@pytest.mark.parametrize("combo", list(COMBOS))
def test_combo_launches_follow_the_hparams(combo):
    got = bench_kernels.combo_launches(*COMBOS[combo], 225, 9)
    on = {"K1": 225, "K2": 225, "K3": 450, "K4": 450, "K5": 10}
    want = {"all_off": {}, "bf16": {}, "rounds_resample": {},
            "pallas_mlp": {"K1", "K2"}, "fused_loss": {"K3", "K4"},
            "pallas_click": {"K5"}, "all_on": set(on)}[combo]
    assert got == {k: on[k] if k in want else 0 for k in on}
