"""The port's measurement tools on the JAX tools' protocol.

* At its default each of ``profile_step``, ``roofline``, ``bench_eval``,
  ``bench_scaling`` and ``shard_data_demo`` builds the experiment its JAX
  counterpart builds: every kernel hparam off. ``profile_step``,
  ``roofline`` and ``bench_scaling`` are held to the JAX harness's
  ``make_bench_setup`` run on the CPU (ranker, algorithm and feed hparams
  as the packages parse them, list length, cutoff, metrics);
  ``bench_eval`` and ``shard_data_demo`` to the settings dict of the JAX
  script, read from its source by AST.
* With ``--kernels`` each builds exactly those settings with the
  ``all_on`` extras of ``bench_pallas.py`` appended.
* ``--prng`` (both tools) and ``roofline``'s ``--ranker-extra`` reach the
  experiment; the defaults of ``--prng`` are the JAX tools'.
* ``roofline``'s ``flops_per_step`` and ``bytes_per_step`` are the same
  with and without the kernels; ``kernel_flops_per_step`` and ``hfu``
  are null without them.
* ``bench_eval --train-qps`` takes the measured training rate's place.
"""

import ast
import json
import os

import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models and algorithms need it

from tools import bench_common as jax_bench  # noqa: E402
from ultra_pytorch_tpu_torch.models.dnn import DNN  # noqa: E402
from ultra_pytorch_tpu_torch.tools import bench_common as bc  # noqa: E402
from ultra_pytorch_tpu_torch.tools import (  # noqa: E402
    bench_eval, bench_kernels, bench_scaling, profile_step, roofline,
    shard_data_demo)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = "hidden_layer_sizes=[32, 16]"
SMALL = ["--device", "cpu", "--features", "16", "--hidden", HIDDEN]
ALL_ON = next(dict(zip(("ranker_extra", "algo_extra", "feed_extra"), c[1:]))
              for c in bench_kernels.COMBOS if c[0] == "all_on")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Built(Exception):
    """Raised with the first experiment a tool builds."""


@pytest.fixture
def built(monkeypatch):
    """``built(main, argv)``: runs a tool's ``main`` until it has built
    its first experiment through ``bench_common.experiment``, and returns
    that experiment."""
    real = bc.experiment

    def stop(*args, **kwargs):
        raise _Built(real(*args, **kwargs))

    monkeypatch.setattr(bc, "experiment", stop)

    def run(main, argv):
        with pytest.raises(_Built) as info:
            main(argv)
        return info.value.args[0]

    return run


def _source(*path):
    with open(os.path.join(ROOT, *path)) as fin:
        return ast.parse(fin.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == name)


def _assigned_value(fn, name):
    return next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name)


def _evaluate(node, names):
    return eval(compile(ast.Expression(node), "<jax source>", "eval"),
                {"os": os}, dict(names))


def _flag_default(tree, flag):
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "add_argument"
                and n.args and getattr(n.args[0], "value", None) == flag)
    return next(ast.literal_eval(k.value) for k in call.keywords
                if k.arg == "default")


def _hparams(h):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in h.values().items()}


def _feed_hparams(text):
    """A feed's hparam string as a dict, the click model read from its
    file."""
    out = dict(item.split("=", 1) for item in text.split(",") if item)
    with open(out.pop("click_model_json")) as fin:
        out["click_model"] = json.load(fin)
    return out


def _ranker_hparams(text):
    return _hparams(DNN(text, 4).hparams)


def _held_to_make_bench_setup(exp, **extras):
    """`exp` has the ranker, algorithm and feed hparams, the list length,
    the cutoff, the batch and the metrics of the JAX harness's
    ``make_bench_setup(**extras)``."""
    alg, jfeed, _ = jax_bench.make_bench_setup(num_queries=64, **extras)
    mine, feed = exp.algorithm, exp.feeds["train"]
    assert _hparams(mine.ranker.hparams) == _hparams(alg.ranker.hparams)
    assert _hparams(mine.hparams) == _hparams(alg.hparams)
    want, got = _hparams(jfeed.hparams), _hparams(feed.hparams)
    with open(want.pop("click_model_json")) as a, open(
            got.pop("click_model_json")) as b:
        assert json.load(a) == json.load(b)
    assert got == want
    assert (mine.max_candidate_num, mine.rank_list_size) == (
        alg.max_candidate_num, alg.rank_list_size)
    assert feed.batch_size == jfeed.batch_size
    assert (exp.exp_settings["metrics"], exp.exp_settings["metrics_topn"]) \
        == (["ndcg"], [10])


def _kernel_hparams(exp):
    return (exp.algorithm.ranker.hparams.use_pallas,
            exp.algorithm.hparams.loss_func,
            exp.feeds["train"].hparams.use_pallas_click)


KERNELS_OFF = (False, "softmax_loss", False)
KERNELS_ON = (True, "fused_softmax_loss", True)


# -- profile_step and roofline: make_bench_setup ----------------------------

TOOLS = {"profile_step": (profile_step.main, []),
         "roofline": (roofline.main, ["--no-time"])}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_the_default_is_the_jax_protocol(tool, built):
    main, argv = TOOLS[tool]
    exp = built(main, ["--device", "cpu"] + argv)
    _held_to_make_bench_setup(exp)
    assert _kernel_hparams(exp) == KERNELS_OFF
    jax_default = _flag_default(_source("tools", f"{tool}.py"), "--prng")
    assert exp.prng_impl == jax_default == "rbg"


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_kernels_are_the_all_on_extras(tool, built):
    main, argv = TOOLS[tool]
    exp = built(main, ["--device", "cpu", "--kernels"] + argv)
    _held_to_make_bench_setup(exp, **ALL_ON)
    assert _kernel_hparams(exp) == KERNELS_ON
    plain = bc.protocol_settings("X")
    on = bc.protocol_settings("X", **ALL_ON)
    for key in ("ranking_model_hparams", "learning_algorithm_hparams"):
        assert exp.exp_settings[key] == on[key]
    assert exp.exp_settings["train_input_hparams"].endswith(
        ALL_ON["feed_extra"])
    assert on["ranking_model_hparams"] == (plain["ranking_model_hparams"]
                                           + ALL_ON["ranker_extra"])


@pytest.mark.parametrize("prng", bc.PRNGS)
@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_prng_reaches_the_experiment(tool, prng, built):
    main, argv = TOOLS[tool]
    exp = built(main, ["--device", "cpu", "--prng", prng] + argv)
    assert exp.prng_impl == prng
    _held_to_make_bench_setup(exp)


def test_roofline_ranker_extra_reaches_the_experiment(built):
    exp = built(roofline.main, ["--device", "cpu", "--no-time",
                                "--ranker-extra", ",compute_dtype=bfloat16"])
    assert exp.algorithm.ranker.hparams.compute_dtype == "bfloat16"
    _held_to_make_bench_setup(exp, ranker_extra=",compute_dtype=bfloat16")


def test_profile_step_prints_the_jax_prng(capsys):
    out = profile_step.main(SMALL + ["--steps", "25", "--batch", "8",
                                     "--list-size", "5", "--prng",
                                     "threefry2x32", "--kernels"])
    assert out["prng"] == "threefry2x32" and out["generator"] == "mt19937"
    assert out["protocol"]["kernels"] is True
    assert out["allow_tf32"] is torch.backends.cuda.matmul.allow_tf32
    # The plain versions run on the CPU, so nothing is launched here.
    assert out["launches"] == dict.fromkeys(bc.KERNELS, 0)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_roofline_counts_one_yardstick_both_ways():
    args = SMALL + ["--batch", "8", "--list-size", "5", "--no-time"]
    plain = roofline.main(args)
    kernels = roofline.main(args + ["--kernels"])
    for key in ("flops_per_step", "bytes_per_step", "products",
                "arithmetic_intensity"):
        assert plain[key] == kernels[key], key
    assert plain["kernel_flops_per_step"] is None
    assert kernels["kernel_flops_per_step"] > kernels["flops_per_step"]
    assert (plain["protocol"]["kernels"], kernels["protocol"]["kernels"]) \
        == (False, True)


def test_roofline_default_run_has_no_hfu(capsys):
    out = roofline.main(SMALL + ["--batch", "8", "--list-size", "5",
                                 "--chunk", "2", "--steps", "4"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["hfu"] is None and out["kernel_flops_per_step"] is None
    assert 0 < out["mfu"] <= 1 and out["mfu_vs_bf16_peak"] is None
    assert out["launches"] == dict.fromkeys(bc.KERNELS, 0)
    assert out["protocol"]["prng"] == "rbg"


def test_roofline_gives_the_bf16_share_where_the_ranker_runs_bf16():
    out = roofline.main(SMALL + ["--batch", "8", "--list-size", "5",
                                 "--chunk", "2", "--steps", "2",
                                 "--ranker-extra", ",compute_dtype=bfloat16"])
    assert out["mfu_vs_bf16_peak"] == pytest.approx(
        out["achieved_tflops"] * 1e12 / bc.PEAK_BF16)
    assert out["mfu"] == pytest.approx(out["achieved_tflops"] * 1e12
                                       / bc.PEAK_3XTF32)


@pytest.mark.parametrize("mlp,loss", [(True, False), (False, True)])
def test_kernel_count_follows_what_runs(mlp, loss):
    model = DNN(HIDDEN, 16)
    n = 8 * 5
    k3, _, k4, _ = roofline.loss_work(8, 5)
    got = roofline.step_work(model, 8, 5, mlp, loss)
    want = ((roofline.mlp_work(model, n)[0] + roofline.mlp_bwd_work(
        model, n)[0]) if mlp else 0) + (2 * (k3 + k4) if loss else 0)
    assert got["kernel_flops_per_step"] == want
    assert got["flops_per_step"] == roofline.step_work(
        model, 8, 5)["flops_per_step"]


# -- bench_eval: the JAX script's settings dict -----------------------------

def _jax_eval_settings():
    fn = _function(_source("tools", "bench_eval.py"), "main")
    return _evaluate(_assigned_value(fn, "settings"), {"repo": ROOT})


def _held_to_settings(got, want, extras=("", "", "")):
    """`got` (the port's settings) is `want` (a JAX script's) with
    `extras` appended to the ranker, algorithm and feed hparams: every key
    of `want` the same, the hparam strings as parsed."""
    ranker, algo, feed = extras
    for key, value in want.items():
        if key == "ranking_model_hparams":
            assert _ranker_hparams(got[key]) == _ranker_hparams(
                value + ranker)
        elif key == "learning_algorithm_hparams":
            assert got[key] == ",".join(x for x in (value, algo) if x)
        elif key == "train_input_hparams":
            assert _feed_hparams(got[key]) == _feed_hparams(value + feed)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("kernels", [False, True])
def test_bench_eval_builds_the_jax_settings(kernels, built):
    argv = SMALL + ["--queries", "20", "--list-size", "12", "--batch", "8"]
    exp = built(bench_eval.main, argv + (["--kernels"] if kernels else []))
    want = _jax_eval_settings()
    assert (want["metrics"], want["metrics_topn"]) == (["ndcg", "mrr"],
                                                       [3, 5, 10])
    extras = tuple(ALL_ON.values()) if kernels else ("", "", "")
    _held_to_settings(exp.exp_settings,
                      dict(want, ranking_model_hparams=HIDDEN), extras)
    assert _kernel_hparams(exp) == (KERNELS_ON if kernels else KERNELS_OFF)
    # The tool's default widths are the JAX script's.
    assert _ranker_hparams(want["ranking_model_hparams"]) == \
        _ranker_hparams(bc.HIDDEN)
    assert exp.exp_settings["selection_bias_cutoff"] == 10


def test_bench_eval_takes_the_training_rate_given(capsys, monkeypatch):
    def measured(*args, **kwargs):
        raise AssertionError("--train-qps given: nothing to measure")

    monkeypatch.setattr(bench_eval, "train_rate", measured)
    out = bench_eval.main(SMALL + ["--queries", "20", "--list-size", "12",
                                   "--batch", "8", "--repeats", "1",
                                   "--train-qps", "1000"])
    assert out["train_queries_per_sec"] == 1000.0
    window_s = bench_eval.WINDOW * 8 / 1000.0
    for way in ("fused", "naive_loop", "pipelined", "deep_pipeline"):
        dt = out[way]["wall_s"]
        assert out[way]["window_share_pct"] == pytest.approx(
            100 * dt / (dt + window_s))


def test_bench_eval_train_qps_default_is_not_the_tpu_figure():
    """JAX's default is its TPU's rate; the port's measures this run's."""
    jax_tool = _source("tools", "bench_eval.py")
    port = _source("ultra_pytorch_tpu_torch", "tools", "bench_eval.py")
    assert _flag_default(jax_tool, "--train-qps") == 1_850_000
    assert _flag_default(port, "--train-qps") is None


# -- bench_scaling: a rank's experiment -------------------------------------

def test_bench_scaling_jax_tool_runs_make_bench_setup_settings():
    """The JAX tool's settings are ``_exp_settings(10)`` and its feed takes
    the click model alone: ``make_bench_setup``'s defaults."""
    fn = _function(_source("tools", "bench_scaling.py"), "main")
    call = _assigned_value(fn, "settings")
    assert ast.unparse(call) == "_exp_settings(10)"
    feed = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "ClickSimulationFeed")
    assert ast.unparse(feed.args[2]) == "f'click_model_json={cm_path}'"


@pytest.mark.parametrize("kernels", [False, True])
def test_a_bench_scaling_rank_builds_the_jax_protocol(kernels, built,
                                                      tmp_path):
    threads = torch.get_num_threads()
    try:
        with pytest.raises(_Built) as info:
            bench_scaling._rank_rate(
                0, 1, f"file://{tmp_path / 'rendezvous'}", "cpu", None, 2, 1,
                bc.FEATURES, bc.HIDDEN, kernels)
    finally:
        torch.set_num_threads(threads)
    exp = info.value.args[0]
    _held_to_make_bench_setup(exp, **(ALL_ON if kernels else {}))
    assert _kernel_hparams(exp) == (KERNELS_ON if kernels else KERNELS_OFF)


# -- shard_data_demo: the JAX demo's settings dict --------------------------

def _jax_demo():
    """The JAX demo's settings at L = 200 and its feed's hparam string."""
    fn = _function(_source("tools", "shard_data_demo.py"), "main")
    settings = _evaluate(_assigned_value(fn, "settings"), {"L": 200})
    cm_path = _evaluate(_assigned_value(fn, "cm_path"), {"REPO": ROOT})
    feed = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "ClickSimulationFeed")
    return settings, _evaluate(feed.args[2], {"cm_path": cm_path})


@pytest.mark.parametrize("kernels", [False, True])
def test_shard_data_demo_builds_the_jax_settings(kernels):
    want, feed = _jax_demo()
    got = shard_data_demo.demo_settings(200, kernels)
    ranker, algo, feed_extra = (tuple(ALL_ON.values()) if kernels
                                else ("", "", ""))
    assert got == dict(want, ranking_model_hparams=want[
        "ranking_model_hparams"] + ranker, learning_algorithm_hparams=algo,
        train_input_feed="ClickSimulationFeed",
        train_input_hparams=feed + feed_extra)
    assert got["selection_bias_cutoff"] == 10


def test_shard_data_demo_defaults_to_the_library_path(monkeypatch,
                                                      tmp_path):
    """``main`` passes ``kernels=False`` unless ``--kernels``, and a rank
    trains on ``demo_settings(L, kernels)``."""
    calls = []
    monkeypatch.setattr(shard_data_demo, "demo",
                        lambda *a, **k: calls.append(k["kernels"]))
    shard_data_demo.main(["--device", "cpu"])
    shard_data_demo.main(["--device", "cpu", "--kernels"])
    assert calls == [False, True]

    seen = []
    real = shard_data_demo.demo_settings

    def spy(list_size, kernels=False):
        seen.append((list_size, kernels))
        return real(list_size, kernels)

    monkeypatch.setattr(shard_data_demo, "demo_settings", spy)
    threads = torch.get_num_threads()
    try:
        res = shard_data_demo._rank_demo(
            0, 1, f"file://{tmp_path / 'rendezvous'}", "cpu", None, 400, 8,
            20, 2, 4, 0, False)
    finally:
        torch.set_num_threads(threads)
    assert seen == [(20, False)]
    assert res["launches"] == dict.fromkeys(bc.KERNELS, 0)
