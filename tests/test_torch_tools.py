"""The port's tools (``ultra_pytorch_tpu_torch/tools/``) on the CPU at small
widths: each prints one parseable JSON line last with the JAX tool's
keys; roofline's count equals a hand count and agrees with XLA's cost
analysis of the JAX step; bench_eval's three ways agree. Also the three
public names the port added beside them (``metrics.ranking.ndcg``,
``sim.interleave.team_draft_interleave``, ``data.dataset.PAD_LABEL``),
held to the JAX package."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_pytorch_tpu.data import dataset as jax_dataset
from ultra_pytorch_tpu.metrics import ranking as jax_ranking
from ultra_pytorch_tpu.sim import interleave as jax_interleave
from ultra_pytorch_tpu_torch.data import dataset as torch_dataset
from ultra_pytorch_tpu_torch.metrics import ranking as torch_ranking
from ultra_pytorch_tpu_torch.models.dnn import DNN
from ultra_pytorch_tpu_torch.sim import interleave as torch_interleave
from ultra_pytorch_tpu_torch.tools import (bench_common, bench_eval,
                                           bench_serve, bench_serve_http,
                                           gen_docs, profile_step, roofline)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = "hidden_layer_sizes=[32, 16]"
SMALL = ["--device", "cpu", "--features", "16", "--hidden", HIDDEN]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_profile_step_keys(capsys):
    out = profile_step.main(SMALL + ["--steps", "25", "--batch", "8",
                                     "--list-size", "5"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    # The JAX tool's keys, then the eager twins and the busy share.
    for key in ("feed_us", "train_us", "full_us", "prng"):
        assert key in out
    for name in ("feed", "train", "full"):
        assert out[f"{name}_eager_us"] > 0
        assert out[f"{name}_us"] is None      # no graphs off the card
    assert out["busy_share"] is None and out["graphs"] is False
    assert out["protocol"]["steps"] == 25
    assert out["launches"] == dict.fromkeys(bench_common.KERNELS, 0)


# The JAX tool's keys (tools/roofline.py) and the port's name for each:
# the v5e's bf16 peak has no counterpart, the H100's rate for these
# products is 3xTF32's.
ROOFLINE_KEYS = {
    "protocol": "protocol", "flops_per_step": "flops_per_step",
    "flops_per_query": "flops_per_query", "bytes_per_step": "bytes_per_step",
    "bytes_per_query": "bytes_per_query",
    "arithmetic_intensity": "arithmetic_intensity",
    "queries_per_sec": "queries_per_sec", "step_time_us": "step_time_us",
    "achieved_tflops": "achieved_tflops",
    "achieved_hbm_gbs": "achieved_hbm_gbs", "mfu_vs_bf16_peak": "mfu",
    "mfu_vs_f32_rate": "mfu_vs_f32", "hbm_utilization": "hbm_utilization",
    "compute_floor_us_bf16": "compute_floor_us_3xtf32",
    "compute_floor_us_f32": "compute_floor_us_f32",
    "memory_floor_us_upper_bound": "memory_floor_us",
    "headroom_vs_f32_compute_floor_x": "headroom_vs_3xtf32_compute_floor_x",
}


def test_roofline_keys(capsys):
    out = roofline.main(SMALL + ["--batch", "8", "--list-size", "5",
                                 "--chunk", "2", "--steps", "4"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    for key in ROOFLINE_KEYS.values():
        assert key in out, key
    assert out["step_time_us"] > 0 and 0 < out["mfu"] <= 1
    assert out["hfu"] > out["mfu"]
    assert out["bound_by"] in ("operations", "bytes")


def _hand_count(features, hidden, batch, length):
    """The DLA step's operations written out layer by layer: forward
    (LayerNorm 6 a input, product 2 a weight, bias, ELU but on the head),
    backward (dW 2 a weight, db; on every layer but the first dX 2 a
    weight, LayerNorm 10 and ELU 2 a input), two softmax losses (21 an
    element), the towers' weights (6 an element, twice), Adagrad (10 a
    parameter of both towers)."""
    widths = [features] + hidden + [1]
    n = batch * length
    fwd = bwd = params = 0
    for j, (a, b) in enumerate(zip(widths, widths[1:])):
        fwd += 6 * a + 2 * a * b + b + (b if j < len(hidden) else 0)
        bwd += 2 * a * b + b + ((2 * a * b + 10 * a + 2 * a) if j else 0)
        params += a * b + b + 2 * a
    return (n * (fwd + bwd) + 2 * 21 * n + 6 * 2 * n
            + 10 * (params + length + 1))


@pytest.mark.parametrize("features,hidden,batch,length", [
    (16, [32, 16], 8, 5), (136, [512, 256, 128], 256, 10)])
def test_roofline_count_equals_hand_count(features, hidden, batch, length):
    model = DNN(f"hidden_layer_sizes={hidden}", features)
    work = roofline.step_work(model, batch, length)
    assert work["flops_per_step"] == _hand_count(features, hidden, batch,
                                                 length)
    products = work["products"]
    widths = [features] + hidden + [1]
    mm = [2 * batch * length * a * b for a, b in zip(widths, widths[1:])]
    assert products == {"forward": sum(mm), "weights_gradient": sum(mm),
                        "activations_gradient": sum(mm[1:]),
                        "features_gradient": mm[0]}
    n = batch * length
    k3, _, k4, _ = roofline.loss_work(batch, length)
    assert work["kernel_flops_per_step"] == (
        roofline.mlp_work(model, n)[0] + roofline.mlp_bwd_work(model, n)[0]
        + 2 * (k3 + k4))


def test_roofline_bench_protocol_products():
    # 3 x 2 x 2,560 x (136*512 + 512*256 + 256*128 + 128) products a step
    # once each (forward, dW, dX down to the features).
    model = DNN(bench_common.HIDDEN, bench_common.FEATURES)
    products = roofline.step_work(model, 256, 10)["products"]
    assert sum(products.values()) == 3 * 2 * 2560 * 233600 == 3_588_096_000


def test_roofline_count_agrees_with_xla_on_the_jax_step():
    from tools import roofline as jax_roofline

    jax_out = jax_roofline.analyze(
        batch=256, list_size=10, features=136, chunk=1, steps=1,
        prng="threefry2x32", timed=False)
    ported = roofline.analyze("cpu", timed=False)
    assert ported["protocol"]["batch"] == jax_out["protocol"]["batch"]
    ratio = ported["flops_per_step"] / jax_out["flops_per_step"]
    assert abs(ratio - 1) < 0.10, (ported["flops_per_step"],
                                   jax_out["flops_per_step"])
    assert ported["flops_per_query"] == ported["flops_per_step"] / 256


def test_bench_serve_keys_and_k1_against_plain(capsys):
    out = bench_serve.main(SMALL + ["--iters", "2"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    assert out["metric"] == "serve_throughput" and out["unit"] == "queries/s"
    assert sorted(out["results"]) == sorted(
        f"{way}_{q}x{n}" for way in ("k1", "plain")
        for q, n in bench_serve.BUCKETS)
    assert all(v > 0 for v in out["results"].values())
    for check in out["k1_vs_plain"].values():
        assert check["scores_close"] and check["order_violations"] == 0


def test_order_violations_counts_rises_beyond_the_slack():
    plain = np.array([[0.3, 0.2, 0.1, 0.0]])
    assert bench_serve.order_violations(np.array([[0, 1, 2, 3]]), plain,
                                        0.0) == 0
    assert bench_serve.order_violations(np.array([[1, 0, 2, 3]]), plain,
                                        0.0) == 1
    assert bench_serve.order_violations(np.array([[1, 0, 2, 3]]), plain,
                                        0.2) == 0


# The JAX tool's keys of a row (tools/bench_serve_http.py).
HTTP_KEYS = {"error_samples", "mode", "clients", "requests_total", "errors",
             "queries_per_request", "list_size", "wall_s", "queries_per_sec",
             "latency_p50_ms", "latency_p99_ms"}


def test_bench_serve_http_two_clients(capsys):
    out = bench_serve_http.main(SMALL + ["--clients", "2", "--requests", "2",
                                         "--queries", "2", "--list-size",
                                         "4", "--timeout", "60"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    lock, micro = out["results"]
    assert lock["mode"] == "lock_serialized"
    assert micro["mode"] == "micro_batched"
    for row in (lock, micro):
        assert HTTP_KEYS <= set(row)
        assert row["errors"] == 0 and row["requests_total"] == 4
        assert row["queries_per_sec"] > 0
    assert 1 <= micro["device_calls"] <= 4
    assert micro["coalescing_factor"] == 4 / micro["device_calls"]


def test_bench_eval_three_ways_agree(capsys):
    out = bench_eval.main(SMALL + ["--queries", "40", "--list-size", "12",
                                   "--batch", "8", "--repeats", "2"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    for key in ("queries", "list_size", "features", "batch",
                "metric_values", "speedup", "speedup_pipelined"):
        assert key in out
    for way in ("fused", "naive_loop", "pipelined", "deep_pipeline"):
        assert set(out[way]) == {"wall_s", "eval_queries_per_sec",
                                 "window_share_pct"}
        assert 0 < out[way]["window_share_pct"] < 100
    assert out["max_diff"] <= 1e-4
    assert out["train_queries_per_sec"] > 0
    assert set(out["metrics"]) == {f"{m}_{n}" for m in ("mrr", "ndcg")
                                   for n in (3, 5, 10)}


def test_bench_eval_loop_equals_validate():
    exp = bench_common.bench_experiment(
        "cpu", 8, 12, 16, HIDDEN, data={
            "train": bench_common.synthetic(16, 0, 12, 16),
            "valid": bench_eval.ragged(bench_common.synthetic(30, 1, 12, 16),
                                       2)})
    assert (exp.datasets["valid"].initial_list_lengths >= 6).all()
    assert (exp.datasets["valid"].initial_list == -1).any()
    fused, loop = exp.validate(), bench_eval.loop_validate(exp)
    assert fused.keys() == loop.keys()
    for k in fused:
        assert abs(fused[k] - loop[k]) <= 1e-4, k


def test_gen_docs_writes_both_files(tmp_path, capsys):
    out = gen_docs.main(["--device", "cpu", "--out", str(tmp_path)])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    api = (tmp_path / "torch_api.md").read_text()
    algos = (tmp_path / "torch_algorithms.md").read_text()
    assert "## `ultra_pytorch_tpu_torch.tools.roofline`" in api
    assert "### def `team_draft_interleave(" in api
    assert "## DLA" in algos and "| `loss_func` | `'softmax_loss'` |" in algos
    # The committed files are what the tool writes.
    for name in ("torch_api.md", "torch_algorithms.md"):
        with open(os.path.join(ROOT, "docs", name)) as fin:
            assert fin.read() == (tmp_path / name).read_text(), (
                f"docs/{name} is stale: python -m "
                "ultra_pytorch_tpu_torch.tools.gen_docs --device cpu")


def test_tools_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (profile_step, roofline, bench_serve, bench_serve_http,
                 bench_eval, gen_docs):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])


# -- the three names ------------------------------------------------------

@pytest.mark.parametrize("topn", [1, 3, 10])
def test_ndcg_equals_jax(topn):
    rng = np.random.default_rng(topn)
    labels = rng.integers(0, 5, size=(16, 12)).astype(np.float32)
    preds = rng.normal(size=(16, 12)).astype(np.float32)
    got = torch_ranking.ndcg(torch.from_numpy(labels),
                             torch.from_numpy(preds), topn)
    want = jax_ranking.ndcg(jnp.asarray(labels), jnp.asarray(preds), topn)
    assert got.shape == () and abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("seed,n_rankers,length", [(0, 2, 10), (1, 4, 12),
                                                   (2, 3, 7)])
def test_team_draft_interleave_equals_jax_draft(seed, n_rankers, length):
    rng = np.random.default_rng(seed)
    batch = 6
    rankings = np.stack([np.stack([rng.permutation(length)
                                   for _ in range(n_rankers)])
                         for _ in range(batch)]).astype(np.int64)
    for b in range(2):   # a prefix of three documents shared by all
        head = rankings[b, 0, :3]
        for r in range(1, n_rankers):
            rest = [d for d in rankings[b, r] if d not in head]
            rankings[b, r] = np.concatenate([head, rest])
    gen = torch.Generator().manual_seed(seed)
    order = torch_interleave.round_assignments(gen, batch, n_rankers,
                                               length)
    docs, teams = torch_interleave.team_draft_interleave(
        torch.Generator().manual_seed(seed), torch.from_numpy(rankings))
    assert docs.shape == teams.shape == (batch, length)
    for b in range(batch):
        want_docs, want_teams = jax_interleave._draft_one(
            jnp.asarray(rankings[b], jnp.int32),
            jnp.asarray(order[b].numpy(), jnp.int32))
        np.testing.assert_array_equal(docs[b].numpy(), np.asarray(want_docs))
        np.testing.assert_array_equal(teams[b].numpy(),
                                      np.asarray(want_teams))
    assert (teams[:2, :3] == -1).all()
    assert sorted(docs[0].tolist()) == list(range(length))


def test_pad_label_equals_jax():
    assert torch_dataset.PAD_LABEL == jax_dataset.PAD_LABEL == -1.0
    assert isinstance(torch_dataset.PAD_LABEL, float)
