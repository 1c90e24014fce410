"""The port's ``tools/bench_scaling.py`` on the CPU at [32, 16] widths:
one line a world size with the JAX tool's keys, the state identical on
every rank, and the efficiency the JAX tool's formula."""

import contextlib
import io
import json

import pytest
import torch

from ultra_pytorch_tpu_torch.tools import bench_scaling

# The keys of the JAX tool's line (tools/bench_scaling.py).
JAX_KEYS = {"devices", "queries_per_sec", "scaling_efficiency"}
ARGS = ["5", "2", "--device", "cpu", "--max_ranks", "2", "--features", "16",
        "--hidden", "hidden_layer_sizes=[32, 16]"]


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = bench_scaling.main(ARGS)
    return rows, [json.loads(line) for line in out.getvalue().splitlines()
                  if line.startswith("{")]


def test_one_line_a_world_size_with_the_jax_keys(run):
    rows, printed = run
    assert printed == json.loads(json.dumps(rows))
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert JAX_KEYS <= set(r)
        assert r["queries_per_sec"] > 0
        assert r["windows"] == "eager" and r["shared_card"] is False
        assert r["launches"] == dict.fromkeys(r["launches"], 0)


def test_the_ranks_hold_the_same_state(run):
    assert all(r["same_state"] for r in run[0])


def test_efficiency_is_the_formula(run):
    rows = run[0]
    base = rows[0]["queries_per_sec"]
    assert rows[0]["scaling_efficiency"] == 1.0
    for r in rows:
        assert r["scaling_efficiency"] == r["queries_per_sec"] / (
            base * r["devices"])


def test_world_sizes_and_the_shared_card():
    assert bench_scaling.world_sizes(1) == [1]
    assert bench_scaling.world_sizes(6) == [1, 2, 4]
    with pytest.raises(ValueError, match="one card"):
        bench_scaling.scaling("cpu", share_card=2)
