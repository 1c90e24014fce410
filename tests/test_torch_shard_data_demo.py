"""The port's ``tools/shard_data_demo.py`` on the CPU at 2,000 rows x 12
features in lists of 20.

* The blockwise stripe a rank builds equals ``shard_queries_for_host`` of
  the whole table (the JAX package's and the port's), array for array,
  with blocks that split a stripe and with one block; the whole table is
  its blocks in order, in the JAX demo's layout.
* The demo over three gloo ranks: each rank's table is the replicated
  table over the ranks within one query's rows (the stripes' padding),
  the losses are finite, and the JAX demo's keys are there.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu.data import dataset as jax_data
from ultra_pytorch_tpu.parallel import (
    shard_queries_for_host as jax_shard_queries)
from ultra_pytorch_tpu_torch.parallel import shard_queries_for_host
from ultra_pytorch_tpu_torch.tools import shard_data_demo as demo

ROWS, F, L = 2000, 12, 20
# The keys of the JAX demo's line (tools/shard_data_demo.py), with
# queries_per_s in place of queries_per_s_cpu_mesh.
JAX_KEYS = {"rows", "features", "gb_per_device_sharded", "gb_replicated",
            "steps", "loss_first", "loss_last", "queries_per_s"}


def _arrays(ds):
    return {"features": ds.features, "initial_list": ds.initial_list,
            "labels": ds.labels, "lengths": ds.initial_list_lengths,
            "qids": np.asarray(ds.qids), "dids": np.asarray(ds.dids)}


def test_the_whole_table_is_its_blocks():
    full = demo.stripe_dataset(ROWS, F, L, 0, 1, seed=3, block_rows=300)
    blocks = [demo.draw_block(3, b, min(300, ROWS - 300 * b), F)
              for b in range(-(-ROWS // 300))]
    np.testing.assert_array_equal(full.features, np.concatenate(blocks))
    np.testing.assert_array_equal(
        full.initial_list, np.arange(ROWS).reshape(ROWS // L, L))
    assert full.labels.min() >= 0 and full.labels.max() <= 4
    assert (full.labels[:, 0] >= 1).all() and full.max_label == 4.0


@pytest.mark.parametrize("block_rows", [300, demo.BLOCK_ROWS])
@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_stripe_equals_shard_queries_for_host(ranks, block_rows):
    full = demo.stripe_dataset(ROWS, F, L, 0, 1, seed=3,
                               block_rows=block_rows)
    jax_full = jax_data.RankingDataset(
        features=full.features, initial_list=full.initial_list,
        labels=full.labels, qids=full.qids, dids=full.dids,
        feature_size=F, rank_list_size=L, max_label=4.0)
    for rank in range(ranks):
        got = _arrays(demo.stripe_dataset(ROWS, F, L, rank, ranks, seed=3,
                                          block_rows=block_rows, threads=2))
        for want in (shard_queries_for_host(full, rank, ranks),
                     jax_shard_queries(jax_full, rank, ranks)):
            want = _arrays(want)
            for name in got:
                np.testing.assert_array_equal(got[name], want[name], name)


@pytest.fixture(scope="module")
def three_ranks():
    torch.set_num_threads(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = demo.main(["--device", "cpu", "--rows", str(ROWS),
                            "--features", str(F), "--list_size", str(L),
                            "--steps", "3", "--batch", "6", "--ranks", "3"])
    return result, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_jax_keys_and_finite_losses(three_ranks):
    result, printed = three_ranks
    assert printed == json.loads(json.dumps(result))
    assert JAX_KEYS <= set(result)
    assert result["rows"] == ROWS and result["steps"] == 3
    assert np.isfinite([result["loss_first"], result["loss_last"]]).all()
    assert result["ranks"] == 3 and result["windows"] == "eager"
    assert result["max_memory_allocated_gb"] == [None] * 3


def test_a_ranks_table_is_its_share(three_ranks):
    result = three_ranks[0]
    replicated = result["gb_replicated"]
    assert replicated == ROWS * F * 4 / 1e9
    # 100 queries over 3 ranks: 34 queries a stripe, one query's rows
    # above a third of the table.
    query_gb = L * F * 4 / 1e9
    assert result["gb_per_device_sharded"] == pytest.approx(
        34 * query_gb, rel=1e-12)
    assert 0 <= result["gb_per_device_sharded"] - replicated / 3 <= query_gb
