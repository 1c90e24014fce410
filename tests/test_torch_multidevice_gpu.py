"""The multi-device entry points on the card at small sizes.

* ``entry()``: one K1 launch, equal to its plain version.
* ``dryrun_multichip`` as an NCCL group of one (every window a captured
  graph) and as two gloo ranks sharing ``cuda:0``: all 18 cases.
* ``shard_data_demo`` at 20,000 rows x 220 features in lists of 200, on
  one rank (graph windows) and as two gloo ranks sharing ``cuda:0``, with
  ``--kernels``: finite losses, each rank's share of the table, exact
  launches.
* ``bench_scaling --kernels`` at [32, 16] widths over the visible cards
  and with two ranks sharing ``cuda:0``.

These need a CUDA device and skip without one. The file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import math

import pytest
import torch

from ultra_pytorch_tpu_torch.ops.kernels import click_sim, listwise_loss, mlp
from ultra_pytorch_tpu_torch.run import dryrun
from ultra_pytorch_tpu_torch.run.launch import shared_card
from ultra_pytorch_tpu_torch.tools import bench_scaling, shard_data_demo
from ultra_pytorch_tpu_torch.tools.bench_common import dla_launches
from ultra_pytorch_tpu_torch.utils import spans

pytestmark = pytest.mark.gpu

TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    mlp.build_kernel()              # once here, before any rank starts
    mlp.build_backward_kernel()
    listwise_loss.build_kernel()
    click_sim.build_kernel()
    return torch.device("cuda", 0)


def test_entry_is_one_k1_launch(cuda):
    fn, (ranker, features, mask) = dryrun.entry()
    before = spans.counters()["launches.K1"]
    scores = fn(ranker, features, mask)
    assert spans.counters()["launches.K1"] - before == 1
    with torch.no_grad():
        ref = mlp.fused_mlp_score_reference(ranker.layers, features)
    assert scores.shape == (8, 10)
    torch.testing.assert_close(scores, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("share_card,graphs", [(0, 18), (2, 0)])
def test_dryrun_on_the_card(cuda, share_card, graphs):
    ranks, device, backend = (shared_card(share_card, cuda) if share_card
                              else (1, None, None))
    out = dryrun.dryrun_multichip(ranks, device=device, backend=backend)
    assert len(out) == ranks
    for results in out:
        assert len(results) == 18
        assert all(r["same"] and r["step"] == 2 and math.isfinite(r["loss"])
                   for r in results)
        assert sum(r["graph"] for r in results) == graphs


@pytest.mark.parametrize("args,windows", [
    (["--ranks", "1"], "graph"), (["--share_card", "2"], "eager")])
def test_shard_data_demo_on_the_card(cuda, args, windows):
    res = shard_data_demo.main(["--rows", "20000", "--steps", "3",
                                "--batch", "16", "--kernels"] + args)
    assert math.isfinite(res["loss_first"]) and math.isfinite(
        res["loss_last"])
    assert res["windows"] == windows
    assert res["gb_per_device_sharded"] * res["ranks"] == pytest.approx(
        res["gb_replicated"], rel=1e-12)
    assert all(gb > res["gb_per_device_sharded"]
               for gb in res["max_memory_allocated_gb"])
    assert res["launches"] == dla_launches(3, 3, res["ranks"])


def test_bench_scaling_on_the_card(cuda):
    small = ["3", "2", "--features", "16", "--hidden",
             "hidden_layer_sizes=[32, 16]", "--kernels"]
    rows = bench_scaling.main(small)
    shared = bench_scaling.main(small + ["--share_card", "2"])
    assert [r["devices"] for r in rows] == bench_scaling.world_sizes(
        torch.cuda.device_count())
    assert [r["devices"] for r in shared] == [1, 2]
    for r in rows + shared:
        assert r["same_state"] and r["queries_per_sec"] > 0
        assert r["windows"] == ("eager" if r["shared_card"] else "graph")
        assert r["launches"] == dla_launches(3 * 3, 3, r["devices"])
