"""The online cell ``mgd_dnn``: its work counts, its entries in
``BENCHMARK.json``, the plain MGD pieces against cases worked by hand,
the harness loading nothing it forbids, and its check: a run on the CPU
at a small size is ``correct``, and with the update left out it is not;
on the card the TF32 control fails a limit (``pytest -m gpu
perfbench/tests``)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import run, spec
from perfbench.tests.conftest import ROOT, SEED
from perfbench.yardstick import mgd

NEW_METRICS = ("online_feed_ms.train", "candidates_ms.train",
               "multileave_ms.train", "scoring_passes.train")
READ_IN_MGD = ("window_host_ms.train", "mfu.train", "mlp_fwd_roofline.train",
               "idle_share.train", "window_device_ms.train",
               "launch_wait_ms.train", "replay_host_ms.train",
               "step_update_ms.train", "capture_s.train")


def test_forward_work_equals_roofline():
    from ultra_pytorch_tpu_torch.models.dnn import DNN
    from ultra_pytorch_tpu_torch.tools import roofline

    cfg = spec.load_json("configs", "mgd_dnn_mslr10k")
    work = spec.load_module("work", "mgd_dnn_mslr10k")
    model = DNN("hidden_layer_sizes=[512,256,128]", 136)
    for rows in (30720, 2560):
        assert work.mlp_fwd(cfg, rows) == roofline.mlp_work(model, rows)
    # Six forwards over 256 x 120 rows are nearly all of a step's work.
    six = 6 * work.mlp_fwd(cfg, 256 * 120)[0]
    assert six < work.flops_per_step(cfg) < 1.01 * six


def test_the_cell_and_its_metrics_in_benchmark_json():
    bench = spec.benchmark()
    (config,) = [c for c in bench["configs"]
                 if c["name"] == "mgd_dnn_mslr10k"]
    assert config["reduced"] == []
    (cell,) = [w for w in bench["workloads"] if w["name"] == "mgd_dnn"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "mgd_dnn_mslr10k", "online_kernels", 1)
    got = {m["name"] for m in spec.cell("mgd_dnn", bench).per_layer}
    assert got == set(NEW_METRICS) | set(READ_IN_MGD)
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == ["mgd_dnn"]
            assert m["moves"] == "train_qps"
    limits = spec.load_json("workloads", "mgd_dnn")
    assert set(limits["limits"]) == {"score_gap", "share_gap",
                                     "change_gap", "window_loss_gap"}
    assert set(limits["reasons"]) == set(limits["limits"])


def test_team_draft_by_hand():
    rankings = np.array([[0, 1, 2, 3, 4], [0, 2, 1, 4, 3],
                         [0, 3, 4, 1, 2]])
    # Document 0 is the common prefix; then rankers 2, 0, 1, 1 in turn.
    shown, teams = mgd.team_draft(rankings, np.array([9, 2, 0, 1, 1]), 5)
    assert shown == [0, 3, 1, 2, 4]
    assert teams == [-1, 2, 0, 1, 1]


def test_ndcg_and_applied_credit_by_hand():
    labels = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    scores = torch.tensor([[3.0, 2.0, 1.0], [1.0, 2.0, 3.0]])
    got = mgd.ndcg_at(labels, scores, torch.ones_like(labels))
    ideal = 1 + 1 / np.log2(3)
    assert float(got) == pytest.approx((1 + 0.5) / ideal / 2, rel=1e-6)
    gen = torch.Generator().manual_seed(3)
    noises = [torch.randn(4, 6, 5, generator=gen), torch.zeros(4, 5),
              torch.randn(4, 5, generator=gen)]
    credit = torch.tensor([0.1, 0.0, 0.3, 0.2])
    before = [torch.randn(n.shape[1:], generator=gen) for n in noises]
    after = [b - 0.5 * torch.tensordot(credit, n, dims=1)
             for b, n in zip(before, noises)]
    found = mgd.applied_credit(before, after, noises, 0.5)
    torch.testing.assert_close(found.float(), credit, atol=1e-6, rtol=0)


def test_the_online_harness_loads_no_jax():
    code = ("import json, sys\n"
            "import perfbench.run, perfbench.calibrate_online\n"
            "import perfbench.drivers.online\n"
            "from perfbench import spec\n"
            "spec.load_module('reference', 'mgd_dnn_mslr10k')\n"
            "spec.load_module('work', 'mgd_dnn_mslr10k')\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert not names & set(run.BANNED)


def _unchanged(monkeypatch):
    from ultra_pytorch_tpu_torch.algorithms.dbgd import DBGD

    def apply_noise_update(self, state, noises, win_share):
        state.step += 1
        return state

    monkeypatch.setattr(DBGD, "apply_noise_update", apply_noise_update)


@pytest.mark.parametrize("fault", [None, _unchanged])
def test_online_faults(tiny, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    out = run.execute(tiny("mgd_dnn"), SEED, 0.3, False, "cpu", 0.0)
    assert out["correct"] is (fault is None), out["gaps"]


@pytest.mark.gpu
def test_online_control_fails():
    """At 600 queries and five-step windows: the program within every
    limit, the TF32 control and the fault outside one at least."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import calibrate_online

    cell = spec.cell("mgd_dnn")
    cell.config = dict(cell.config, queries=600)
    cell.traffic = dict(cell.traffic, window_steps=5)
    run.set_precision(cell.config)
    out = calibrate_online.online(cell, SEED)
    assert all(out["program"][k] <= v for k, v in cell.limits.items())
    for name in ("control", "unchanged"):
        assert any(out[name][k] > v for k, v in cell.limits.items()), name
