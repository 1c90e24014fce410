"""The port's MGD step against the benchmark's plain reference
(``perfbench/reference/mgd_dnn_mslr10k.py`` and ``perfbench/yardstick/
mgd.py``), on the CPU at a small size: F = 8, lists of 12, a DNN [16, 8],
four candidates, seeded random weights.

One step through ``Experiment`` (the online feed, then MGD's step) is
held to the plain step drawing from the same seed: the five rankers'
scores, each ranker's Plackett-Luce ranking, the team draft and the
clicks from the same uniforms, each query's share of the clicks and the
updated leaves. Then the benchmark's check (``perfbench/drivers/
online.py``: three one-step windows and a window, shadowed by the
reference) passes the port and fails it with a planted fault: no
update, an update that also moves LayerNorm's scale, or a step that
decides from scores 0.1% off; the scores it holds the plain forward to
are those the step produced."""

import pytest
import torch

from perfbench import spec
from perfbench.drivers import online
from perfbench.yardstick import compare, keys, mgd
from ultra_pytorch_tpu_torch.algorithms.dbgd import DBGD
from ultra_pytorch_tpu_torch.algorithms import dbgd as port_dbgd
from ultra_pytorch_tpu_torch.input_layer.feeds import _OnlineSimulationFeed
from ultra_pytorch_tpu_torch.models import base as model_base

SEED = 2 ** 31 + 4321


def _cell(window_steps=3):
    cell = spec.cell("mgd_dnn")
    cell.config = dict(
        cell.config, features=8, list_length=12, queries=40, batch_size=16,
        ranker_hparams=dict(cell.config["ranker_hparams"],
                            hidden_layer_sizes=[16, 8]))
    cell.traffic = dict(cell.traffic, window_steps=window_steps)
    return cell


def _spy(monkeypatch, cls_or_module, name, seen):
    sound = getattr(cls_or_module, name)

    def spied(*args, **kwargs):
        out = sound(*args, **kwargs)
        seen[name] = (args, out)
        return out

    monkeypatch.setattr(cls_or_module, name, spied)


def test_one_step_against_the_plain_reference(monkeypatch):
    cell = _cell()
    cfg = cell.config
    setup = online.build(cell, SEED, "cpu")
    seen = {}
    _spy(monkeypatch, _OnlineSimulationFeed, "online_batch", seen)
    _spy(monkeypatch, DBGD, "candidate_scores", seen)
    _spy(monkeypatch, port_dbgd, "draft", seen)
    _spy(monkeypatch, DBGD, "draft_winners", seen)
    score_program = online.program_scoring(setup.exp.algorithm.ranker)
    setup.exp.train_steps_device(1)
    after = online._leaves(setup.exp.algorithm.ranker)

    plain = mgd.PlainMGD(cfg, torch.from_numpy(setup.table), setup.grades,
                         setup.ranker, cell.reference.forward,
                         cell.reference.noise)
    gen = torch.Generator().manual_seed(keys.window_seeds(SEED, 1)[0])
    ref = plain.step(gen, score_program)
    decision = ref["decision"]

    batch = seen["online_batch"][1]
    for key in ("features", "labels", "mask"):
        assert torch.equal(batch[key], ref["batch"][key]), key
    port_scores = seen["candidate_scores"][1]
    assert len(port_scores) == 5
    for mine, theirs in zip(ref["scores"][1:], port_scores):
        torch.testing.assert_close(theirs, mine, rtol=1e-5, atol=1e-5)
    rankings = seen["draft"][0][0]
    assert torch.equal(rankings, decision["rankings"])
    (_, multileaved, teams, _, _, _), (winners, clicks, _) = (
        seen["draft_winners"][0], seen["draft_winners"][1])
    assert torch.equal(multileaved, decision["shown"])
    assert torch.equal(teams, decision["teams"])
    assert torch.equal(clicks, decision["clicks"])
    torch.testing.assert_close(winners, decision["credit"], rtol=0,
                               atol=1e-7)
    assert float(winners.sum()) > 0
    for mine, theirs in zip(ref["leaves"], after):
        torch.testing.assert_close(theirs, mine, rtol=1e-5, atol=1e-6)
    setup.tmp.cleanup()


def _unchanged(monkeypatch):
    def apply_noise_update(self, state, noises, win_share):
        state.step += 1
        return state

    monkeypatch.setattr(DBGD, "apply_noise_update", apply_noise_update)


def _moves_layer_norm(monkeypatch):
    """The update also moves LayerNorm's scale, which the noise never
    perturbs."""
    sound = DBGD.apply_noise_update

    def apply_noise_update(self, state, noises, win_share):
        out = sound(self, state, noises, win_share)
        with torch.no_grad():
            for module in state.params.modules():
                if isinstance(module, model_base.LayerNorm):
                    module.weight.add_(1e-3)
        return out

    monkeypatch.setattr(DBGD, "apply_noise_update", apply_noise_update)


def _scores_off(monkeypatch):
    """The step decides from rankers' scores 0.1% off the ranker's."""
    sound = DBGD.candidate_scores

    def candidate_scores(self, *args, **kwargs):
        return [s * 1.001 for s in sound(self, *args, **kwargs)]

    monkeypatch.setattr(DBGD, "candidate_scores", candidate_scores)


def test_the_check_records_the_scores_the_step_produced(monkeypatch):
    cell = _cell()
    setup = online.build(cell, SEED, "cpu")
    seen = []
    sound = DBGD.candidate_scores

    def candidate_scores(self, *args, **kwargs):
        out = sound(self, *args, **kwargs)
        seen.append([s.clone() for s in out])
        return out

    monkeypatch.setattr(DBGD, "candidate_scores", candidate_scores)
    program = online.check_steps(setup, cell.traffic["window_steps"])
    setup.tmp.cleanup()
    assert len(program["scores"]) == mgd.CHECK_STEPS
    for mine, theirs in zip(program["scores"], seen):
        assert len(mine) == 2 + cell.config["algorithm_hparams"][
            "ranker_num"]
        for a, b in zip(mine[1:], theirs):
            assert torch.equal(a, b)
    # The window after the checked steps runs without the copies.
    assert "score" not in vars(setup.exp.algorithm)
    assert "candidate_scores" not in vars(setup.exp.algorithm)


@pytest.mark.parametrize("fault", [None, _unchanged, _moves_layer_norm,
                                   _scores_off])
def test_the_check_passes_the_port_and_catches_a_planted_fault(
        monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    cell = _cell()
    setup = online.build(cell, SEED, "cpu")
    program = online.check_steps(setup, cell.traffic["window_steps"])
    ref = online.reference(cell, SEED, setup, "cpu",
                           shadow=program["states"],
                           recorded=program["scores"],
                           score_program=online.program_scoring(
                               setup.exp.algorithm.ranker))
    gaps = mgd.gaps(program, ref)
    setup.tmp.cleanup()
    assert compare.judge(gaps, cell.limits) is (fault is None), gaps
    if fault is _unchanged:
        assert gaps["change_gap"] == pytest.approx(1.0)
        assert gaps["share_gap"] > 0.01
    if fault is _moves_layer_norm:
        assert gaps["change_gap"] > 1e-3
    if fault is _scores_off:
        assert gaps["score_gap"] == pytest.approx(1e-3, rel=1e-2)
