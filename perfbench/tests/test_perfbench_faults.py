"""A whole run on the CPU at a small size, the harness's look for a card
skipped: sound, ``correct`` is true; with the timed path broken
underneath, it is false. One fault of each kind a cell can have: a
training step that leaves the state unchanged, half of each batch left
out (the mean over the rest). One chip, so no exchange between chips to
leave out; no answer is served."""

import pytest

from perfbench import run
from perfbench.tests.conftest import SEED


def _run(cell, seconds=0.3):
    return run.execute(cell, SEED, seconds, False, "cpu", 0.0)


def _unchanged(monkeypatch):
    from ultra_pytorch_tpu_torch.algorithms.dla import DLA

    def apply_gradients(self, state, grads):
        state.step += 1
        return state

    monkeypatch.setattr(DLA, "apply_gradients", apply_gradients)


def _half_batch(monkeypatch):
    from ultra_pytorch_tpu_torch.input_layer.feeds import ClickSimulationFeed

    sound = ClickSimulationFeed.batch_from_plan

    def batch_from_plan(self, plan, i):
        batch = sound(self, plan, i)
        batch["mask"] = batch["mask"].clone()
        batch["mask"][batch["mask"].shape[0] // 2:] = 0.0
        return batch

    monkeypatch.setattr(ClickSimulationFeed, "batch_from_plan",
                        batch_from_plan)


@pytest.mark.parametrize("name", ["dla_dnn_kernels", "dla_setrank",
                                  "dla_dnn_library"])
@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch])
def test_training_faults(tiny, monkeypatch, name, fault):
    if fault is not None:
        fault(monkeypatch)
    out = _run(tiny(name))
    assert out["correct"] is (fault is None), out["gaps"]

