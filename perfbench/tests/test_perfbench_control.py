"""The control on the card: the plain reference computed with TF32 on
(the precision below the configurations' float32 with TF32 off), put in
the program's place, fails at least one of each cell's numbers, while the
program at the same size stays within every limit. At a size a test run
holds (600 queries, five-step windows); the readings at the cells' own
sizes are in PERF.md. Needs the card: ``pytest -m gpu perfbench/tests``."""

import pytest
import torch

from perfbench import calibrate, run, spec
from perfbench.tests.conftest import SEED


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dla_dnn_kernels", "dla_setrank",
                                  "dla_dnn_library"])
def test_training_control_fails(card, name):
    cell = spec.cell(name)
    cell.config = dict(cell.config, queries=600)
    cell.traffic = dict(cell.traffic, window_steps=5)
    run.set_precision(cell.config)
    out = calibrate.training(cell, SEED)
    assert all(out["program"][k] <= v for k, v in cell.limits.items())
    assert any(out["control"][k] > v for k, v in cell.limits.items())

