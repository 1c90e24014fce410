"""Helpers of the benchmark's CPU tests: cells cut to a size a test run
holds (the harness's look for a card skipped: these call the drivers
directly, on the CPU)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 1234567  # beyond 32 signed bits, as the driver's are


def tiny_cell(name: str):
    """The cell `name` at 40 queries of 12 documents, three-step
    windows."""
    from perfbench import spec

    cell = spec.cell(name)
    cell.config = dict(cell.config, queries=40, list_length=12)
    cell.traffic = dict(cell.traffic, window_steps=3)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
