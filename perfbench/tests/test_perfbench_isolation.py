"""No module that the harness or the references load has the top-level
name jax, jaxlib, flax or ultra_pytorch_tpu (compared whole: the port,
ultra_pytorch_tpu_torch, begins with that name), and the references load
nothing of the port."""

import json
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.tests.conftest import ROOT

LOAD_ALL = """
import json, sys
from perfbench import spec
bench = spec.benchmark()
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

HARNESS = """
import perfbench.run, perfbench.calibrate
import perfbench.drivers.train
for c in bench["configs"]:
    spec.load_module("work", c["name"])
for m in bench["per_layer"]:
    spec.load_module("metrics", m["name"])
"""

REFERENCES = """
import pkgutil, importlib, perfbench.yardstick as y
for info in pkgutil.iter_modules(y.__path__):
    importlib.import_module("perfbench.yardstick." + info.name)
for c in bench["configs"]:
    spec.load_module("reference", c["name"])
"""


def _top_level_names(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          LOAD_ALL.format(imports=imports)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level_names(HARNESS)
    assert "ultra_pytorch_tpu_torch" in names or "torch" in names
    assert not names & set(run.BANNED)


def test_references_load_nothing_of_the_port():
    names = _top_level_names(REFERENCES)
    assert not names & (set(run.BANNED) | {"ultra_pytorch_tpu_torch"})


@pytest.mark.parametrize("loaded,found", [
    (["ultra_pytorch_tpu_torch", "ultra_pytorch_tpu_torch.run"], []),
    (["ultra_pytorch_tpu.models"], ["ultra_pytorch_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["flaxen", "jax_utils"], []),
])
def test_banned_names_compare_whole(monkeypatch, loaded, found):
    fake = {name: object() for name in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.banned_modules() == found


def test_a_run_ends_with_no_jax_loaded():
    """A whole training run on the CPU, in a process of its own."""
    code = ("from perfbench.tests.conftest import tiny_cell, SEED\n"
            "from perfbench import run\n"
            "run.execute(tiny_cell('dla_dnn_kernels'), SEED, 0.2, False,"
            " 'cpu', 0.0)\n"
            "print(run.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    assert out.stdout.splitlines()[-1] == "[]"
