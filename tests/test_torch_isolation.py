"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import inspect
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import ultra_pytorch_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(ultra_pytorch_tpu_torch.__file__)

# `import jax` / `from jax...`, and the JAX package's module name. The
# port's own name begins with the old one, so `\b` (no word character may
# follow) keeps `ultra_pytorch_tpu_torch` out; a following `/` is a file
# path that a comment cites as the reference, not a module.
JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
JAX_PACKAGE = re.compile(r"\bultra_pytorch_tpu\b(?!/)")
# The JAX system's root module and scripts directory, which the port's
# counterparts of them (run/dryrun.py, tools/) must not import either.
JAX_SCRIPTS = re.compile(
    r"^\s*(import|from)\s+(__graft_entry__|tools)\b", re.M)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sources():
    files = [os.path.join(ROOT, name) for name in (
        "chip_smoke.py", "torch_convergence.py", "torch_mlp_probe.py",
        "torch_loss_probe.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    return sorted(files)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ultra_pytorch_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ultra_pytorch_tpu' "
        "or m.startswith('ultra_pytorch_tpu.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    expected = [m.name for m in pkgutil.walk_packages(
        ultra_pytorch_tpu_torch.__path__, "ultra_pytorch_tpu_torch.")]
    assert n_modules == len(expected) >= 15


def test_sources_name_neither_jax_nor_the_jax_package():
    files = _sources()
    for name in ("mlp_fwd.cu", "letor_parser.cpp", "data/native.py",
                 "parallel/mesh.py", "run/launch.py", "run/window.py",
                 "pipeline/initial_ranking.py", "torch_convergence.py",
                 "run/dryrun.py", "tools/bench_scaling.py",
                 "tools/shard_data_demo.py",
                 "ultra_pytorch_tpu_torch/bench.py", "tools/bench_exp.py",
                 "tools/bench_kernels.py"):
        assert any(f.endswith(name) for f in files), name
    for path in files:
        with open(path) as fh:
            text = fh.read()
        assert not JAX_IMPORT.search(text), f"{path} imports jax"
        assert not JAX_SCRIPTS.search(text), (
            f"{path} imports the JAX system's __graft_entry__ or tools/")
        hit = JAX_PACKAGE.search(text)
        assert hit is None, (
            f"{path} names the JAX package: "
            f"{text[max(0, hit.start() - 40): hit.end() + 20]!r}")


def test_scan_patterns_catch_what_they_should():
    assert JAX_IMPORT.search("import jax.numpy as jnp")
    assert JAX_IMPORT.search("    from jax import lax")
    assert not JAX_IMPORT.search("import jaxtyping_like_name_not_jax")
    assert JAX_PACKAGE.search("from ultra_pytorch_tpu.models import dnn")
    assert JAX_PACKAGE.search("import ultra_pytorch_tpu\n")
    assert not JAX_PACKAGE.search("from ultra_pytorch_tpu_torch import x")
    assert not JAX_PACKAGE.search("see ultra_pytorch_tpu/ops/pallas/mlp.py")
    assert JAX_SCRIPTS.search("from __graft_entry__ import entry")
    assert JAX_SCRIPTS.search("    from tools.make_toy_data import main")
    assert JAX_SCRIPTS.search("import tools.bench_common")
    assert not JAX_SCRIPTS.search(
        "from ultra_pytorch_tpu_torch.tools import bench_common")
    assert not JAX_SCRIPTS.search("from toolsy import x")


def test_scorer_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                       monkeypatch):
    from ultra_pytorch_tpu_torch.models.dnn import DNN, params_to_jax
    from ultra_pytorch_tpu_torch.serve import Scorer
    from ultra_pytorch_tpu_torch.utils.checkpoint import save_checkpoint

    model = DNN("hidden_layer_sizes=[8]", 6)
    save_checkpoint(str(tmp_path / "DLA.ckpt"), params_to_jax(model),
                    metadata={"serve": {
                        "exp_settings": {"ranking_model": "DNN",
                                         "ranking_model_hparams":
                                             "hidden_layer_sizes=[8]"},
                        "feature_size": 6}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer.from_checkpoint(str(tmp_path))
    cpu = Scorer.from_checkpoint(str(tmp_path), device="cpu")
    assert cpu.device.type == "cpu"
    assert cpu.ranker.hparams.use_pallas is False  # auto: off off-CUDA


def test_serve_cli_defaults_to_cuda(tmp_path, monkeypatch):
    from ultra_pytorch_tpu_torch.serve import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FileNotFoundError):
        cli.main(["--model_dir", str(tmp_path), "--device", "cpu"])
    (tmp_path / "x.ckpt.npz").write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model_dir", str(tmp_path)])


def _starters():
    """Every public function that starts ranks or processes, called with
    its default device: name -> a call."""
    from ultra_pytorch_tpu_torch.run import __main__ as cli
    from ultra_pytorch_tpu_torch.run import dryrun, launch
    from ultra_pytorch_tpu_torch.tools import bench_scaling, shard_data_demo

    return {
        "launch": lambda: launch.launch(["--batch_size", "8"]),
        "spawn_cli": lambda: launch.spawn_cli(cli.parse_args([]), 2),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(2),
        "dryrun.main": lambda: dryrun.main(["--ranks", "2"]),
        "dryrun.entry": dryrun.entry,
        "bench_scaling.main": lambda: bench_scaling.main([]),
        "shard_data_demo.main": lambda: shard_data_demo.main([]),
    }


def test_rank_starters_default_to_cuda():
    from ultra_pytorch_tpu_torch.run import __main__ as cli
    from ultra_pytorch_tpu_torch.run import dryrun, launch

    for fn in (launch.launch, dryrun.dryrun_multichip, dryrun.entry):
        assert inspect.signature(fn).parameters["device"].default is None
    assert cli.parse_args([]).device == "cuda"   # spawn_cli's args


@pytest.mark.parametrize("name", sorted(_starters()))
def test_rank_starters_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _starters()[name]()


def _bench_scripts():
    """The benchmark scripts, each called with its default device."""
    from ultra_pytorch_tpu_torch import bench
    from ultra_pytorch_tpu_torch.tools import bench_exp, bench_kernels

    return {"bench.main": bench.main, "bench_exp.main": bench_exp.main,
            "bench_kernels.main": bench_kernels.main}


@pytest.mark.parametrize("name", sorted(_bench_scripts()))
def test_bench_scripts_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _bench_scripts()[name]([])
