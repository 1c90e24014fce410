"""Name-by-name parity of the port with the JAX package.

An AST walk of every module of ``ultra_pytorch_tpu/``: each public
top-level name (function, class, constant) and each public method of a
public class must have a counterpart of the same name in the port's
module at the same relative path (``ops/pallas`` is ``ops/kernels``
there), defined in the port (a method may come from a port base class),
or a row of ``COUNTERPARTS`` that names the port's counterpart or the
idiom that replaces it. Every file of the JAX side's ``tools/`` must have
a port module of the same name under ``ultra_pytorch_tpu_torch/tools/``
or a row of ``TOOLS`` that names the port file doing its job or the
ROADMAP item it waits for. A name or a tool that the JAX package gains
and the port lacks fails here; so does a row that is no longer needed.
"""

import ast
import importlib
import inspect
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "ultra_pytorch_tpu", "ultra_pytorch_tpu_torch"
RENAMED = {"ops/pallas": "ops/kernels"}

# "JAX module path:name" -> (the port's counterpart as "module path:name",
# or None where an idiom replaces it, and how).
COUNTERPARTS = {
    # A step updates the state in place (CUDA graphs replay into it).
    "algorithms/base.py:BaseAlgorithm.apply_updates": (
        "algorithms/base.py:BaseAlgorithm.apply_gradients",
        "the optimizer step, in place"),
    "algorithms/base.py:adagrad_torch": (
        "algorithms/base.py:adagrad_torch_", "torch-exact Adagrad, in place"),
    # Keys split from a PRNG key become a generator handed down.
    "algorithms/base.py:BaseAlgorithm.dropout_rng": (
        "algorithms/base.py:BaseAlgorithm.score_with_params",
        "the step's generator goes to the ranker's dropout"),
    "algorithms/base.py:BaseAlgorithm.per_shard_rng": (
        "algorithms/base.py:BaseAlgorithm.per_shard",
        "this rank's generator under data parallelism"),
    "input_layer/feeds.py:BaseInputFeed.preprocess_data": (
        None, "a no-op hook in the JAX package too: the port's loaders "
              "prepare the data (data/dataset.py read_data)"),
    # init/apply pairs become nn.Module.
    "models/base.py:BaseRanker.init": (
        "models/base.py:BaseRanker.reset_parameters",
        "weights drawn at construction, redrawn from a generator"),
    "models/base.py:BaseRanker.apply": (
        "models/base.py:BaseRanker.forward", "nn.Module's forward"),
    "models/dnn.py:DNN.init": ("models/dnn.py:DNN.reset_parameters",
                               "nn.Module construction"),
    "models/dnn.py:DNN.apply": ("models/dnn.py:DNN.forward", "nn.Module"),
    "models/linear.py:Linear.init": (
        "models/linear.py:Linear.reset_parameters", "nn.Module construction"),
    "models/linear.py:Linear.apply": ("models/linear.py:Linear.forward",
                                      "nn.Module"),
    "models/setrank.py:SetRank.init": (
        "models/setrank.py:SetRank.reset_parameters",
        "nn.Module construction"),
    "models/setrank.py:SetRank.apply": ("models/setrank.py:SetRank.forward",
                                        "nn.Module"),
    "models/dlcm.py:DLCM.init": ("models/dlcm.py:DLCM.reset_parameters",
                                 "nn.Module construction"),
    "models/dlcm.py:DLCM.apply": ("models/dlcm.py:DLCM.forward", "nn.Module"),
    "models/gsf.py:GSF.init": ("models/gsf.py:GSF.reset_parameters",
                               "nn.Module construction"),
    "models/gsf.py:GSF.apply": ("models/gsf.py:GSF.forward", "nn.Module"),
    "models/base.py:Params": (
        "models/base.py:BaseRanker",
        "the params pytree is the module's parameters"),
    "models/base.py:linear_init": ("models/base.py:linear_init_",
                                   "torch's Linear init, in place"),
    "models/base.py:layer_norm_init": (
        "models/base.py:LayerNorm", "nn.Module with scale and bias"),
    "models/base.py:apply_linear": (
        None, "nn.Linear (models/dnn.py _linear with a compute dtype)"),
    "models/base.py:apply_layer_norm": ("models/base.py:LayerNorm.forward",
                                        "nn.Module"),
    "models/base.py:perturb": ("models/base.py:perturb_",
                               "params + rate * noise, written in place"),
    "sim/click_models.py:ClickModelParams.kind": (
        "sim/click_models.py:ClickModelParams.model_name",
        "the field the JAX property returns"),
    # Pallas launchers become the CUDA kernels' wrappers.
    "ops/pallas/click_sim.py:pallas_sample_pbm_clicks": (
        "ops/kernels/click_sim.py:sample_pbm_clicks", "K5 on a CUDA tensor"),
    "ops/pallas/mlp.py:TILE_N": (
        "ops/kernels/mlp.py:rows_per_block", "K1/K2's tile, chosen a shape"),
    "ops/pallas/mlp.py:pallas_mlp_available": (
        None, "no availability gate: a wrapper launches its kernel on a "
              "CUDA tensor or raises, and runs the plain version on a CPU "
              "one"),
    # A mesh of devices becomes a process group, one process a device.
    "parallel/mesh.py:DATA_AXIS": (
        "parallel/mesh.py:init_data_parallel",
        "the process group takes the mesh axis' place"),
    "parallel/mesh.py:make_mesh": ("parallel/mesh.py:init_data_parallel",
                                   "one process a device"),
    "parallel/mesh.py:make_dp_train_step": (
        "parallel/mesh.py:dp_train_steps",
        "eager; as one CUDA graph: run/window.WindowGraphs(sync=)"),
    "parallel/mesh.py:batch_sharding": (
        None, "each rank draws B / N queries (input_layer/feeds.py "
              "BaseInputFeed world_size)"),
    "parallel/mesh.py:replicated_sharding": (
        None, "every rank holds the whole state; the gradient is "
              "all-reduced (parallel/mesh.py all_reduce_mean)"),
    "parallel/mesh.py:shard_dataset": (
        None, "every rank holds the whole split (run/experiment.py "
              "Experiment.setup)"),
    "parallel/mesh.py:device_sharded_dataset": (
        "parallel/mesh.py:shard_queries_for_host",
        "--shard_data: a rank keeps its stripe"),
    "parallel/mesh.py:host_stacked_dataset": (
        "parallel/mesh.py:shard_queries_for_host",
        "a process keeps its stripe (ULTRA_COORDINATOR)"),
}

# JAX tools/ file -> (the port file that does its job, or a ROADMAP item
# "item N"), why.
TOOLS = {
    "bench_exp.py": ("ultra_pytorch_tpu_torch/tools/roofline.py",
                     "queries/s of graph windows at --chunk, --batch, "
                     "--features, --list-size; the bench itself is item 11"),
    "bench_pallas.py": ("torch_mlp_probe.py", "K1/K2 (torch_loss_probe.py "
                        "K3/K4) against their plain versions"),
    "bench_scaling.py": ("item 17", "scaling needs more than one card"),
    "shard_data_demo.py": ("item 17", "sharded data across cards"),
    "serve.py": ("ultra_pytorch_tpu_torch/serve/__main__.py",
                 "python -m ultra_pytorch_tpu_torch.serve"),
    "run_multihost.py": ("ultra_pytorch_tpu_torch/run/launch.py",
                         "python -m ultra_pytorch_tpu_torch.run.launch"),
    "gen_parameter_readmes.py": (
        "ultra_pytorch_tpu_torch/tools/gen_docs.py",
        "its READMEs are keyed by hparam names the port shares unchanged; "
        "docs/torch_algorithms.md carries the port's default tables"),
    "make_toy_data.py": (
        "ultra_pytorch_tpu_torch/tools/bench_common.py",
        "numpy only: its files load in either package; the port's own "
        "generators are bench_common.synthetic and torch_convergence.py"),
}
# Tools that drive the upstream ULTRA_pytorch toolbox (not in this repo),
# not the JAX package: torch_convergence.py holds the port to JAX.
for _name in ("bench_reference.py", "compare_convergence.py",
              "gen_reference_goldens.py", "replay_dla.py", "replay_ipw.py",
              "replay_prs.py"):
    TOOLS[_name] = ("torch_convergence.py",
                    "the JAX tool drives the upstream reference toolbox")
# The JAX rounds' run queues (TPU and reference runs behind BASELINE.md):
# the port's runs on the card are chip_smoke.py's phases and the tools.
for _name in ("run_r3_ours_queue.sh", "run_r3_queue2.sh",
              "run_r3_ref_queue.sh", "run_r3_tpu_bench.sh",
              "run_r4_cpu_queue2.sh", "run_r4_extra_seeds.sh",
              "run_r4_ours_queue.sh", "run_r4_ref_queue.sh",
              "run_r5_extra_seeds.sh", "run_r5_ours_queue.sh",
              "run_r5_ref_queue.sh", "run_r5_ref_rerun.sh"):
    TOOLS[_name] = ("chip_smoke.py", "a queue of measurement runs")


def _public_names(path):
    """Public top-level functions, classes and assigned names of a module,
    and ``Class.method`` for the public methods of its public classes."""
    with open(path) as fin:
        tree = ast.parse(fin.read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                        and not sub.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out += [n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name) and not n.id.startswith("_")]
    return out


def _jax_modules():
    base = os.path.join(ROOT, JAX_PKG)
    for dirpath, _, names in os.walk(base):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, name), base)


def _port_path(rel):
    for old, new in RENAMED.items():
        if rel.startswith(old + "/"):
            return new + rel[len(old):]
    return rel


def _port_module(rel):
    dotted = rel[:-3].replace("/", ".")
    dotted = dotted[: -len(".__init__")] if dotted.endswith(
        "__init__") else dotted
    return importlib.import_module(f"{PORT_PKG}.{dotted}".rstrip("."))


def _in_port(rel, name):
    """Whether the port's module at `rel` (a port path) defines `name`
    (``Class.method``: on the class or a port base class)."""
    module = _port_module(rel)
    head, _, method = name.partition(".")
    obj = getattr(module, head, None)
    if obj is None:
        return False
    if ((inspect.isclass(obj) or inspect.isfunction(obj))
            and not obj.__module__.startswith(PORT_PKG)):
        return False     # a name imported from torch, numpy, ...
    if not method:
        return True
    if inspect.isclass(obj):
        for klass in inspect.getmro(obj):
            if method in vars(klass) or method in getattr(
                    klass, "__dataclass_fields__", {}):
                return klass.__module__.startswith(PORT_PKG)
        return False
    return hasattr(obj, method)


def _gaps():
    gaps = []
    for rel in _jax_modules():
        port_rel = _port_path(rel)
        assert os.path.isfile(os.path.join(ROOT, PORT_PKG, port_rel)), (
            f"no port module for {JAX_PKG}/{rel}")
        gaps += [f"{rel}:{name}" for name in _public_names(
            os.path.join(ROOT, JAX_PKG, rel)) if not _in_port(port_rel, name)]
    return gaps


def test_every_jax_module_has_a_port_module():
    modules = list(_jax_modules())
    assert len(modules) >= 45
    for rel in modules:
        assert os.path.isfile(os.path.join(ROOT, PORT_PKG, _port_path(rel))), rel


def test_every_public_name_has_a_counterpart():
    gaps = _gaps()
    missing = [g for g in gaps if g not in COUNTERPARTS]
    assert not missing, (
        "JAX names without a port counterpart of the same name or a row "
        f"in COUNTERPARTS: {missing}")
    stale = sorted(set(COUNTERPARTS) - set(gaps))
    assert not stale, f"rows no longer needed (or JAX names gone): {stale}"


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_counterpart_rows_name_what_exists(key):
    target, how = COUNTERPARTS[key]
    assert how
    rel, name = key.split(":")
    assert name in _public_names(os.path.join(ROOT, JAX_PKG, rel))
    if target is not None:
        port_rel, port_name = target.split(":")
        assert _in_port(port_rel, port_name), target


def test_the_slice_names_are_there():
    # ndcg, team_draft_interleave, PAD_LABEL and the logger, by name.
    for rel, name in (("metrics/ranking.py", "ndcg"),
                      ("sim/interleave.py", "team_draft_interleave"),
                      ("data/dataset.py", "PAD_LABEL"),
                      ("utils/logging_utils.py", "MetricLogger")):
        assert name in _public_names(os.path.join(ROOT, JAX_PKG, rel))
        assert _in_port(rel, name)
    from ultra_pytorch_tpu_torch.utils.logging_utils import MetricLogger

    logger = MetricLogger(None)
    assert logger.history == []
    assert "enable_tensorboard" in inspect.signature(
        MetricLogger).parameters


def test_every_jax_tool_has_a_counterpart():
    jax_tools = sorted(f for f in os.listdir(os.path.join(ROOT, "tools"))
                       if f.endswith((".py", ".sh")))
    port_dir = os.path.join(ROOT, PORT_PKG, "tools")
    ported = {f for f in os.listdir(port_dir) if f.endswith(".py")}
    missing = [f for f in jax_tools if f not in ported and f not in TOOLS]
    assert not missing, f"JAX tools without a port counterpart: {missing}"
    stale = sorted(f for f in TOOLS if f not in jax_tools or f in ported)
    assert not stale, f"TOOLS rows no longer needed: {stale}"
    for name in ("bench_common.py", "profile_step.py", "roofline.py",
                 "bench_serve.py", "bench_serve_http.py", "bench_eval.py",
                 "gen_docs.py"):
        assert name in jax_tools and name in ported, name


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_rows_name_what_exists(name):
    target, why = TOOLS[name]
    assert why
    item = re.fullmatch(r"item (\d+)", target)
    if item:
        with open(os.path.join(ROOT, "ROADMAP.md")) as fin:
            assert re.search(rf"^- \*\*{item.group(1)}\. ", fin.read(),
                             re.M), target
    else:
        assert os.path.isfile(os.path.join(ROOT, target)), target


def test_the_walk_sees_names_of_every_kind():
    names = _public_names(os.path.join(ROOT, JAX_PKG, "data", "dataset.py"))
    assert "PAD_LABEL" in names and "RankingDataset" in names
    assert "RankingDataset.pad" in names
    assert not any(n.startswith("_") or "._" in n for n in names)
    # A method of the same name on a class outside the port is no match:
    # nn.Module.apply is not the JAX ranker's apply.
    assert not _in_port("models/dnn.py", "DNN.apply")
    assert _in_port("algorithms/dla.py", "DLA.train_step")   # inherited
