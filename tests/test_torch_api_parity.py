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
ROADMAP item it waits for; so must every script at the root of the JAX
system (``ROOT_SCRIPTS``), and the dry run's case table in
``__graft_entry__.py`` is the port's ``run/dryrun.py`` table, read by
AST. A name or a tool that the JAX package gains and the port lacks
fails here; so does a row that is no longer needed. Flag by flag, every
``add_argument`` flag of a JAX tool or root script that has a port
counterpart (a port tool of the same name, or the port file its row in
``TOOLS`` or ``ROOT_SCRIPTS`` names) is a flag of that counterpart under
the same spelling, or a row of ``FLAG_DIFFERENCES`` says why not.
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
    "bench_pallas.py": ("ultra_pytorch_tpu_torch/tools/bench_kernels.py",
                        "part 3, the kernels on and off end to end; parts "
                        "1-2 are chip_smoke.py phases 3, 5 and 9, "
                        "torch_mlp_probe.py and torch_loss_probe.py"),
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
# The JAX system's root scripts -> (the port file that does its job, or a
# ROADMAP item "item N"), why. The port's own root scripts are
# chip_smoke.py and torch_*.py.
ROOT_SCRIPTS = {
    "main.py": ("ultra_pytorch_tpu_torch/run/__main__.py",
                "python -m ultra_pytorch_tpu_torch.run"),
    "bench.py": ("ultra_pytorch_tpu_torch/bench.py",
                 "python -m ultra_pytorch_tpu_torch.bench"),
    "__graft_entry__.py": ("ultra_pytorch_tpu_torch/run/dryrun.py",
                           "entry and dryrun_multichip"),
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


# "JAX script:flag" -> why the port's counterpart has no flag of that
# spelling. A row whose flag the port has, or the JAX script lost, fails.
FLAG_DIFFERENCES = {}
for _flag in ("--micro", "--parts"):
    FLAG_DIFFERENCES[f"bench_pallas.py:{_flag}"] = (
        "parts 1-2 of the JAX script (the kernels against their reference "
        "and their timing) are chip_smoke.py phases 3, 5 and 9, "
        "torch_mlp_probe.py and torch_loss_probe.py; bench_kernels is its "
        "part 3 alone")
for _flag, _how in (("--data_dir", "--data_dir"), ("--batch", "--batch_size"),
                    ("--iters", "--max_train_iteration"),
                    ("--steps_per_checkpoint", "--steps_per_checkpoint"),
                    ("--model_dir", "--model_dir"),
                    ("--algo", "--setting_file")):
    FLAG_DIFFERENCES[f"run_multihost.py:{_flag}"] = (
        f"the launcher passes the training CLI's own flags after '--': "
        f"{_how} there")
FLAG_DIFFERENCES["run_multihost.py:--devices_per_proc"] = (
    "one process a device: --processes is the device count")
for _flag in ("--queries", "--valid_queries", "--features", "--max_label",
              "--min_docs", "--max_docs", "--seed", "--libsvm"):
    FLAG_DIFFERENCES[f"make_toy_data.py:{_flag}"] = (
        "numpy only: the JAX script runs as it is and its files load in "
        "either package; bench_common.synthetic is the port's generator, "
        "not a script")


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
                 "gen_docs.py", "bench_exp.py"):
        assert name in jax_tools and name in ported, name


def _names_what_exists(target, why):
    assert why
    item = re.fullmatch(r"item (\d+)", target)
    if item:
        with open(os.path.join(ROOT, "ROADMAP.md")) as fin:
            assert re.search(rf"^- \*\*{item.group(1)}\. ", fin.read(),
                             re.M), target
    else:
        assert os.path.isfile(os.path.join(ROOT, target)), target


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_rows_name_what_exists(name):
    _names_what_exists(*TOOLS[name])


def test_every_jax_root_script_has_a_counterpart():
    scripts = sorted(f for f in os.listdir(ROOT) if f.endswith(".py")
                     and f != "chip_smoke.py" and not f.startswith("torch_"))
    assert scripts == sorted(ROOT_SCRIPTS)


@pytest.mark.parametrize("name", sorted(ROOT_SCRIPTS))
def test_root_script_rows_name_what_exists(name):
    _names_what_exists(*ROOT_SCRIPTS[name])


def test_the_graft_entry_points_are_there():
    names = _public_names(os.path.join(ROOT, "__graft_entry__.py"))
    assert names == ["entry", "dryrun_multichip"]
    from ultra_pytorch_tpu_torch.run import dryrun

    for name in names:
        assert inspect.isfunction(getattr(dryrun, name)), name
        assert getattr(dryrun, name).__module__ == dryrun.__name__


def _jax_dryrun_body():
    with open(os.path.join(ROOT, "__graft_entry__.py")) as fin:
        tree = ast.parse(fin.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip")
    return list(ast.walk(fn))


def _assigned(node):
    return {t.id for t in ast.walk(node) if isinstance(t, ast.Name)
            and isinstance(t.ctx, ast.Store)}


def test_the_dry_run_cases_are_the_jax_ones():
    """``__graft_entry__.py``'s own statements that build its case table
    (``offline``, ``online``, ``dnn``, ``cases``) and name each case
    (``tag``, ``label``), run on placeholder hparam strings: the same
    cases in the same order as ``run/dryrun.py``, named alike."""
    from ultra_pytorch_tpu_torch.run import dryrun

    nodes = _jax_dryrun_body()
    table = [n for n in nodes if isinstance(n, ast.Assign)
             and _assigned(n) & {"offline", "online", "dnn", "cases"}]
    assert len(table) == 4
    ns = {"est_hp": "EST", "cm_hp": "CM"}
    exec(compile(ast.Module(body=table, type_ignores=[]), "<jax cases>",
                 "exec"), ns)
    port = dryrun.cases("EST", "CM")
    assert ns["cases"] == port and len(port) == 18

    loop = next(n for n in nodes if isinstance(n, ast.For)
                and _assigned(n.target) >= {"algo", "ranker_hp"})
    naming = [n for n in loop.body if isinstance(n, (ast.Assign, ast.If,
                                                     ast.AugAssign))
              and _assigned(n) and _assigned(n) <= {"tag", "label"}]
    assert len(naming) == 4
    code = compile(ast.Module(body=naming, type_ignores=[]), "<jax names>",
                   "exec")
    keys = ("algo", "feed_name", "algo_hparams", "host_stacked",
            "shard_data", "ranker", "ranker_hp")
    for case in port:
        names = dict(zip(keys, case))
        exec(code, names)
        assert dryrun.case_names(case) == (names["tag"], names["label"])


def test_the_walk_sees_names_of_every_kind():
    names = _public_names(os.path.join(ROOT, JAX_PKG, "data", "dataset.py"))
    assert "PAD_LABEL" in names and "RankingDataset" in names
    assert "RankingDataset.pad" in names
    assert not any(n.startswith("_") or "._" in n for n in names)
    # A method of the same name on a class outside the port is no match:
    # nn.Module.apply is not the JAX ranker's apply.
    assert not _in_port("models/dnn.py", "DNN.apply")
    assert _in_port("algorithms/dla.py", "DLA.train_step")   # inherited


# -- flag by flag -------------------------------------------------------------

def _flags(path):
    """The option strings of every ``add_argument`` call in a file (the
    flags, not the positional names)."""
    with open(path) as fin:
        tree = ast.parse(fin.read())
    return {a.value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)
            and isinstance(a.value, str) and a.value.startswith("-")}


def _port_flags(rel):
    """The flags of the port file `rel`, with the shared tool parser's
    (``bench_common.tool_parser``) where the file builds on it."""
    path = os.path.join(ROOT, rel)
    flags = _flags(path)
    with open(path) as fin:
        if "tool_parser(" in fin.read():
            flags |= _flags(os.path.join(ROOT, PORT_PKG, "tools",
                                         "bench_common.py"))
    return flags


def _flag_counterparts():
    """JAX script (a path from the root) -> its port counterpart's path,
    for every JAX tool and root script that has one in the port."""
    out = {}
    port_tools = os.path.join(PORT_PKG, "tools")
    for name in sorted(os.listdir(os.path.join(ROOT, "tools"))):
        if not name.endswith(".py"):
            continue
        if os.path.isfile(os.path.join(ROOT, port_tools, name)):
            out[f"tools/{name}"] = os.path.join(port_tools, name)
        elif name in TOOLS and TOOLS[name][0].startswith(PORT_PKG + "/"):
            out[f"tools/{name}"] = TOOLS[name][0]
    for name, (target, _) in ROOT_SCRIPTS.items():
        out[name] = target
    return out


def _flag_gaps():
    gaps = []
    for jax_rel, port_rel in _flag_counterparts().items():
        theirs = _flags(os.path.join(ROOT, jax_rel))
        ours = _port_flags(port_rel)
        gaps += [f"{os.path.basename(jax_rel)}:{flag}"
                 for flag in sorted(theirs - ours)]
    return gaps


def test_the_flag_walk_sees_the_tools():
    pairs = _flag_counterparts()
    for name in ("profile_step.py", "roofline.py", "bench_eval.py",
                 "bench_exp.py", "bench_serve.py", "bench_serve_http.py",
                 "shard_data_demo.py", "bench_pallas.py", "serve.py",
                 "run_multihost.py"):
        assert f"tools/{name}" in pairs, name
    assert pairs["main.py"] == "ultra_pytorch_tpu_torch/run/__main__.py"
    assert "--prng" in _flags(os.path.join(ROOT, "tools", "roofline.py"))
    assert "--device" in _port_flags(pairs["tools/roofline.py"])


def test_every_jax_flag_is_a_port_flag():
    gaps = _flag_gaps()
    missing = [g for g in gaps if g not in FLAG_DIFFERENCES]
    assert not missing, (
        "JAX flags without a port flag of the same spelling or a row in "
        f"FLAG_DIFFERENCES: {missing}")
    stale = sorted(set(FLAG_DIFFERENCES) - set(gaps))
    assert not stale, f"FLAG_DIFFERENCES rows no longer needed: {stale}"


@pytest.mark.parametrize("key", sorted(FLAG_DIFFERENCES))
def test_flag_difference_rows_name_a_jax_flag(key):
    script, flag = key.split(":")
    path = os.path.join(ROOT, "tools", script)
    assert os.path.isfile(path) and flag in _flags(path), key
    assert FLAG_DIFFERENCES[key]


@pytest.mark.parametrize("script,flags", [
    ("profile_step.py", ["--prng"]),
    ("roofline.py", ["--prng", "--ranker-extra"]),
    ("bench_eval.py", ["--train-qps"])])
def test_the_measurement_tools_take_the_jax_flags(script, flags):
    port = _port_flags(os.path.join(PORT_PKG, "tools", script))
    assert set(flags) <= _flags(os.path.join(ROOT, "tools", script))
    assert set(flags) <= port
    assert "--kernels" in port
