"""The port's settings grammar and registry against the JAX package's.

The same override strings go through the JAX ``HParams`` and the port's;
the results (or the errors) must be identical. The registry resolves the
names that checkpoints and ``configs/*.json`` carry, for every
algorithm and feed of the JAX package (the online family's included).
"""

import pytest
import torch

pytest.importorskip("jax")  # the JAX package is the reference here

from ultra_pytorch_tpu.utils.hparams import HParams as JaxHParams
from ultra_pytorch_tpu_torch.utils import registry
from ultra_pytorch_tpu_torch.utils.hparams import HParams


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# (defaults, override string) pairs: the tests/test_hparams.py cases plus
# the bracket lists the DNN settings use.
PARSE_CASES = [
    (dict(learning_rate=0.05, steps=10, name="adam", flag=False),
     "learning_rate=0.1,steps=20,name=sgd,flag=true"),
    (dict(hidden_layer_sizes=[512, 256, 128], taus=[0.1]),
     "hidden_layer_sizes=[64, 32],taus=[0.5,0.25]"),
    (dict(sizes=[1, 2, 3]), "sizes[1]=9"),
    (dict(sizes=[1, 2, 3]), "sizes[5]=7"),
    (dict(x=1.0), "x=2"),
    (dict(a=1, b="x"), ""),
    (dict(a=1, b="x"), "a=3,b=hello"),
    (dict(hidden_layer_sizes=[8], activation_func="elu", use_pallas=False),
     "hidden_layer_sizes=[512, 256, 128],activation_func=relu,"
     "use_pallas=true"),
    (dict(hidden_layer_sizes=[8], norm="layer"),
     "norm=none,hidden_layer_sizes=[16,8]"),
]

ERROR_CASES = [
    (dict(a=1), "b=2"),
    (dict(y=1), "y=2.5"),
    (dict(s=[1, 2]), "s=3"),
    (dict(a=1), "a=1,,"),
    (dict(flag=False), "flag=maybe"),
    (dict(a=1), "a[0]=2"),
]


@pytest.mark.parametrize("defaults,override", PARSE_CASES)
def test_parse_matches_jax(defaults, override):
    ours = HParams(**defaults).parse(override)
    theirs = JaxHParams(**defaults).parse(override)
    assert ours.values() == theirs.values()
    assert ours.to_json() == theirs.to_json()


@pytest.mark.parametrize("defaults,override", ERROR_CASES)
def test_errors_match_jax(defaults, override):
    with pytest.raises(ValueError):
        JaxHParams(**defaults).parse(override)
    with pytest.raises(ValueError):
        HParams(**defaults).parse(override)


def test_indexed_assignment_and_bracket_lists():
    hp = HParams(hidden_layer_sizes=[512, 256, 128], lr=0.1)
    hp.parse("hidden_layer_sizes=[64, 32, 16],lr=0.5")
    assert hp.hidden_layer_sizes == [64, 32, 16] and hp.lr == 0.5
    hp.parse("hidden_layer_sizes[1]=8")
    assert hp.hidden_layer_sizes == [64, 8, 16]


@pytest.mark.parametrize("name", ["DNN", "ultra.ranking_model.DNN",
                                  "ultra_pytorch_tpu_torch.models.DNN"])
def test_registry_resolves_dnn(name):
    from ultra_pytorch_tpu_torch.models.dnn import DNN

    assert registry.find_class(name, kind="ranker") is DNN
    assert registry.find_class(name) is DNN


def test_registry_lists_ported_rankers():
    assert registry.list_available("ranker") == [
        "DLCM", "DNN", "GSF", "Linear", "SetRank"]


@pytest.mark.parametrize("name", ["Linear", "SetRank", "DLCM", "GSF",
                                  "ultra.ranking_model.SetRank"])
def test_unported_ranker_raises(name):
    """The four rankers of the JAX package that were not ported before are
    now: each name resolves to the port's class, and none raises."""
    import importlib

    short = name.rsplit(".", 1)[-1]
    module = importlib.import_module(
        f"ultra_pytorch_tpu_torch.models.{short.lower()}")
    assert registry.find_class(name, kind="ranker") is getattr(module, short)
    assert registry.find_class(name) is getattr(module, short)


def test_unknown_component_raises():
    with pytest.raises(KeyError, match="Unknown component"):
        registry.find_class("NoSuchRanker", kind="ranker")


@pytest.mark.parametrize("kind,name,module,attr", [
    ("algorithm", "DLA", "algorithms.dla", "DLA"),
    ("algorithm", "ultra.learning_algorithm.DLA", "algorithms.dla", "DLA"),
    ("algorithm", "NaiveAlgorithm", "algorithms.naive", "NaiveAlgorithm"),
    ("algorithm", "ultra.learning_algorithm.NaiveAlgorithm",
     "algorithms.naive", "NaiveAlgorithm"),
    ("algorithm", "ultra.learning_algorithm.NavieAlgorithm",
     "algorithms.naive", "NaiveAlgorithm"),
    ("algorithm", "IPWrank", "algorithms.ipw", "IPWrank"),
    ("algorithm", "ultra.learning_algorithm.IPWrank", "algorithms.ipw",
     "IPWrank"),
    ("algorithm", "RegressionEM", "algorithms.regression_em",
     "RegressionEM"),
    ("algorithm", "ultra.learning_algorithm.RegressionEM",
     "algorithms.regression_em", "RegressionEM"),
    ("algorithm", "PairDebias", "algorithms.pairwise_debias", "PairDebias"),
    ("algorithm", "ultra.learning_algorithm.PairDebias",
     "algorithms.pairwise_debias", "PairDebias"),
    ("algorithm", "LambdaRank", "algorithms.lambda_rank", "LambdaRank"),
    ("algorithm", "ultra.learning_algorithm.LambdaRank",
     "algorithms.lambda_rank", "LambdaRank"),
    ("algorithm", "PRSrank", "algorithms.prs_rank", "PRSrank"),
    ("algorithm", "ultra.learning_algorithm.PRSrank", "algorithms.prs_rank",
     "PRSrank"),
    ("feed", "ClickSimulationFeed", "input_layer.feeds",
     "ClickSimulationFeed"),
    ("feed", "ultra.input_layer.ClickSimulationFeed", "input_layer.feeds",
     "ClickSimulationFeed"),
    ("feed", "ultra.input_layer.DirectLabelFeed", "input_layer.feeds",
     "DirectLabelFeed"),
    ("algorithm", "ultra.learning_algorithm.DBGD", "algorithms.dbgd",
     "DBGD"),
    ("algorithm", "NSGD", "algorithms.nsgd", "NSGD"),
    ("algorithm", "PDGD", "algorithms.pdgd", "PDGD"),
    ("feed", "ultra.input_layer.StochasticOnlineSimulationFeed",
     "input_layer.feeds", "StochasticOnlineSimulationFeed"),
    ("feed", "DeterministicOnlineSimulationFeed", "input_layer.feeds",
     "DeterministicOnlineSimulationFeed"),
    ("algorithm", "ultra.learning_algorithm.MGD", "algorithms.mgd", "MGD"),
])
def test_registry_resolves_training_components(kind, name, module, attr):
    import importlib

    want = getattr(importlib.import_module(
        f"ultra_pytorch_tpu_torch.{module}"), attr)
    assert registry.find_class(name, kind=kind) is want

