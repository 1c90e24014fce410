"""Serving buckets as replayed CUDA graphs on the card (``serve/scorer.py``).

For each of the five rankers (the DNN through K1) every bucket up to
64x64, and a sequence of requests that shrink inside one bucket, the
graph ``Scorer`` gives the scores (within TOL) and the orders of the same
body run eagerly (``graphs=False``); K1 is counted once a replayed call.

These need a CUDA device and skip without one. The file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.serve import Scorer
from ultra_pytorch_tpu_torch.utils import spans
from ultra_pytorch_tpu_torch.utils.registry import find_class

pytestmark = pytest.mark.gpu

F = 24
# Graph and eager bodies launch the same kernels on the same inputs; the
# tolerance is K1's against its plain version, for a library that picks
# another algorithm under capture.
TOL = 2e-4
RANKERS = {
    "DNN": "hidden_layer_sizes=[32, 16],use_pallas=true",
    "Linear": "",
    "GSF": "group_size=3,hidden_layer_sizes=[16, 8]",
    "DLCM": "embed_size=8,hidden_size=6",
    "SetRank": "d_model=16,num_heads=4,num_layers=2,diff=8",
}
SHRINKING = ((32, 64), (30, 60), (17, 33), (20, 40))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs exist only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scorers(name, dev):
    ranker = find_class(name, kind="ranker")(
        RANKERS[name], F, generator=torch.Generator().manual_seed(3))
    return (Scorer(ranker, F, device=dev),
            Scorer(ranker, F, device=dev, graphs=False))


def _request(q, length, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(q, length, F)).astype(np.float32)
    n_valid = rng.integers(1, length + 1, size=q).astype(np.int32)
    n_valid[0] = length
    return feats, n_valid


@pytest.mark.parametrize("name", list(RANKERS))
def test_every_bucket_replay_equals_its_eager_body(cuda, name):
    graph, eager = _scorers(name, cuda)
    assert graph.graphs and not eager.graphs
    graph.warmup(64, 64)
    buckets = [(b, li) for b in (8, 16, 32, 64) for li in (8, 16, 32, 64)]
    assert sorted(graph._ranked) == sorted(buckets)
    requests = [(b, li) for b, li in buckets] + list(SHRINKING)
    before = spans.counters()["launches.K1"]
    for i, (q, length) in enumerate(requests):
        feats, n_valid = _request(q, length, seed=i)
        s_graph, o_graph = graph._score_ranked(feats, n_valid)
        s_eager, o_eager = eager._score_ranked(feats, n_valid)
        np.testing.assert_allclose(s_graph, s_eager, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {q}x{length}")
        np.testing.assert_array_equal(o_graph, o_eager,
                                      err_msg=f"{name} {q}x{length}")
    calls = 2 * len(requests)   # each request once each way
    want = calls if name == "DNN" else 0
    assert spans.counters()["launches.K1"] - before == want
