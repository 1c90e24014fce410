"""The port's serving buckets against the JAX scorer's, on the CPU.

Each (batch, list) bucket is one program: the JAX ``Scorer._ranked_fn``
jits it, the port's captures it as a CUDA graph on the card and runs the
same body eagerly here, over static buffers that the staging reuses from
call to call. So a request that follows a larger one must see zeros where
the larger one wrote: JAX pads with zeros, and GSF ignores the mask, so
its scores read the padded positions (with the zeroing left out, GSF's
case here fails).

* Each of the five rankers loads one checkpoint (a JAX train state with
  its weights moved off their init) in both scorers, which agree on
  scores (within 1e-5) and orders over requests that shrink inside one
  bucket, then grow into the next and shrink into a smaller one.
* The staging leaves nothing outside the current request; ``warmup``
  sizes the buffers for the largest bucket and makes each bucket's
  program once; a request past the buffers grows them; concurrent
  callers get what sequential ones get.

The graphs themselves need the card:
``tests/test_torch_serve_buckets_gpu.py``.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference here
pytest.importorskip("flax")        # its algorithms need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu.serve import Scorer as JaxScorer  # noqa: E402
from ultra_pytorch_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from ultra_pytorch_tpu_torch.serve import Scorer  # noqa: E402

F = 12
# Scores of the same weights in two packages: float32 sums in another
# order, as tests/test_torch_rankers.py holds the rankers.
TOL = 1e-5
RANKERS = {
    "DNN": "hidden_layer_sizes=[16, 8]",
    "Linear": "",
    "GSF": "group_size=3,hidden_layer_sizes=[16, 8]",
    "DLCM": "embed_size=8,hidden_size=6",
    "SetRank": "d_model=16,num_heads=4,num_layers=2,diff=8",
}
# (queries, documents): four requests that shrink inside bucket (8, 16),
# one that grows into (16, 32), one in (8, 8), one back in (8, 16).
REQUESTS = ((8, 16), (6, 13), (3, 10), (1, 9), (12, 20), (2, 5), (5, 11))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.2 * rng.normal(size=np.shape(a))
                   ).astype(np.float32), params)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """One JAX checkpoint a ranker, laid out as the JAX trainer saves
    one: (train state, data key) with the serve metadata."""
    dirs = {}
    for i, (name, hparams) in enumerate(RANKERS.items()):
        settings = {"ranking_model": name, "ranking_model_hparams": hparams,
                    "learning_algorithm": "NaiveAlgorithm",
                    "learning_algorithm_hparams": "",
                    "max_candidate_num": 32, "selection_bias_cutoff": 32}
        alg = jax_create_algorithm(settings, F, 1.0)
        state = alg.init_state(jax.random.PRNGKey(i), F)
        state = state.replace(params=_perturbed(state.params, i))
        out = tmp_path_factory.mktemp(f"serve_{name}")
        jax_ckpt.save_checkpoint(
            str(out / "NaiveAlgorithm.ckpt"),
            (state, np.zeros(2, np.uint32)),
            {"serve": {"exp_settings": settings, "feature_size": F,
                       "max_label": 1.0}})
        dirs[name] = str(out)
    return dirs


def _request(q, length, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(q, length, F)).astype(np.float32)
    n_valid = rng.integers(1, length + 1, size=q).astype(np.int32)
    n_valid[0] = length
    return feats, n_valid


@pytest.mark.parametrize("name", list(RANKERS))
def test_buckets_agree_with_the_jax_scorer(model_dirs, name):
    ours = Scorer.from_checkpoint(model_dirs[name], device="cpu")
    theirs = JaxScorer.from_checkpoint(model_dirs[name])
    assert type(ours.ranker).__name__ == name
    for i, (q, length) in enumerate(REQUESTS):
        feats, n_valid = _request(q, length, seed=10 * i)
        s_ours, o_ours = ours._score_ranked(feats, n_valid)
        s_theirs, o_theirs = theirs._score_ranked(feats, n_valid)
        assert s_ours.shape == (q, length) and o_ours.shape == (q, length)
        np.testing.assert_allclose(s_ours, s_theirs, rtol=TOL, atol=TOL,
                                   err_msg=f"request {q}x{length}")
        np.testing.assert_array_equal(o_ours, o_theirs,
                                      err_msg=f"request {q}x{length}")
    assert ours.bucket_calls == {(8, 16): 5, (16, 32): 1, (8, 8): 1}


def _reference(scorer, feats, n_valid):
    """The request scored on a freshly zero-padded bucket, apart from the
    scorer's buffers."""
    q, length, _ = feats.shape
    bq, bl = max(8, 1 << (q - 1).bit_length()), max(
        8, 1 << (length - 1).bit_length())
    x = np.zeros((bq, bl, F), np.float32)
    x[:q, :length] = feats
    n = np.zeros(bq, np.int64)
    n[:q] = n_valid
    mask = torch.arange(bl)[None, :] < torch.from_numpy(n)[:, None]
    with torch.inference_mode():
        scores = scorer.ranker(torch.from_numpy(x), mask)
        masked = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return masked[:q, :length].numpy()


def test_staging_leaves_nothing_of_an_earlier_request(model_dirs):
    scorer = Scorer.from_checkpoint(model_dirs["GSF"], device="cpu")
    scorer.warmup(16, 32)
    x_before = scorer._x
    for i, (q, length) in enumerate(REQUESTS):
        feats, n_valid = _request(q, length, seed=i)
        got = scorer.score(feats, n_valid)
        np.testing.assert_array_equal(got, _reference(scorer, feats,
                                                      n_valid))
        bq, bl, q0, l0 = scorer._last
        assert (q0, l0) == (q, length)
        host = scorer._x_host.numpy().reshape(-1)
        view = host[:bq * bl * F].reshape(bq, bl, F)
        np.testing.assert_array_equal(view[:q, :length], feats)
        outside = view.copy()
        outside[:q, :length] = 0.0
        assert not outside.any() and not host[bq * bl * F:].any()
        np.testing.assert_array_equal(scorer._x.numpy()[:bq * bl * F],
                                      host[:bq * bl * F])
    assert scorer._x is x_before   # warmed to the largest bucket


def test_warmup_makes_every_bucket_once(model_dirs):
    scorer = Scorer.from_checkpoint(model_dirs["DNN"], device="cpu")
    scorer.warmup(32, 20)
    buckets = {(b, li) for b in (8, 16, 32) for li in (8, 16, 32)}
    assert scorer._rows == 32 * 32
    assert set(scorer._ranked) == buckets
    assert scorer.bucket_calls == dict.fromkeys(buckets, 1)
    ranked = dict(scorer._ranked)
    scorer.score(*_request(20, 30, seed=1))
    assert scorer._ranked == ranked   # made once, then reused


def test_a_request_past_the_buffers_grows_them(model_dirs):
    scorer = Scorer.from_checkpoint(model_dirs["SetRank"], device="cpu")
    small = _request(3, 7, seed=2)
    want = scorer.score(*small)
    assert scorer._rows == 8 * 8
    big = _request(20, 40, seed=3)
    got = scorer.score(*big)
    assert scorer._rows == 32 * 64 and set(scorer._ranked) == {(32, 64)}
    np.testing.assert_array_equal(got, _reference(scorer, *big))
    np.testing.assert_array_equal(scorer.score(*small), want)


def test_concurrent_callers_get_what_sequential_ones_get(model_dirs):
    """More threads than cores, switching often: every caller gets what a
    sequential call gets, and no call is lost from ``bucket_calls``."""
    scorer = Scorer.from_checkpoint(model_dirs["DNN"], device="cpu")
    workers = (os.cpu_count() or 1) + 2
    requests = [_request(q, length, seed=20 + i) for i, (q, length) in
                enumerate(REQUESTS * (1 + workers // len(REQUESTS)))]
    want = [scorer._score_ranked(*r) for r in requests]
    scorer.bucket_calls.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(workers) as pool:
            futures = [pool.submit(scorer._score_ranked, *r)
                       for r in requests]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for (s_got, o_got), (s_want, o_want) in zip(got, want):
        np.testing.assert_array_equal(s_got, s_want)
        np.testing.assert_array_equal(o_got, o_want)
    assert sum(scorer.bucket_calls.values()) == len(requests)


def test_graphs_need_a_cuda_device(model_dirs):
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        Scorer.from_checkpoint(model_dirs["Linear"], device="cpu",
                               graphs=True)
    assert not Scorer.from_checkpoint(model_dirs["Linear"],
                                      device="cpu").graphs
