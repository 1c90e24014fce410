"""The port's serving path against the JAX package's, on the CPU.

A JAX DLA/DNN trains a few steps on toy data and saves a checkpoint, as in
tests/test_serving.py. The port's ``Scorer`` loads that checkpoint with no
settings file and must reproduce the JAX ``Scorer`` (plain and Pallas in
interpret mode): scores within 1e-5, rankings equal, directly, through
the ``MicroBatcher`` and over HTTP. Checkpoints also cross both ways.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here

from ultra_pytorch_tpu.models.dnn import DNN as JaxDNN
from ultra_pytorch_tpu.serve import Scorer as JaxScorer
from ultra_pytorch_tpu.serve import make_server as jax_make_server
from ultra_pytorch_tpu.utils import checkpoint as jax_ckpt
from ultra_pytorch_tpu_torch.models.dnn import (
    DNN, params_from_jax, params_to_jax)
from ultra_pytorch_tpu_torch.serve import MicroBatcher, Scorer, make_server
from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """Train the JAX DLA/DNN a few steps on toy data and save a checkpoint."""
    from tools.make_toy_data import main as make_main
    from ultra_pytorch_tpu.run.experiment import Experiment

    data_dir = tmp_path_factory.mktemp("torchservedata")
    make_main([str(data_dir), "--queries", "24", "--features", "64"])
    out = tmp_path_factory.mktemp("torchservemodel")
    settings = {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": "",
        "valid_input_feed": "DirectLabelFeed",
        "valid_input_hparams": "",
        "ranking_model": "DNN",
        "ranking_model_hparams": "hidden_layer_sizes=[16,8]",
        "learning_algorithm": "DLA",
        "learning_algorithm_hparams": "",
        "metrics": ["ndcg"],
        "metrics_topn": [5],
        "objective_metric": "ndcg_5",
        "selection_bias_cutoff": 5,
    }
    exp = Experiment(settings, str(data_dir), str(out), batch_size=8,
                     seed=0, dp=0)
    exp.setup(splits=("train", "valid"))
    exp.init_state()
    exp.train_steps(4)
    exp.save({"step": 4})
    return str(out)


@pytest.fixture(scope="module")
def scorer(model_dir):
    # Metadata-only load: no settings file, no feature_size argument.
    return Scorer.from_checkpoint(model_dir, device="cpu")


@pytest.fixture(scope="module")
def jax_scorer(model_dir):
    return JaxScorer.from_checkpoint(model_dir, use_pallas=False)


def _lists(f, seed=0, q=3, length=7):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(q, length, f)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel-path"])
def test_jax_checkpoint_scores_match_jax_scorer(model_dir, use_pallas):
    """Both the port's plain DNN path and its K1 path (the plain version on
    CPU tensors) reproduce the JAX scorer, plain and Pallas interpret."""
    ours = Scorer.from_checkpoint(model_dir, use_pallas=use_pallas,
                                  device="cpu")
    theirs = JaxScorer.from_checkpoint(model_dir, use_pallas=use_pallas)
    assert ours.feature_size == theirs.feature_size == 64
    assert ours.ranker.hparams.use_pallas is use_pallas
    feats = _lists(ours.feature_size)
    n_valid = [7, 3, 5]
    s_ours, o_ours = ours._score_ranked(feats, n_valid)
    s_theirs, o_theirs = theirs._score_ranked(feats, n_valid)
    np.testing.assert_allclose(s_ours, s_theirs, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(o_ours, o_theirs)


def test_loaded_weights_equal_the_checkpoint(model_dir, scorer, jax_scorer):
    want = jax.tree_util.tree_leaves(jax_scorer.params)
    got = ckpt.tree_leaves(params_to_jax(scorer.ranker))
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_bucket_padding_invariance(scorer):
    """The same query scored alone, in a big batch, and under a larger
    list bucket gives identical scores (padding never leaks)."""
    rng = np.random.default_rng(0)
    f = scorer.feature_size
    one = rng.normal(size=(1, 5, f)).astype(np.float32)
    alone = scorer.score(one, [5])
    big = np.concatenate([one] + [rng.normal(size=(1, 5, f)).astype(
        np.float32) for _ in range(20)], axis=0)  # batch bucket 32
    in_batch = scorer.score(big, [5] * 21)
    np.testing.assert_allclose(in_batch[0], alone[0], rtol=1e-5, atol=1e-6)
    wide = np.zeros((1, 17, f), np.float32)  # list bucket 32
    wide[:, :5] = one
    in_wide = scorer.score(wide, [5])
    np.testing.assert_allclose(in_wide[0, :5], alone[0, :5],
                               rtol=1e-5, atol=1e-6)
    assert (in_wide[0, 5:] < -1e29).all(), "masked positions not -inf"


def test_rank_ragged_lists(scorer):
    """rank() orders by score desc and keeps invalid docs at the tail."""
    feats = _lists(scorer.feature_size, seed=1)
    n_valid = [7, 3, 5]
    scores = scorer.score(feats, n_valid)
    order = scorer.rank(feats, n_valid)
    for i, n in enumerate(n_valid):
        row = order[i]
        assert sorted(row.tolist()) == list(range(7))
        assert (np.diff(scores[i, row[:n]]) <= 1e-6).all(), "not sorted"
        assert set(row[:n].tolist()) == set(range(n)), \
            "invalid docs ranked above valid ones"


def test_per_bucket_record(scorer):
    """Requests within one bucket land in one bucket record."""
    f = scorer.feature_size
    scorer.bucket_calls.clear()
    for q, li in [(2, 5), (5, 7), (8, 8), (3, 6)]:
        scorer.score(np.zeros((q, li, f), np.float32))
    assert scorer.bucket_calls == {(8, 8): 4}
    scorer.score(np.zeros((9, 9, f), np.float32))
    assert scorer.bucket_calls[(16, 16)] == 1


def test_use_pallas_needs_the_dnn(tmp_path):
    """A Linear checkpoint (written by JAX, with its serve metadata) serves
    through the generic bridge and scores as the JAX Linear does; forcing
    K1 for it still raises."""
    from ultra_pytorch_tpu.models.linear import Linear as JaxLinear
    from ultra_pytorch_tpu_torch.models.linear import Linear

    jax_linear = JaxLinear("", 12)
    params = jax_linear.init(jax.random.PRNGKey(2), 12)
    jax_ckpt.save_checkpoint(
        str(tmp_path / "NaiveAlgorithm.ckpt"),
        (params, {"extra": np.zeros(3)}),
        metadata={"serve": {"feature_size": 12, "exp_settings": {
            "ranking_model": "ultra.ranking_model.Linear",
            "ranking_model_hparams": ""}}})
    linear = Scorer.from_checkpoint(str(tmp_path), device="cpu")
    assert isinstance(linear.ranker, Linear)
    feats, n_valid = _lists(12, seed=3), [7, 3, 5]
    got = linear.score(feats, n_valid)
    want = np.asarray(jax_linear.apply(params, feats))
    for i, n in enumerate(n_valid):
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=TOL,
                                   atol=TOL)
        assert (got[i, n:] < -1e29).all()
    with pytest.raises(ValueError, match="requires the DNN"):
        Scorer.from_checkpoint(str(tmp_path), use_pallas=True, device="cpu")


def test_microbatcher_parity_and_coalescing(scorer, jax_scorer):
    """Concurrent submits return what direct scoring returns (and what the
    JAX scorer returns), and a burst coalesces into fewer device calls."""
    rng = np.random.default_rng(4)
    f = scorer.feature_size
    reqs = [rng.normal(size=(rng.integers(1, 4), li, f)).astype(np.float32)
            for li in (4, 6, 3, 6, 5, 4, 7, 3)]
    batcher = MicroBatcher(scorer, max_delay_s=0.05)
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(batcher.submit, feats) for feats in reqs]
            got = [fut.result(timeout=60) for fut in futs]
        assert batcher.device_calls < len(reqs), "burst did not coalesce"
        for feats, (scores, order) in zip(reqs, got):
            direct_s, direct_o = scorer._score_ranked(feats, None)
            np.testing.assert_allclose(scores, direct_s, rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_array_equal(order, direct_o)
            jax_s, jax_o = jax_scorer._score_ranked(feats, None)
            np.testing.assert_allclose(scores, jax_s, rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(order, jax_o)
    finally:
        batcher.close()


def test_microbatcher_errors_and_timeout(scorer, monkeypatch):
    from ultra_pytorch_tpu_torch.serve.batching import _Pending

    f = scorer.feature_size
    batcher = MicroBatcher(scorer, max_delay_s=0.0)
    try:
        with pytest.raises(ValueError, match="feature size"):
            batcher.submit(np.zeros((1, 3, f + 1), np.float32))
        real = scorer._score_ranked
        boom = {"armed": True}

        def flaky(feats, n_valid):
            if boom.pop("armed", False):
                raise RuntimeError("device fell over")
            return real(feats, n_valid)

        monkeypatch.setattr(scorer, "_score_ranked", flaky)
        with pytest.raises(RuntimeError, match="device fell over"):
            batcher.submit(np.zeros((1, 3, f), np.float32))
        scores, _ = batcher.submit(np.zeros((1, 3, f), np.float32))
        assert scores.shape == (1, 3)
    finally:
        batcher.close()

    release = threading.Event()

    def wedged(feats, n_valid):
        release.wait(10)
        raise RuntimeError("late")

    monkeypatch.setattr(scorer, "_score_ranked", wedged)
    batcher = MicroBatcher(scorer, max_delay_s=0.0, submit_timeout_s=0.2)
    try:
        with pytest.raises(TimeoutError, match="not served"):
            batcher.submit(np.zeros((1, 3, f), np.float32))
        stuck = _Pending(np.zeros((1, 3, f), np.float32),
                         np.asarray([3], np.int32))
        with batcher._cv:
            batcher._queue.append(stuck)
        batcher.close()
        assert stuck.event.is_set() and stuck.error is not None
    finally:
        release.set()


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    return f"http://{host}:{port}"


def _post(base, payload, timeout=60):
    req = urllib.request.Request(
        f"{base}/v1/rank", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_round_trip_matches_jax_server(scorer, jax_scorer):
    """The same request to a JAX server and a port server gives the same
    rankings and scores within 1e-5."""
    batcher = MicroBatcher(scorer)
    ours = make_server(scorer, port=0, batcher=batcher)
    theirs = jax_make_server(jax_scorer, port=0)
    try:
        base_ours, base_theirs = _start(ours), _start(theirs)
        with urllib.request.urlopen(f"{base_ours}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "feature_size": 64}
        rng = np.random.default_rng(2)
        queries = [rng.normal(size=(n, 64)).astype(np.float32).tolist()
                   for n in (4, 2, 9)]
        got = _post(base_ours, {"queries": queries})
        want = _post(base_theirs, {"queries": queries})
        assert got["ranked"] == want["ranked"]
        for a, b in zip(got["scores"], want["scores"]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        assert [sorted(r) for r in got["ranked"]] == [
            list(range(4)), list(range(2)), list(range(9))]
    finally:
        ours.shutdown()
        theirs.shutdown()
        batcher.close()


def test_http_request_limits_and_scoring_errors(scorer, monkeypatch):
    """400/413 before any device work, and a scoring failure is a JSON
    500 that the server survives."""
    server = make_server(scorer, port=0, max_body_bytes=10_000,
                         max_queries=2, max_list_len=4)
    try:
        base = _start(server)
        f = scorer.feature_size
        ok_q = [[0.0] * f] * 2
        cases = [({"queries": [ok_q, ok_q, ok_q]}, 400, b"queries exceeds"),
                 ({"queries": [[[0.0] * f] * 5]}, 400, b"docs exceeds"),
                 ({"queries": [[[1, 2]]]}, 400, b"features"),
                 ({"queries": [[[0.5] * f] * 4] * 2, "pad": "x" * 20_000},
                  413, b"exceeds limit")]
        for payload, code, text in cases:
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(base, payload)
            assert exc.value.code == code
            assert text in exc.value.read()

        def boom(feats, n_valid):
            raise RuntimeError("device fell over")

        monkeypatch.setattr(scorer, "_score_ranked", boom)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base, {"queries": [ok_q]})
        assert exc.value.code == 500
        assert b"device fell over" in exc.value.read()
        monkeypatch.undo()
        assert len(_post(base, {"queries": [ok_q]})["ranked"]) == 1
    finally:
        server.shutdown()


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port writes; JAX's load_params_prefix reads, and the JAX DNN
    scores with those weights as the port does."""
    model = DNN("hidden_layer_sizes=[16, 8]", 12,
                generator=torch.Generator().manual_seed(7))
    path = str(tmp_path / "DLA.ckpt")
    ckpt.save_checkpoint(path, params_to_jax(model), metadata={"step": 3})
    jax_dnn = JaxDNN("hidden_layer_sizes=[16, 8]", 12)
    template = jax_dnn.init(jax.random.PRNGKey(0), 12)
    loaded = jax_ckpt.load_params_prefix(path, template)
    assert jax_ckpt.read_metadata(path) == {"step": 3}
    x = _lists(12, seed=5)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jax_dnn.apply(loaded, x)), ours,
                               rtol=2e-5, atol=2e-5)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """JAX writes (params first, then more state, as the trainer does); the
    port's load_params_prefix reads the params."""
    jax_dnn = JaxDNN("hidden_layer_sizes=[16, 8]", 12)
    params = jax_dnn.init(jax.random.PRNGKey(3), 12)
    path = str(tmp_path / "DLA.ckpt")
    jax_ckpt.save_checkpoint(path, (params, {"extra": np.zeros(5)}),
                             metadata={"step": 1})
    model = DNN("hidden_layer_sizes=[16, 8]", 12)
    tree = ckpt.load_params_prefix(path, params_to_jax(model))
    params_from_jax(model, tree)
    assert ckpt.read_metadata(path) == {"step": 1}
    x = _lists(12, seed=6)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_dnn.apply(params, x)),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_params_prefix(path, params_to_jax(
            DNN("hidden_layer_sizes=[16, 4]", 12)))
