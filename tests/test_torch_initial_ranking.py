"""The port's linear initial ranker (``ultra_pytorch_tpu_torch.pipeline.
initial_ranking``) against ``libsvm_tools/initial_ranking_with_linear.py``:
the same reader, byte-identical ``.predict`` files from the same
``model.npz``, optax's ``adagrad(0.5)`` step on fixed pairs, and (Philox
pairs against threefry ones) the same weights and test nDCG@10 after 200
steps within statistical bounds."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ultra_pytorch_tpu_torch.pipeline import initial_ranking as ir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "libsvm_tools"))
sys.path.insert(0, ROOT)

import initial_ranking_with_linear as ref  # noqa: E402
import torch_convergence as conv  # noqa: E402

SPLITS = ("train", "valid", "test")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def learnable(tmp_path_factory):
    """Small libsvm splits with one hidden scorer (the convergence study's
    generator)."""
    out = tmp_path_factory.mktemp("learnable")
    conv.generate(str(out), train_queries=200, valid_queries=50,
                  test_queries=100)
    return [str(out / s / f"{s}.txt") for s in SPLITS]


@pytest.fixture(scope="module")
def awkward(tmp_path_factory):
    """A libsvm file with comments, bare tokens, string qids, an empty line
    and a feature index past the others."""
    path = tmp_path_factory.mktemp("awkward") / "awkward.txt"
    path.write_text(
        "2 qid:q7 1:0.5 3:-1.25 # docid = GX000-00 inc = 1\n"
        "0 qid:q7 2:0.125 bare 4:3e-2\n"
        "\n"
        "1 qid:10 1:1 12:0.75 #c\n"
        "3 qid:q7 5:-0.5\n")
    return str(path)


def _files(toy_data_dir, awkward):
    return [os.path.join(toy_data_dir, s, f"{s}.txt") for s in SPLITS] + [
        awkward]


def test_reader_matches_the_reference(toy_data_dir, awkward):
    for path in _files(toy_data_dir, awkward):
        labels, qids, rows, n_feat = ref._read_libsvm(path)
        assert ir.read_libsvm(path) == (labels, qids, rows, n_feat), path
        x, y, q = ir.read_dense(path)
        want = ref._dense(rows, n_feat)
        assert x.dtype == np.float32 and np.array_equal(x, want), path
        assert y.dtype == np.float32
        assert np.array_equal(y, np.asarray(labels, np.float32)), path
        assert list(q) == qids, path
        wide = ir.read_dense(path, n_feat + 3)[0]
        assert np.array_equal(wide, ref._dense(rows, n_feat + 3)), path


def test_native_parser_reads_plain_files_only(toy_data_dir, awkward):
    from ultra_pytorch_tpu_torch.data import native

    if not native.native_available():
        pytest.skip("no g++ to build the native parser")
    before = native.parse_letor_file.parses
    ir.read_dense(os.path.join(toy_data_dir, "train", "train.txt"))
    assert native.parse_letor_file.parses == before + 1
    ir.read_dense(awkward)
    assert native.parse_letor_file.parses == before + 1


def test_predict_files_equal_the_reference_byte_for_byte(learnable, tmp_path):
    ref.train_and_predict(*learnable, str(tmp_path / "jax") + "/", steps=30)
    model = str(tmp_path / "jax" / "model.npz")
    with np.load(model) as m:
        assert m["w"].dtype == np.float32 and m["b"].shape == ()
    for split, path in zip(SPLITS, learnable):
        out = str(tmp_path / f"{split}.predict")
        assert ir.main(["--predict", model, path, out, "--device",
                        "cpu"]) == 0
        with open(out, "rb") as a, open(
                tmp_path / "jax" / f"{split}.predict", "rb") as b:
            assert a.read() == b.read(), split
        # The reference pipeline's re-predict of the full train file.
        labels, qids, rows, _ = ref._read_libsvm(path)
        scores = ir.predict(rows, model)
        with np.load(model) as m:
            want = ref._dense(rows, m["w"].shape[0]) @ m["w"] + float(m["b"])
        assert np.array_equal(scores, want)


def test_adagrad_step_matches_optax_on_fixed_pairs():
    rng = np.random.default_rng(5)
    n, f = 64, 12
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, 3, size=n).astype(np.float32)
    gid = np.repeat(np.arange(8), 8).astype(np.int32)
    pairs = [(rng.integers(0, n, 256), rng.integers(0, n, 256))
             for _ in range(4)]

    def loss_fn(params, ii, jj):   # the reference tool's step
        w, b = params
        si = x[ii] @ w + b
        sj = x[jj] @ w + b
        sign = jnp.sign(y[ii] - y[jj]) * (gid[ii] == gid[jj])
        margin = jnp.log1p(jnp.exp(-sign * (si - sj))) * jnp.abs(sign)
        return jnp.sum(margin) / jnp.maximum(jnp.sum(jnp.abs(sign)), 1.0)

    params = (jnp.asarray(rng.normal(size=f).astype(np.float32)) * 0.1,
              jnp.zeros(()))
    w = torch.tensor(np.asarray(params[0]), requires_grad=True)
    b = torch.zeros((), requires_grad=True)
    opt = optax.adagrad(0.5)
    state = opt.init(params)
    accs = [torch.full_like(w, ir.ACCUMULATOR_INIT),
            torch.full_like(b, ir.ACCUMULATOR_INIT)]
    xt, yt, gt = map(torch.from_numpy, (x, y, gid))
    for ii, jj in pairs:
        grads = jax.grad(loss_fn)(params, ii, jj)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        loss = ir.pairwise_loss(w, b, xt, yt, gt, torch.from_numpy(ii),
                                torch.from_numpy(jj))
        ir.adagrad_update([w, b], torch.autograd.grad(loss, [w, b]), accs)
        np.testing.assert_allclose(w.detach().numpy(), params[0],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(accs[0].numpy(),
                                   state[0].sum_of_squares[0],
                                   rtol=1e-6, atol=1e-6)
        assert abs(b.item() - float(params[1])) <= 1e-6


def _test_ndcg(test_file, predict_file) -> float:
    labels, qids, _, _ = ref._read_libsvm(test_file)
    scores = np.loadtxt(predict_file)
    by_query = {}
    for label, qid, score in zip(labels, qids, scores):
        by_query.setdefault(qid, []).append((score, label))
    values = []
    for docs in by_query.values():
        order = sorted(range(len(docs)), key=lambda i: -docs[i][0])
        values.append(conv._ndcg_at([docs[i][1] for i in order]))
    return float(np.mean(values))


def test_200_steps_land_near_the_reference(learnable, tmp_path):
    """Seeds 0-4 a side: each seed's weights within cosine 0.95 of the
    reference's, and the mean test nDCG@10 within 0.01 (one seed's value
    spreads over 0.012 across seeds on either side, so the means are
    compared)."""
    ndcg = {"jax": [], "port": []}
    for seed in range(5):
        jax_dir, port_dir = tmp_path / f"jax{seed}", tmp_path / f"port{seed}"
        ref.train_and_predict(*learnable, str(jax_dir) + "/", 200, seed=seed)
        ir.train_and_predict(*learnable, str(port_dir) + "/", 200,
                             seed=seed, device="cpu")
        with np.load(jax_dir / "model.npz") as a, np.load(
                port_dir / "model.npz") as b:
            wj, wp = a["w"], b["w"]
            assert b["w"].dtype == np.float32 and b["b"].shape == ()
            assert b["b"].dtype == np.float64
        cosine = float(wj @ wp / np.linalg.norm(wj) / np.linalg.norm(wp))
        assert cosine >= 0.95, (seed, cosine)
        for side, out in (("jax", jax_dir), ("port", port_dir)):
            ndcg[side].append(_test_ndcg(learnable[2], out / "test.predict"))
    means = {side: float(np.mean(v)) for side, v in ndcg.items()}
    assert abs(means["jax"] - means["port"]) <= 0.01, ndcg
    assert means["port"] > 0.9, ndcg   # the hidden scorer is learned


def test_defaults_to_cuda_and_raises_without_it(learnable, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ir.main([*learnable, str(tmp_path) + "/", "5"])
    assert not os.path.exists(tmp_path / "model.npz")
