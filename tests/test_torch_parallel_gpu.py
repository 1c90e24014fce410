"""Data parallelism and the native parser on the card.

* Two gloo ranks sharing ``cuda:0`` take a DLA step with every kernel on
  (K1-K4) on their own shard batches; it equals one process's step whose
  gradient is the mean of the two shards' gradients.
* NCCL at world size 1: the backend resolves to NCCL and a window through
  the group equals the window without one.
* The native parser on a generated MSLR-shaped libsvm file.

These need a CUDA device and skip without one. The file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.data import dataset as data_lib
from ultra_pytorch_tpu_torch.data import native
from ultra_pytorch_tpu_torch.ops.kernels import listwise_loss, mlp
from ultra_pytorch_tpu_torch.parallel import (
    close_data_parallel, init_data_parallel, spawn_ranks)
from ultra_pytorch_tpu_torch.run.experiment import (
    Experiment, create_algorithm)

import torch_dp_ranks

pytestmark = pytest.mark.gpu

F, B, L = 136, 64, 10      # B is the global batch: 32 queries a rank
LOSS_TOL = 1e-5
UPDATE_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    mlp.build_kernel()              # once here, before any rank starts
    mlp.build_backward_kernel()
    listwise_loss.build_kernel()
    return torch.device("cuda", 0)


def _settings():
    return {"ranking_model": "DNN",
            "ranking_model_hparams": "hidden_layer_sizes=[64, 32],"
                                     "use_pallas=true",
            "learning_algorithm": "DLA",
            "learning_algorithm_hparams":
                "loss_func=fused_softmax_loss,grad_strategy=sgd,"
                "learning_rate=1.0,max_gradient_norm=0.05",
            "max_candidate_num": L, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _shard_batches():
    rng = np.random.default_rng(0)
    mask = np.ones((B, L), np.float32)
    mask[: B // 4, 7:] = 0.0
    clicks = (rng.random((B, L)) < 0.3).astype(np.float32) * mask
    clicks[:, 0] = 1.0
    batch = {"features": rng.normal(size=(B, L, F)).astype(np.float32),
             "labels": clicks, "mask": mask}
    return {k: v.reshape((2, B // 2) + v.shape[1:]) for k, v in batch.items()}


def test_two_gloo_ranks_on_one_card_equal_the_mean_gradient_step(
        cuda, tmp_path):
    alg = create_algorithm(_settings(), F, 1.0, device=cuda)
    state = alg.init_state(torch.Generator().manual_seed(1))
    leaves = alg.state_leaves(state)
    batches = _shard_batches()
    ranks = [result["DLA"] for result in spawn_ranks(
        torch_dp_ranks.rank_job, 2,
        (f"file://{tmp_path / 'store'}",
         {"DLA": (_settings(), leaves, [(batches, None)], F)}, None, {},
         str(cuda)), timeout=120)]

    # One process: each shard's loss and gradient, then the mean's step.
    losses, grads = [], []
    for r in range(2):
        batch = {k: torch.from_numpy(v[r]).to(cuda)
                 for k, v in batches.items()}
        out = alg.losses(state, batch)
        losses.append(out[0].item())
        grads.append(torch.autograd.grad(out[0], alg.trainable(state)))
    alg.apply_gradients(state, [(a + b) / 2 for a, b in zip(*grads)])
    want = alg.state_leaves(state)
    for r, (got_losses, got) in enumerate(ranks):
        assert abs(got_losses[0] - losses[r]) <= LOSS_TOL * abs(losses[r])
        n = len(got)
        delta = [g - w0 for g, w0 in zip(got[:n - 1], leaves[:n - 1])]
        want_delta = [w - w0 for w, w0 in zip(want[:n - 1], leaves[:n - 1])]
        scale = max(np.abs(d).max() for d in want_delta)
        for a, b in zip(delta, want_delta):
            np.testing.assert_allclose(a, b, rtol=0, atol=UPDATE_TOL * scale)
    for a, b in zip(ranks[0][1], ranks[1][1]):
        np.testing.assert_array_equal(a, b)


def _window(tmp_path, data, device):
    settings = dict(_settings(), train_input_feed="DirectLabelFeed",
                    train_input_hparams="", valid_input_feed="DirectLabelFeed",
                    valid_input_hparams="", objective_metric="ndcg_5")
    exp = Experiment(settings, "unused", str(tmp_path), batch_size=B,
                     seed=2, device=device).setup(("train",), datasets=data)
    exp.init_state()
    metrics = exp.train_steps(5)
    return exp, metrics, exp.algorithm.state_leaves(exp.state)


def test_nccl_at_world_size_one_equals_no_group(cuda, tmp_path):
    rng = np.random.default_rng(3)
    q = 256
    data = {"train": data_lib.RankingDataset(
        features=rng.normal(size=(q * L, F)).astype(np.float32),
        initial_list=np.arange(q * L).reshape(q, L),
        labels=rng.integers(0, 3, size=(q, L)).astype(np.float32),
        qids=[str(i) for i in range(q)],
        dids=[str(i) for i in range(q * L)], feature_size=F,
        rank_list_size=L, max_label=2.0)}
    _, plain_metrics, plain = _window(tmp_path / "plain", data, cuda)
    backend = init_data_parallel(1, 0, cuda,
                                 init_method=f"file://{tmp_path / 'store'}")
    try:
        assert backend == "nccl"
        exp, metrics, got = _window(tmp_path / "nccl", data, cuda)
        assert exp.data_parallel and exp.world_size == 1
    finally:
        close_data_parallel()
    assert metrics == plain_metrics
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_native_parser_on_a_generated_file(cuda, tmp_path):
    if not native.native_available():
        pytest.skip("the native parser did not build (no g++)")
    rng = np.random.default_rng(5)
    rows, per_query = 1200, 120
    feats = np.round(rng.normal(size=(rows, F)), 6).astype(np.float32)
    labels = rng.integers(0, 5, size=rows)
    qids = np.repeat(np.arange(rows // per_query), per_query)
    split = tmp_path / "train"
    split.mkdir()
    with open(split / "train.txt", "w") as fout:
        for lab, qid, row in zip(labels, qids, feats):
            fout.write(f"{lab} qid:{qid} " + " ".join(
                f"{i + 1}:{v:.6f}" for i, v in enumerate(row)) + "\n")
    before = native.parse_letor_file.parses
    ds = data_lib.read_data(str(tmp_path), "train")
    assert native.parse_letor_file.parses == before + 1
    np.testing.assert_array_equal(ds.features, feats)
    np.testing.assert_array_equal(ds.labels.reshape(-1),
                                  labels.astype(np.float32))
    assert ds.rank_list_size == per_query and ds.max_label == 4.0
