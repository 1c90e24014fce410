"""The online family on the card: the draft equals the CPU's, and one
step with the kernels (K1, and K2 for PDGD) equals the plain path.

These need a CUDA device and skip without one. The file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import os

import pytest
import torch

from ultra_pytorch_tpu_torch.run.experiment import create_algorithm
from ultra_pytorch_tpu_torch.sim.interleave import draft, round_assignments
from ultra_pytorch_tpu_torch.utils import spans

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLICK_JSON = os.path.join(REPO, "example", "ClickModel",
                          "pbm_0.1_1.0_4_1.0.json")
F, B, LC, L = 136, 64, 120, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n_rankers", [2, 5])
def test_draft_on_the_card_equals_the_cpu(cuda, n_rankers):
    gen = torch.Generator().manual_seed(n_rankers)
    # Odd lists: the rankers share their first 2 documents; even lists:
    # independent rankings.
    base = torch.rand((256, LC), generator=gen).argsort(-1)
    perm = torch.rand((256, n_rankers, LC - 2), generator=gen).argsort(-1)
    shared = torch.cat([base[:, None, :2].expand(-1, n_rankers, -1),
                        torch.gather(base[:, None, 2:].expand(
                            -1, n_rankers, -1), 2, perm)], dim=-1)
    rankings = torch.rand((256, n_rankers, LC), generator=gen).argsort(-1)
    rankings[1::2] = shared[1::2]
    assignments = round_assignments(gen, 256, n_rankers, L)
    want = draft(rankings, assignments, L)
    got = draft(rankings.to(cuda), assignments.to(cuda), L)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert (want[1][1::2, :2] == -1).all()


def _batch(device):
    gen = torch.Generator().manual_seed(3)
    mask = torch.ones((B, LC))
    mask[: B // 4, 60:] = 0.0
    clicks = torch.zeros((B, LC))
    clicks[:, :L] = (torch.rand((B, L), generator=gen) < 0.3).float()
    clicks[:, 0] = 1.0
    return {k: v.to(device) for k, v in {
        "features": torch.randn((B, LC, F), generator=gen),
        "labels": clicks, "mask": mask,
        "relevance": torch.randint(0, 5, (B, LC), generator=gen).float()
        * mask,
        "initial_scores": torch.zeros((B, LC))}.items()}


def _algorithm(algo, kernels, device):
    on = "true" if kernels else "false"
    click = "" if algo == "PDGD" else f"click_model_json={CLICK_JSON}"
    settings = {"ranking_model": "DNN",
                "ranking_model_hparams":
                    f"hidden_layer_sizes=[512, 256, 128],use_pallas={on}",
                "learning_algorithm": algo,
                "learning_algorithm_hparams": click,
                "max_candidate_num": LC, "selection_bias_cutoff": L,
                "metrics": ["ndcg"], "metrics_topn": [10]}
    alg = create_algorithm(settings, F, 4.0, device)
    return alg, alg.init_state(torch.Generator().manual_seed(1))


def test_pdgd_step_kernels_on_equals_plain(cuda):
    batch = _batch(cuda)
    out = {}
    for kernels in (True, False):
        alg, state = _algorithm("PDGD", kernels, cuda)
        before = spans.counters()
        losses = alg.losses(state, batch)
        grads = torch.autograd.grad(losses[0], alg.trainable(state))
        after = spans.counters()
        out[kernels] = (losses[0].item(),
                        torch.cat([g.reshape(-1) for g in grads]),
                        tuple(after[k] - before[k]
                              for k in ("launches.K1", "launches.K2")))
    (loss_k, grad_k, launches_k), (loss_p, grad_p, launches_p) = (
        out[True], out[False])
    assert launches_k == (2, 1) and launches_p == (0, 0)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    err = (grad_k - grad_p).abs().max().item()
    assert err <= 2e-4 * grad_p.abs().max().item()


def test_mgd_candidates_and_update_kernels_on_equals_plain(cuda):
    batch = _batch(cuda)
    out = {}
    for kernels in (True, False):
        alg, state = _algorithm("MGD", kernels, cuda)
        gen = torch.Generator(device=cuda).manual_seed(2)
        noises = alg.sample_noises(state, gen)
        k1 = spans.counters()["launches.K1"]
        scores = alg.candidate_scores(state, batch, noises, gen)
        launches = spans.counters()["launches.K1"] - k1
        share = torch.tensor([0.1, 0.4, 0.0, 0.3, 0.2], device=cuda)
        state = alg.apply_noise_update(state, noises, share)
        out[kernels] = (torch.stack(scores),
                        torch.cat([t.reshape(-1) for t, _ in
                                   state.params.jax_leaves()]), launches)
    (s_k, p_k, n_k), (s_p, p_p, n_p) = out[True], out[False]
    assert n_k == 5 and n_p == 0
    torch.testing.assert_close(s_k, s_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(p_k, p_p, rtol=0, atol=1e-6)
