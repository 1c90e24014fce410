"""The plain references and the yardstick against cases worked by
hand."""

import math

import numpy as np
import pytest
import torch

from perfbench import spec
from perfbench.yardstick import clicks, compare, dla, keys, philox


def _word(v):
    return torch.tensor([v], dtype=torch.int64)


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, expected):
    """Random123's known-answer vectors of Philox4x32-10."""
    out = philox.rounds(*map(_word, counter), *key)
    assert tuple(int(w) for w in out) == expected


def test_philox_uniforms_take_the_top_24_bits():
    u = philox.uniforms(0, 0, 3, "cpu")
    assert u.tolist() == [(0x6627e8d5 >> 8) / 2 ** 24,
                          (0xe169c58d >> 8) / 2 ** 24,
                          (0xbc57ac4c >> 8) / 2 ** 24]


def test_click_probabilities():
    cfg = spec.load_json("configs", "dnn_mslr10k")
    model = clicks.click_model_json(cfg)
    assert model["click_prob"] == pytest.approx([0.1, 0.16, 0.28, 0.52,
                                                 1.0])


def test_dnn_forward_by_hand():
    ref = spec.load_module("reference", "dnn_mslr10k")
    cfg = {"features": 2, "ranker_hparams": {"hidden_layer_sizes": [2]}}
    params = {"layers": [
        {"norm": {"scale": torch.tensor([1.0, 1.0]),
                  "bias": torch.tensor([0.0, 0.0])},
         "linear": {"w": torch.tensor([[1.0, 0.0], [0.0, -1.0]]),
                    "b": torch.tensor([0.0, 0.0])}},
        {"norm": {"scale": torch.tensor([2.0, 2.0]),
                  "bias": torch.tensor([0.5, 0.5])},
         "linear": {"w": torch.tensor([[1.0], [1.0]]),
                    "b": torch.tensor([0.25])}}]}
    x = torch.tensor([[[1.0, 3.0]]])
    # LayerNorm of (1, 3): (-1, 1) / sqrt(1 + 1e-5); the Linear gives
    # (-a, -a), ELU (e^-a - 1, e^-a - 1); its LayerNorm is (0, 0), so the
    # output is 2 x 0.5 + 0.25.
    a = 1 / math.sqrt(1 + 1e-5)
    assert ref.param_shapes(cfg)["layers"][1]["linear"]["w"][1] == (2, 1)
    out = ref.forward(cfg, params, x)
    assert out.shape == (1, 1)
    assert float(out) == pytest.approx(1.25, abs=1e-6)
    params["layers"][1]["norm"]["scale"] = torch.tensor([1.0, 0.0])
    params["layers"][0]["linear"]["w"] = torch.tensor([[1.0, 0.0],
                                                       [0.0, 1.0]])
    # Now the hidden layer is (e^-a - 1, a): LayerNorm gives (-1, 1) over
    # sqrt(1 + 1e-5 / var), and only the first element is kept.
    h = np.array([math.exp(-a) - 1, a])
    var = h.var()
    expected = -(h[1] - h[0]) / 2 / math.sqrt(var + 1e-5) + 0.5 + 0.5 + 0.25
    assert float(ref.forward(cfg, params, x)) == pytest.approx(expected,
                                                               rel=1e-5)


def test_setrank_one_document_and_permutations():
    """With one document the attention returns its input; the scores of
    a permuted list are the permuted scores."""
    ref = spec.load_module("reference", "setrank_mslr10k")
    from perfbench.yardstick import weights

    cfg = {"features": 3, "ranker_hparams": {"d_model": 4, "num_heads": 2,
                                             "num_layers": 1, "diff": 3}}
    p = weights.make(ref.param_shapes(cfg), 5, "cpu")
    x = torch.randn(1, 1, 3, generator=torch.Generator().manual_seed(0))

    def ln(v):
        return (v - v.mean()) / torch.sqrt(v.var(unbiased=False) + 1e-6)

    def ffn(f, v):
        h = torch.relu(v @ f["fc1"]["w"] + f["fc1"]["b"])
        return h @ f["fc2"]["w"] + f["fc2"]["b"]

    e = ffn(p["input_embed"], ln(x[0, 0]))
    layer = p["layers"][0]
    e = ln(e + e @ layer["mha_dense"]["w"] + layer["mha_dense"]["b"])
    e = ln(e + ffn(layer["ffn"], e))
    expected = ffn(p["output"], e)
    assert torch.allclose(ref.forward(cfg, p, x)[0, 0], expected[0],
                          atol=1e-5)
    xs = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(1))
    perm = torch.tensor([3, 0, 4, 1, 2])
    assert torch.allclose(ref.forward(cfg, p, xs)[:, perm],
                          ref.forward(cfg, p, xs[:, perm]), atol=1e-5)


def test_softmax_loss_by_hand():
    scores = torch.tensor([[0.0, math.log(3.0)], [1.0, 2.0]])
    labels = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    weights = torch.ones(2, 2)
    mask = torch.tensor([[1.0, 1.0], [0.0, 0.0]])
    # List 1: labels (1 + 1e-7, 1e-7), softmax (1/4, 3/4); list 2 masked.
    w = torch.tensor([1 + 1e-7, 1e-7], dtype=torch.float64)
    expected = float(-(w[0] * math.log(0.25) + w[1] * math.log(0.75))
                     / w.sum())
    got = dla.softmax_loss(scores, labels, weights, mask)
    assert float(got) == pytest.approx(expected, rel=1e-6)


def test_adagrad_first_step_moves_by_the_rate():
    """Adagrad's first step moves every element with a gradient by about
    the learning rate, whatever the gradient's size."""
    forward = lambda p, x, m: (x * p["v"]).sum(-1)  # noqa: E731
    run = dla.PlainDLA(forward, {"v": torch.tensor([1.0, 1.0])},
                       {"w": torch.zeros(2), "b": torch.zeros(())},
                       learning_rate=0.05, max_gradient_norm=5.0)
    x = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    run.step(x, torch.tensor([[1.0, 0.0]]), torch.ones(1, 2))
    change = run.leaves()[0].detach() - 1.0
    assert torch.allclose(change.abs(), torch.full((2,), 0.05), rtol=1e-6)


def test_gaps_by_hand():
    ref = {"losses": [2.0, 2.0, 2.0], "grad_norms": [1.0, 2.0, 4.0, 1e-9],
           "change_norms": [1.0, 1.0, 2.0, 0.5], "window_loss": 4.0}
    prog = {"losses": [2.002, 2.1, 2.0], "grad_norms": [1.2, 2.0, 4.0, 0.0],
            "change_norms": [1.0, 0.9, 1.6, 0.0], "window_loss": 4.4}
    gaps = compare.training_gaps(prog, ref)
    # The steps read 1e-3, 5e-2 and 0: the worst.
    assert gaps["loss_gap"] == pytest.approx(5e-2)
    # (1.2 - 1) over the median leaf, 1.5
    assert gaps["grad_gap"] == pytest.approx(0.2 / 1.5)
    # The fourth leaf is left out; the others read 0, 0.1 and 0.2.
    assert gaps["change_gap"] == pytest.approx(0.2)
    assert gaps["median_change_gap"] == pytest.approx(0.1)
    assert gaps["window_loss_gap"] == pytest.approx(0.1)
    assert compare.judge(gaps, {"loss_gap": 0.06, "change_gap": 0.2})
    assert not compare.judge(gaps, {"change_gap": 0.19})
    assert not compare.judge({"loss_gap": float("nan")}, {"loss_gap": 1})


def test_window_seeds_are_the_programs():
    """The frozen key schedule gives the seeds ``Experiment`` gives."""
    from ultra_pytorch_tpu_torch.run import experiment
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    seed = 2 ** 31 + 99
    exp = Experiment({}, "", "", seed=seed, device="cpu")
    exp._data_key = experiment._words(seed ^ experiment._DATA_KEY_TAG, 2)
    program = [exp._window_seed() for _ in range(4)]
    assert keys.window_seeds(seed, 4) == program
