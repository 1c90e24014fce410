"""The port's ``run/dryrun.py`` against the JAX system's
``__graft_entry__.py`` on the CPU.

* ``entry()``: the same synthetic batch, and the flagship DNN's scores
  equal JAX's ``entry()`` on the same weights carried across.
* ``dryrun_multichip`` over one and two gloo ranks: the 18 cases in JAX's
  order print JAX's ``ok`` lines, each at step 2 with a finite loss and
  the state identical on every rank. (The case table itself is held to
  ``__graft_entry__.py``'s by ``test_torch_api_parity.py``.)
"""

import math

import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from ultra_pytorch_tpu_torch.models.base import params_from_jax
from ultra_pytorch_tpu_torch.run import dryrun

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_entry_equals_the_jax_entry():
    jax_fn, (params, features, mask) = jax_entry()
    fn, (ranker, got_features, got_mask) = dryrun.entry(device="cpu")
    np.testing.assert_array_equal(got_features.numpy(), np.asarray(features))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    assert ranker.hparams.use_pallas     # K1 on the card
    params_from_jax(ranker, params)
    want = np.asarray(jax_fn(params, features, mask))
    got = fn(ranker, got_features, got_mask)
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()


@pytest.mark.parametrize("n_ranks", [1, 2])
def test_dryrun_runs_the_18_cases_in_order(n_ranks, capfd):
    ranks = dryrun.dryrun_multichip(n_ranks, device="cpu")
    printed = [line for line in capfd.readouterr().out.splitlines()
               if line.startswith("dryrun_multichip(")]
    want = [dryrun.case_names(c)[1] for c in dryrun.cases("e", "c")]
    algos = [c[0] for c in dryrun.cases("e", "c")]
    assert len(want) == 18 and len(ranks) == n_ranks
    assert [line.split(" ok: ")[0] for line in printed] == [
        f"dryrun_multichip({n_ranks}) {a}/{label}"
        for a, label in zip(algos, want)]
    for results in ranks:
        assert [r["label"] for r in results] == want
        for r in results:
            assert r["step"] == dryrun.STEPS and r["same"]
            assert math.isfinite(r["loss"]) and not r["graph"]
    for line, r in zip(printed, ranks[0]):
        assert line.endswith(f"ok: loss={r['loss']:.4f}")
    # The ranks' window metrics are means over the ranks: the same loss.
    for results in ranks[1:]:
        assert [r["loss"] for r in results] == [r["loss"] for r in ranks[0]]
