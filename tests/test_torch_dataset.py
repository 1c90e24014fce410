"""The port's ULTRA-format loader and TREC output against the JAX
package's, on the toy data."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference here

from ultra_pytorch_tpu.data import dataset as jax_data
from ultra_pytorch_tpu.data import trec as jax_trec
from ultra_pytorch_tpu_torch.data import dataset as data
from ultra_pytorch_tpu_torch.data import trec


@pytest.mark.parametrize("rank_cut", [None, 4])
@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_read_data_equals_jax(toy_data_dir, split, rank_cut):
    want = jax_data.read_data(toy_data_dir, split, rank_cut)
    got = data.read_data(toy_data_dir, split, rank_cut)
    for name in ("features", "initial_list", "labels", "initial_scores"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for name in ("qids", "dids", "feature_size", "rank_list_size",
                 "max_label"):
        assert getattr(got, name) == getattr(want, name), name
    got.pad(12)
    want.pad(12)
    mine, theirs = got.to_host_arrays(), want.to_host_arrays()
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    dev = got.to_device("cpu", list_size=6)
    assert dev.features.shape == (got.features.shape[0] + 1, got.feature_size)
    assert dev.list_size == 6 and not dev.features[-1].any()


def test_libsvm_and_ultre_are_not_yet_ported(toy_data_dir, tmp_path):
    """Both loaders are ported now (``test_torch_data_formats.py`` holds
    them to the JAX package): the format is detected as JAX's is, and a
    split with neither file is still an error."""
    sub = tmp_path / "train"
    sub.mkdir()
    (sub / "train.txt").write_text("1 qid:1 1:0.5\n0 qid:1 1:0.1\n")
    got = data.read_data(str(tmp_path), "train")
    want = jax_data.read_data(str(tmp_path), "train")
    assert got.dids == want.dids == ["1_0", "1_1"]
    np.testing.assert_array_equal(got.features, want.features)
    got = data.read_data(toy_data_dir, "train", click_model_dir=str(tmp_path))
    want = jax_data.read_data(toy_data_dir, "train",
                              click_model_dir=str(tmp_path))
    assert got.num_queries == want.num_queries  # ULTRE: lists of dids
    with pytest.raises(FileNotFoundError):
        data.read_data(str(tmp_path), "valid")


def test_merge_summary_equals_jax():
    parts = [{"ndcg_5": 0.5, "mrr_5": 0.25}, {"ndcg_5": 0.75, "mrr_5": 1.0}]
    assert data.merge_summary(parts, [3, 1]) == \
        jax_data.merge_summary(parts, [3, 1])


def test_ranklist_equals_jax(toy_data_dir, tmp_path):
    ds = data.read_data(toy_data_dir, "test")
    jds = jax_data.read_data(toy_data_dir, "test")
    scores = np.random.default_rng(0).normal(
        size=ds.initial_list.shape).astype(np.float32)
    scores[0, :] = 1.0  # ties keep initial-list order in both
    mine = trec.output_ranklist(ds, scores, str(tmp_path / "a"))
    theirs = jax_trec.output_ranklist(jds, scores, str(tmp_path / "b"))
    assert open(mine).read() == open(theirs).read()
