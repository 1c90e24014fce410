"""The port's libsvm and ULTRE loaders and its native parser against the
JAX package's, on the toy data (written with ``--libsvm``), and the CLI
training on both formats.

Ids, lists, labels and ``max_label`` must be equal; features within 1e-6.
The port builds its own copy of the parser into
``build/ultra_pytorch_tpu_torch/``; ``parse_letor_file.parses`` shows
that it ran.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here

from ultra_pytorch_tpu.data import dataset as jax_data  # noqa: E402
from ultra_pytorch_tpu.data import native as jax_native  # noqa: E402
from ultra_pytorch_tpu_torch.data import dataset as data  # noqa: E402
from ultra_pytorch_tpu_torch.data import native  # noqa: E402
from ultra_pytorch_tpu_torch.ops.kernels import build  # noqa: E402
from ultra_pytorch_tpu_torch.run import __main__ as cli  # noqa: E402

SPLITS = ("train", "valid", "test")
FEATURE_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    if not native.native_available():
        pytest.skip("the native parser did not build (no g++)")
    return native


@pytest.fixture(scope="module")
def libsvm_dir(toy_data_dir, tmp_path_factory):
    """The toy data's libsvm twin alone: ``<split>/<split>.txt``."""
    out = tmp_path_factory.mktemp("libsvm")
    for split in SPLITS:
        (out / split).mkdir()
        shutil.copy(os.path.join(toy_data_dir, split, f"{split}.txt"),
                    out / split / f"{split}.txt")
    return str(out)


@pytest.fixture(scope="module")
def ultre_dir(toy_data_dir, tmp_path_factory):
    """The toy data in ULTRE form: the same ``.feature`` rows, lists of
    document ids (plus one unknown id, which the loader drops), and a
    click-model directory whose train and test labels are logged clicks
    (different from the data's own; valid has none there)."""
    out = tmp_path_factory.mktemp("ultre")
    clicks = out / "clicks"
    clicks.mkdir()
    rng = np.random.default_rng(4)
    shutil.copy(os.path.join(toy_data_dir, "settings.json"), out)
    for split in SPLITS:
        src = os.path.join(toy_data_dir, split, split)
        (out / split).mkdir()
        shutil.copy(f"{src}.feature", out / split / f"{split}.feature")
        shutil.copy(f"{src}.labels", out / split / f"{split}.labels")
        with open(f"{src}.feature") as fin:
            dids = [line.split()[0] for line in fin if line.strip()]
        lists, logged = [], []
        with open(f"{src}.init_list") as fin:
            for line in fin:
                qid, *rows = line.split()
                docs = [dids[int(r)] for r in rows]
                lists.append(f"{qid} {' '.join(docs)} unknown_doc\n")
                c = (rng.random(len(docs)) < 0.4).astype(int)
                c[-1] = 1
                logged.append(f"{qid} {' '.join(map(str, c))}\n")
        (out / split / f"{split}.init_list").write_text("".join(lists))
        if split != "valid":
            (clicks / f"{split}.labels").write_text("".join(logged))
    return str(out)


def _assert_equal(got, want):
    for name in ("qids", "dids", "feature_size", "rank_list_size",
                 "max_label"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("initial_list", "labels"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.features, want.features, rtol=0,
                               atol=FEATURE_TOL)


@pytest.mark.parametrize("rank_cut", [None, 4])
@pytest.mark.parametrize("split", SPLITS)
def test_libsvm_equals_jax(built, libsvm_dir, split, rank_cut):
    before = native.parse_letor_file.parses
    got = data.read_data(libsvm_dir, split, rank_cut)
    assert native.parse_letor_file.parses == before + 1
    want = jax_data.read_data(libsvm_dir, split, rank_cut)
    _assert_equal(got, want)
    assert got.dids[0] == f"{got.qids[0]}_0"
    assert got.max_label == 2.0 and got.num_queries > 0
    if rank_cut:
        assert got.rank_list_size == rank_cut


@pytest.mark.parametrize("rank_cut", [None, 3])
@pytest.mark.parametrize("logged", [False, True], ids=["own", "logged"])
def test_ultre_equals_jax(built, ultre_dir, logged, rank_cut):
    """With a click-model directory through ``read_data``'s detection (as
    the CLI's ``--data_format ULTRE`` reads), without one through the
    loader itself."""
    cm_dir = os.path.join(ultre_dir, "clicks")
    for split in SPLITS:
        if logged:
            got = data.read_data(ultre_dir, split, rank_cut, cm_dir)
            want = jax_data.read_data(ultre_dir, split, rank_cut, cm_dir)
        else:
            got = data.load_ultre_format(ultre_dir, split, None, rank_cut)
            want = jax_data.load_ultre_format(ultre_dir, split, None,
                                              rank_cut)
        _assert_equal(got, want)
        assert got.num_queries > 0 and "unknown_doc" not in got.dids
    if logged:   # train took the logged clicks; valid had none there
        def labels(split, cm):
            return data.load_ultre_format(ultre_dir, split, cm,
                                          rank_cut).labels
        assert not np.array_equal(labels("train", cm_dir),
                                  labels("train", None))
        assert set(np.unique(labels("train", cm_dir))) <= {0.0, 1.0}
        np.testing.assert_array_equal(labels("valid", cm_dir),
                                      labels("valid", None))


def test_ultra_features_go_through_the_native_parser(built, toy_data_dir,
                                                     monkeypatch):
    before = native.parse_letor_file.parses
    fast = data.read_data(toy_data_dir, "train")
    assert native.parse_letor_file.parses == before + 1
    _assert_equal(fast, jax_data.read_data(toy_data_dir, "train"))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = data.read_data(toy_data_dir, "train")
    assert native.parse_letor_file.parses == before + 1
    assert slow.dids == fast.dids
    np.testing.assert_array_equal(slow.features, fast.features)


@pytest.mark.parametrize("fmt", ["libsvm", "ultra"])
def test_native_parse_equals_python_and_jax(built, toy_data_dir, libsvm_dir,
                                            fmt, monkeypatch):
    if fmt == "libsvm":
        path = os.path.join(libsvm_dir, "train", "train.txt")
        code, width = native.FORMAT_LIBSVM, None
    else:
        path = os.path.join(toy_data_dir, "train", "train.feature")
        code, width = native.FORMAT_ULTRA, 64
    feats, labels, ids = native.parse_letor_file(path, code, width)
    if not jax_native.native_available():
        pytest.skip("the JAX package's parser did not build")
    j_feats, j_labels, j_ids = jax_native.parse_letor_file(path, code, width)
    assert ids == j_ids
    np.testing.assert_array_equal(feats, j_feats)
    np.testing.assert_array_equal(labels, j_labels)
    if fmt == "libsvm":
        py = data._parse_libsvm_python(path)
        assert py[2] == ids
        np.testing.assert_array_equal(py[1], labels)
        np.testing.assert_allclose(py[0], feats, rtol=0, atol=FEATURE_TOL)
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        py_ids, py_feats = data._read_sparse_features(path, width, [])
        assert py_ids == ids
        np.testing.assert_allclose(py_feats, feats, rtol=0, atol=FEATURE_TOL)


def test_native_fast_path_equals_strtod(built, tmp_path):
    """The port's parser reads plain decimals of up to 15 digits without
    ``strtod``; every value in many spellings (fixed, exponent, repr, 17
    significant digits, integers, long negatives) must give the JAX
    package's parser's float32 bits."""
    if not jax_native.native_available():
        pytest.skip("the JAX package's parser did not build")
    rng = np.random.default_rng(0)
    spell = (
        lambda v: f"{v:.{rng.integers(0, 12)}f}", lambda v: f"{v:e}",
        lambda v: repr(float(v)), lambda v: f"{v:.17g}",
        lambda v: str(int(v)), lambda v: f"{abs(v):.6f}",
        lambda v: f"-{rng.integers(0, 10 ** 15)}.{rng.integers(0, 10)}",
        lambda v: f"{rng.integers(0, 10 ** rng.integers(1, 16))}")
    lines = []
    for r in range(2000):
        toks = [str(rng.integers(0, 5)), f"qid:{r // 50}"]
        for j in range(1, 30):
            v = rng.normal() * 10.0 ** rng.integers(-8, 9)
            toks.append(f"{j}:{spell[rng.integers(0, len(spell))](v)}")
        lines.append(" ".join(toks) + "\n")
    path = tmp_path / "values.txt"
    path.write_text("".join(lines))
    got = native.parse_letor_file(str(path), native.FORMAT_LIBSVM)
    want = jax_native.parse_letor_file(str(path), jax_native.FORMAT_LIBSVM)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  want[0].view(np.uint32))


def test_parser_builds_from_the_ports_copy(built):
    lib = native.get_lib()
    assert os.path.dirname(lib._name) == str(build.BUILD_DIR)
    assert os.path.basename(lib._name).startswith("libletor_parser-")
    assert native.SOURCE.parent.name == "csrc"
    assert native.SOURCE.parent.parent.name == "data"


def _cli_settings(tmp_path, click_model_json):
    path = tmp_path / "settings.json"
    path.write_text(json.dumps({
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={click_model_json}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "test_input_feed": "DirectLabelFeed", "test_input_hparams": "",
        "ranking_model": "DNN", "ranking_model_hparams":
            "hidden_layer_sizes=[16]",
        "learning_algorithm": "DLA", "learning_algorithm_hparams": "",
        "metrics": ["ndcg"], "metrics_topn": [5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 5}))
    return str(path)


@pytest.mark.parametrize("fmt", ["libsvm", "ULTRE"])
def test_cli_trains_on_the_format(built, libsvm_dir, ultre_dir,
                                  click_model_json, tmp_path, capsys, fmt):
    common = ["--device", "cpu", "--setting_file",
              _cli_settings(tmp_path, click_model_json),
              "--model_dir", str(tmp_path / "model"), "--batch_size", "8"]
    if fmt == "ULTRE":
        common += ["--data_dir", ultre_dir, "--data_format", "ULTRE",
                   "--click_model_dir", os.path.join(ultre_dir, "clicks")]
    else:
        common += ["--data_dir", libsvm_dir]
    cli.main(common + ["--max_train_iteration", "4",
                       "--steps_per_checkpoint", "4"])
    out = capsys.readouterr().out
    assert "step 4 loss" in out and "Training done at step 4" in out
    assert (tmp_path / "model" / "DLA.ckpt.npz").is_file()
    cli.main(common + ["--output_dir", str(tmp_path / "out"), "--test_only"])
    out = capsys.readouterr().out
    assert "ndcg_5:" in out and "WARNING" not in out
    lines = (tmp_path / "out" / "test.ranklist").read_text().splitlines()
    test = data.read_data(common[common.index("--data_dir") + 1], "test",
                          None, os.path.join(ultre_dir, "clicks")
                          if fmt == "ULTRE" else None)
    assert len(lines) == int((test.initial_list >= 0).sum())
