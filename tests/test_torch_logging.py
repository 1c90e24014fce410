"""The port's MetricLogger against the JAX package's: the same records give
the same history, the same JSONL lines (their wall-clock `time` aside)
and, where torch's TensorBoard writer imports, the same scalars in one
event file a split."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu.utils import logging_utils as jax_logging
from ultra_pytorch_tpu_torch.utils import logging_utils as torch_logging


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _records(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for step in (10, 20, 30):
        out.append(("train", step, {"loss": float(rng.random()),
                                    "queries_per_sec": 1e5 * rng.random()}))
        out.append(("valid", step, {"ndcg_10": float(rng.random()),
                                    "mrr_10": np.float32(rng.random())}))
    out.append(("test", 30, {"ndcg_10": torch.tensor(0.5)}))
    return out


def _fill(logger):
    for split, step, metrics in _records():
        logger.log(split, step, metrics)
    logger.close()
    return logger


def _without_time(records):
    return [{k: v for k, v in r.items() if k != "time"} for r in records]


def _jsonl(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as fin:
        return [json.loads(line) for line in fin]


def _events(log_dir, split):
    return glob.glob(os.path.join(log_dir, split, "events.out.tfevents.*"))


def test_history_without_a_log_dir():
    ported = _fill(torch_logging.MetricLogger(None))
    reference = _fill(jax_logging.MetricLogger(None))
    assert len(ported.history) == 7
    assert _without_time(ported.history) == _without_time(reference.history)
    assert all(isinstance(r["time"], float) for r in ported.history)


@pytest.mark.parametrize("enable_tensorboard", [True, False])
def test_history_and_jsonl_equal_jax(tmp_path, enable_tensorboard):
    ported = _fill(torch_logging.MetricLogger(
        str(tmp_path / "port"), enable_tensorboard=enable_tensorboard))
    reference = _fill(jax_logging.MetricLogger(
        str(tmp_path / "jax"), enable_tensorboard=enable_tensorboard))
    assert _without_time(ported.history) == _without_time(reference.history)
    lines = _jsonl(tmp_path / "port")
    assert _without_time(lines) == _without_time(_jsonl(tmp_path / "jax"))
    assert _without_time(lines) == _without_time(ported.history)
    assert [r["split"] for r in lines] == [s for s, _, _ in _records()]


def test_no_event_files_without_tensorboard(tmp_path):
    _fill(torch_logging.MetricLogger(str(tmp_path), enable_tensorboard=False))
    assert glob.glob(str(tmp_path / "**" / "events.out.tfevents.*"),
                     recursive=True) == []
    assert os.listdir(tmp_path) == ["metrics.jsonl"]


def test_event_files_a_split_equal_jax(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    _fill(torch_logging.MetricLogger(str(tmp_path / "port")))
    _fill(jax_logging.MetricLogger(str(tmp_path / "jax")))
    for split in ("train", "valid", "test"):
        files = _events(tmp_path / "port", split)
        assert len(files) == 1, (split, files)
        scalars = {}
        for side in ("port", "jax"):
            acc = accumulator.EventAccumulator(str(tmp_path / side / split))
            acc.Reload()
            scalars[side] = {tag: [(e.step, e.value)
                                   for e in acc.Scalars(tag)]
                             for tag in acc.Tags()["scalars"]}
        assert scalars["port"] == scalars["jax"]
        expected = {}
        for s, step, metrics in _records():
            if s == split:
                for k, v in metrics.items():
                    expected.setdefault(k, []).append(
                        (step, pytest.approx(float(v), rel=1e-6)))
        assert scalars["port"] == expected


def test_writer_is_made_at_a_splits_first_record(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    logger = torch_logging.MetricLogger(str(tmp_path))
    assert logger._writers == {}
    logger.log("valid", 1, {"ndcg_10": 0.5})
    assert sorted(logger._writers) == ["valid"]
    logger.close()
    assert logger._writers == {}
    assert len(_events(tmp_path, "valid")) == 1
    assert _events(tmp_path, "train") == []
