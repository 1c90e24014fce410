"""Training metric logs and the profiler context (the port's
``utils/logging_utils.py``).

:class:`MetricLogger` appends each record of train/valid/test scalars to
``<log_dir>/metrics.jsonl``; :func:`profile_ctx` traces the enclosed
steps with ``torch.profiler``. The JAX package's in-memory history and
its optional TensorBoard writer are not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


class MetricLogger:
    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, split: str, step: int, metrics: Dict[str, float]) -> None:
        record = {"split": split, "step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None


@contextlib.contextmanager
def profile_ctx(log_dir: Optional[str]):
    """Trace the enclosed steps with ``torch.profiler`` (the CPU, and the
    card when there is one) into ``<log_dir>/trace.json``, a Chrome trace;
    nothing when `log_dir` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
