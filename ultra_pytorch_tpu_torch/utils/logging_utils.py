"""Training metric logs and the profiler context (the port's
``utils/logging_utils.py``).

:class:`MetricLogger` keeps every record of train/valid/test scalars in
an in-memory ``history``, appends it to ``<log_dir>/metrics.jsonl`` and,
where ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package), writes it as scalars to one TensorBoard writer a split under
``<log_dir>/<split>``, as the JAX package's logger does;
:func:`profile_ctx` traces the enclosed steps with ``torch.profiler``
and writes the process's spans (``utils/spans.py``) beside the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

from ultra_pytorch_tpu_torch.utils import spans


class MetricLogger:
    """`history` holds every record, also without a `log_dir`; with one,
    the JSONL file and (with `enable_tensorboard`, where the writer
    imports) the TensorBoard writers."""

    def __init__(self, log_dir: Optional[str],
                 enable_tensorboard: bool = True):
        self.log_dir = log_dir
        self.history: List[Dict[str, float]] = []
        self._writers = {}
        self._jsonl = None
        self._tb_cls = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if enable_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:   # no tensorboard package
                    SummaryWriter = None
                self._tb_cls = SummaryWriter

    def _writer(self, split: str):
        """The split's writer, made at its first record; None without
        one."""
        if self._tb_cls is None:
            return None
        if split not in self._writers:
            self._writers[split] = self._tb_cls(
                log_dir=os.path.join(self.log_dir, split))
        return self._writers[split]

    def log(self, split: str, step: int, metrics: Dict[str, float]) -> None:
        record = {"split": split, "step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self.history.append(record)
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        writer = self._writer(split)
        if writer is not None:
            for k, v in metrics.items():
                writer.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        for writer in self._writers.values():
            writer.close()
        self._writers = {}


@contextlib.contextmanager
def profile_ctx(log_dir: Optional[str]):
    """Trace the enclosed steps with ``torch.profiler`` (the CPU, and the
    card when there is one) into ``<log_dir>/trace.json``, a Chrome trace
    that holds the program's ranges (``utils/spans.py``), and write
    ``spans.snapshot()`` to ``<log_dir>/spans.json``; nothing when
    `log_dir` is empty."""
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
    with open(os.path.join(log_dir, "spans.json"), "w") as fout:
        json.dump(spans.snapshot(), fout)
