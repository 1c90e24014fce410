"""Training metric logs (the port's ``utils/logging_utils.py``).

:class:`MetricLogger` appends each record of train/valid/test scalars to
``<log_dir>/metrics.jsonl``. The JAX package's in-memory history, its
optional TensorBoard writer and its profiler context are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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
