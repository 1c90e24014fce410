"""What a driver uses: a profiled span and the per-layer readers."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from perfbench import spec
from perfbench.yardstick import trace as trace_lib

# Each kernel of the port by a part of its device function's name (K2:
# its first of three launches).
KERNELS = {"K1": "mlp_fwd_kernel", "K2": "mlp_bwd_rows_kernel",
           "K3": "listwise_loss_fwd_kernel",
           "K4": "listwise_loss_bwd_kernel", "K5": "pbm_clicks_kernel"}


def profile_span(fn: Callable[[], object]) -> Optional[Dict]:
    """`fn()` under ``torch.profiler`` (host and device), inside the
    window span and ending with a synchronise; the reduced trace, or None
    when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        with record_function(trace_lib.WINDOW):
            fn()
            torch.cuda.synchronize()
    return trace_lib.reduce(prof.events(), KERNELS)


def read_metrics(cell, ctx) -> Dict[str, Dict]:
    """Every per-layer metric of the cell whose reader finds something."""
    out = {}
    for metric in cell.per_layer:
        value = spec.load_module("metrics", metric["name"]).read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out
