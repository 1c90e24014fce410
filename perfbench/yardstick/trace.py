"""Reduce a ``torch.profiler`` trace to the device's busy time, the idle
gaps and the operations that took the most time.

The window is the host span named :data:`WINDOW` (a
``torch.profiler.record_function`` the driver puts around the profiled
work, its final synchronise included). Busy time is the union of the
device's activity intervals (kernels, copies, sets) inside it; an idle
gap is a stretch of the window with no device activity, named by the
innermost host operation running at its middle."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "perfbench.traced_window"
TOP = 10


def _device_and_host(events) -> Tuple[list, list]:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        annotation = getattr(e, "is_user_annotation", False)
        if e.device_type == DeviceType.CUDA:
            if not annotation and not e.name.startswith("perfbench."):
                device.append(e)
        else:
            host.append(e)
    return device, host


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def reduce(events, kernel_names: Optional[Dict[str, str]] = None) -> Optional[Dict]:
    """``busy_s``, ``window_s``, the ``breakdown`` (device ops and idle
    gaps by host operation, each at most ten ``[name, seconds]``) and, for
    each of `kernel_names` (label -> a substring of its device function's
    name), the records found; None when the window or every device
    record is missing."""
    device, host = _device_and_host(events)
    windows = [e for e in host if e.name == WINDOW]
    if not windows or not device:
        print(f"trace: {len(windows)} window span(s), {len(device)} device "
              f"record(s), {len(host)} host record(s): nothing to reduce",
              file=sys.stderr)
        return None
    w0 = windows[0].time_range.start
    w1 = windows[0].time_range.end
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in device]
    intervals = [(a, b) for a, b in intervals if b > a]
    busy = _union(intervals)
    busy_us = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = {}
    for e in device:
        name = _short(e.name)
        by_op[name] = by_op.get(name, 0.0) + e.time_range.elapsed_us()
    gaps, cursor = [], w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if w1 > cursor:
        gaps.append((cursor, w1))
    by_host = _gaps_by_host(gaps, [e for e in host if e.name != WINDOW])
    records = {label: sum(1 for e in device if part in e.name)
               for label, part in (kernel_names or {}).items()}
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_records": len(device),
        "kernel_records": records,
        "breakdown": {
            "device_ops": [[n, us / 1e6] for n, us in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[n, us / 1e6] for n, us in sorted(
                by_host.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def _gaps_by_host(gaps: Sequence[Tuple[float, float]], host) -> Dict[str, float]:
    """Total gap time by the innermost host operation at each gap's
    middle (latest start among those that cover it)."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host)
    totals: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= mid]
        name = "host: no operation of the profiled thread"
        if active:
            name = "host: " + _short(active[-1][2])
        totals[name] = totals.get(name, 0.0) + (b - a)
    return totals
