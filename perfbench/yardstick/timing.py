"""Device time of one call, by CUDA events over a graph of repeated
calls (no host launch cost inside the timed replays)."""

from __future__ import annotations

from typing import Callable

import torch


def graph_seconds(fn: Callable[[], object], repeats: int = 20,
                  replays: int = 10) -> float:
    """Seconds a call of `fn` takes on the card: `repeats` calls captured
    as one CUDA graph (after three warm-up calls on a side stream),
    replayed `replays` times between two events after one untimed
    replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / (repeats * replays)
