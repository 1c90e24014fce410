"""Initial weights from the run's seed, made on the device in one draw.

A reference module gives its parameter tree as specs ``(kind, shape,
fan_in)``: ``"uniform"`` leaves are U(-1/sqrt(fan_in), 1/sqrt(fan_in))
(torch's default ``nn.Linear`` initialisation), ``"ones"`` and
``"zeros"`` are LayerNorm's scale and bias. Every uniform leaf is a slice
of one ``torch.rand`` from a device generator seeded with the run's seed.
The same tree goes to the program and to the reference."""

from __future__ import annotations

import math
from typing import Any

import torch

from perfbench.yardstick.trees import flatten, map_tree

WEIGHTS_TAG = 0x3E16


def make(spec_tree: Any, seed: int, device) -> Any:
    """The tree of float32 tensors that `spec_tree` describes."""
    specs = [spec for _, spec in flatten(spec_tree)]
    total = sum(math.prod(shape) for kind, shape, _ in specs
                if kind == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed ^ WEIGHTS_TAG)
    draw = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    offset = 0

    def leaf(spec):
        nonlocal offset
        kind, shape, fan_in = spec
        if kind == "ones":
            return torch.ones(shape, device=device)
        if kind == "zeros":
            return torch.zeros(shape, device=device)
        n = math.prod(shape)
        out = draw[offset:offset + n].reshape(shape) / math.sqrt(fan_in)
        offset += n
        return out.contiguous()

    return map_tree(leaf, spec_tree)
