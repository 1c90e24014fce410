"""Inputs made from the run's seed: the training table and grades on the
device."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

DATA_TAG = 0xD474


def training_data(cfg: Dict, seed: int, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Features [queries x list_length, F] (standard normal; query q's
    documents are rows q * list_length ..) and grades [queries,
    list_length] (uniform over 0..max_grade), both float32."""
    gen = torch.Generator(device=device).manual_seed(seed ^ DATA_TAG)
    q, n, f = cfg["queries"], cfg["list_length"], cfg["features"]
    table = torch.randn((q * n, f), generator=gen, device=device)
    grades = torch.randint(0, cfg["max_grade"] + 1, (q, n), generator=gen,
                           device=device).to(torch.float32)
    return table, grades

