"""The data key schedule of a training run: which seed each window's
generator gets. A frozen copy of ``Experiment``'s documented schedule
(the run's seed XOR a tag gives the first key's words; a window's seed
is its key's word pairs XORed; the next key is drawn from that seed), so
the reference draws what the program draws without asking it."""

from __future__ import annotations

from typing import List

import torch

DATA_KEY_TAG = 0xDA7A
NEXT_KEY_TAG = 0x4E58


def _words(seed: int, n: int) -> List[int]:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 32, (n,), generator=gen).tolist()


def _key_seed(key: List[int]) -> int:
    seed = 0
    for hi, lo in zip(key[0::2], key[1::2]):
        seed ^= (hi << 32) | lo
    return seed


def window_seeds(run_seed: int, count: int, words: int = 2) -> List[int]:
    """The generator seeds of a run's first `count` windows."""
    key = _words(run_seed ^ DATA_KEY_TAG, words)
    seeds = []
    for _ in range(count):
        seed = _key_seed(key)
        seeds.append(seed)
        key = _words(seed ^ NEXT_KEY_TAG, words)
    return seeds
