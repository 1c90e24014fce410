"""Philox4x32-10 uniforms in plain int64 tensor ops: the stream of the
port's PBM click sampler (its documented layout: counter i = (i mod 2^32,
i div 2^32, 0, 0) gives elements 4i .. 4i+3, each (word >> 8) * 2^-24),
written out again so the reference draws the same clicks."""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) words of m * c for a constant m < 2^32 and c < 2^32, in
    16-bit limbs so no int64 product overflows."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    c_hi, c_lo = c >> 16, c & 0xFFFF
    low = m_lo * c_lo
    mid = m_hi * c_lo + m_lo * c_hi
    high = m_hi * c_hi
    total_low = (mid << 16) + low
    return (high + (total_low >> 32)) & MASK32, total_low & MASK32


def rounds(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words (int64 tensors of words <
    2^32) under the key (k0, k1); returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(key0: int, key1: int, n: int, device) -> torch.Tensor:
    """The first `n` float32 uniforms under the key (key0, key1)."""
    counters = (n + 3) // 4
    i = torch.arange(counters, dtype=torch.int64, device=device)
    zero = torch.zeros_like(i)
    words = torch.stack(rounds(i & MASK32, i >> 32, zero, zero, key0, key1),
                        dim=-1).reshape(-1)[:n]
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
