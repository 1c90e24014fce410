"""Team-draft multileaving, vectorised over the batch.

The port's counterpart of the JAX package's ``sim/interleave.py``, split
in two:

* :func:`round_assignments` draws the drafting order: independent random
  permutations of the R rankers, concatenated per item (one ``torch.rand``
  from the generator, argsorted);
* :func:`draft` is deterministic given that order: a common prefix shared
  by every input ranking comes first with no team (-1); then each
  position's drafting ranker contributes the first document at or after
  its pointer that is not yet used, and its pointer moves past it.

Position m of the draft depends only on positions below m, so
:func:`draft` stops at ``positions`` (the click cutoff, where every
caller stops reading): the first ``positions`` entries equal the JAX
draft over the whole list. :func:`team_draft_interleave` composes the two
over a whole list, as the JAX package's function of that name does;
:func:`infer_winners` gives each ranker's share of the clicks.
"""

from __future__ import annotations

from typing import Tuple

import torch


def round_assignments(generator: torch.Generator, batch: int,
                      n_rankers: int, length: int) -> torch.Tensor:
    """Drafting order ``[batch, length]`` (int64): per item, independent
    random permutations of ``range(n_rankers)`` concatenated."""
    rounds = -(-length // n_rankers) + 1
    u = torch.rand((batch, rounds, n_rankers), generator=generator,
                   device=generator.device)
    return u.argsort(dim=-1).reshape(batch, -1)[:, :length]


def draft(rankings: torch.Tensor, assignments: torch.Tensor,
          positions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multileave ``rankings [B, R, Lc]`` (each row a permutation of the
    document slots) in the order ``assignments [B, >= positions]``.

    Returns (multileaved ``[B, positions]`` document slots, teams ``[B,
    positions]`` with -1 in the common prefix), both int64."""
    B, R, Lc = rankings.shape
    rankings = rankings.long()
    device = rankings.device
    rows = torch.arange(B, device=device)
    pos_idx = torch.arange(Lc, device=device)
    agree = (rankings == rankings[:, :1]).all(dim=1)             # [B, Lc]
    prefix_len = agree.long().cumprod(dim=1).sum(dim=1)           # [B]
    used = torch.zeros((B, Lc), dtype=torch.bool, device=device)
    # A device tensor to write into `used`: a Python True would be copied
    # from the host each step, which a captured window cannot do.
    taken = torch.ones(B, dtype=torch.bool, device=device)
    ptrs = torch.zeros((B, R), dtype=torch.long, device=device)
    docs, teams = [], []
    for m in range(positions):
        in_prefix = m < prefix_len
        team = torch.where(in_prefix, 0, assignments[:, m].long())
        row = rankings[rows, team]                                 # [B, Lc]
        cand = (pos_idx >= ptrs[rows, team][:, None]) & ~torch.gather(
            used, 1, row)
        # The first candidate (argmax over an integer cast returns the
        # first maximum; there always is one, since every position below
        # the pointer is used).
        j = torch.argmax(cand.to(torch.int8), dim=1)
        doc = torch.where(in_prefix, rankings[:, 0, m], row[rows, j])
        used[rows, doc] = taken
        moved = ptrs.clone()
        moved[rows, team] = j + 1
        ptrs = torch.where(in_prefix[:, None], ptrs.clamp_min(m + 1), moved)
        docs.append(doc)
        teams.append(torch.where(in_prefix, -1, team))
    return torch.stack(docs, dim=1), torch.stack(teams, dim=1)


def team_draft_interleave(generator: torch.Generator, rankings: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multileave ``rankings [B, R, L]`` over all L positions, in a
    drafting order drawn from `generator`: (multileaved ``[B, L]``
    document slots, teams ``[B, L]`` with -1 in the common prefix)."""
    B, R, L = rankings.shape
    return draft(rankings, round_assignments(generator, B, R, L), L)


def infer_winners(teams: torch.Tensor, clicks: torch.Tensor,
                  n_rankers: int) -> torch.Tensor:
    """Each ranker's click share ``[B, n_rankers]`` (sums to at most 1 an
    item) from ``teams [B, L]`` and ``clicks [B, L]``."""
    team_ids = torch.arange(n_rankers, device=teams.device)[None, :, None]
    credit = (teams[:, None, :] == team_ids) * clicks[:, None, :]
    ranker_clicks = credit.sum(dim=2)
    return ranker_clicks / (ranker_clicks.sum(dim=1, keepdim=True) + 1e-7)
