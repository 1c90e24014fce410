"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's, and the limits they are held to.

:func:`training_gaps`: ``loss_gap``, the worst relative gap of the three
checked steps' losses; ``grad_gap``, the worst leaf's gap between the
first gradients' norms (as the optimizer got them, read from its
accumulators after one step); ``change_gap``, the worst leaf's gap
between the norms of the change after three steps, and
``median_change_gap`` the median leaf's; ``window_loss_gap``, the
relative gap of the first full window's mean loss. A leaf's gap is
measured against the reference's norm of that leaf or of the median
leaf, whichever is larger. ``change_gap`` leaves out the leaves whose
first gradient in the reference is under a thousandth of the median
leaf's: under softmax a constant added to every score of a list has no
gradient, so Adagrad moves such a leaf by round-off alone.

The reference shadows the program (``yardstick/dla.py``): each step
starts from the program's state before it, so no step carries an earlier
step's rounding on. A cell compares the numbers its limits name. Where a
ranker has relu units, a unit whose input lies within rounding of zero
on some row gets its gradient from that row on one side and not on the
other, and Adagrad's division by the accumulated square turns that into
a visible change of that unit's weights: the float32 reference departs
from itself in float64 by as much on the leaf feeding the output. There
the median leaf's change is compared, which such a unit does not move."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import numpy as np

NEGLIGIBLE_GRADIENT = 1e-3


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool]) -> List[float]:
    """Each kept leaf's gap (see the module doc)."""
    median = statistics.median([r for r, k in zip(ref, keep) if k])
    return [abs(p - r) / max(r, median)
            for p, r, k in zip(prog, ref, keep) if k]


def moving_leaves(ref_grad_norms: Sequence[float]) -> List[bool]:
    """Which leaves the change is compared on (see the module doc)."""
    median = statistics.median(ref_grad_norms)
    return [n >= NEGLIGIBLE_GRADIENT * median for n in ref_grad_norms]


def training_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The four training numbers of `prog` against `ref` (each a
    ``yardstick.dla.follow``-shaped reading)."""
    everything = [True] * len(ref["grad_norms"])
    changes = leaf_gaps(prog["change_norms"], ref["change_norms"],
                         moving_leaves(ref["grad_norms"]))
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(prog["losses"], ref["losses"])),
        "grad_gap": max(leaf_gaps(prog["grad_norms"], ref["grad_norms"],
                                   everything)),
        "change_gap": max(changes),
        "median_change_gap": statistics.median(changes),
        "window_loss_gap": (abs(prog["window_loss"] - ref["window_loss"])
                            / abs(ref["window_loss"])),
    }


def judge(gaps: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number that has a limit is finite and within it (a
    cell compares the numbers its limits name)."""
    return all(name in gaps and np.isfinite(gaps[name])
               and gaps[name] <= limit for name, limit in limits.items())
