"""What every DLA step counts outside the ranker (a copy of the port's
``tools/roofline.py`` arithmetic): the two softmax losses and their
gradients as K3/K4 count them, the weights each tower's softmax makes
and both towers' clip and Adagrad."""

from __future__ import annotations

WEIGHTS_OPS = 6   # a list element's softmax (exp, sum, divide), ratio, clip
ADAGRAD_OPS = 10  # a parameter's norm, clip, accumulator, root, update


def loss_work(batch: int, length: int):
    """(K3 operations, K3 bytes, K4 operations, K4 bytes) at [batch,
    length]: ~11 operations an element forward, ~10 backward; K3 reads
    four inputs and writes the loss and its residual, K4 reads the inputs,
    the residual and g and writes ds."""
    elems, stats = batch * length, 8 * batch + 4
    return (11 * elems, 16 * elems + stats + 4, 10 * elems,
            20 * elems + stats + 4)


def outside_ranker(batch: int, length: int, ranker_params: int) -> int:
    """Operations of a step outside the ranker: both losses forward and
    backward, both towers' weights, both optimizers."""
    k3, _, k4, _ = loss_work(batch, length)
    params = ranker_params + length + 1
    return 2 * (k3 + k4) + WEIGHTS_OPS * 2 * batch * length + (
        ADAGRAD_OPS * params)
