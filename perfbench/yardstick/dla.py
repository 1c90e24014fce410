"""DLA training, plain: the step that the reference follows.

One step, as ULTRA's DLA defines it over the top-L list of each query:
the ranker's scores; the propensity tower's logits elu(w + b) over the L
positions; inverse-propensity weights p_0 / p_i from the softmax of the
tower's logits and relevance weights from the softmax of the scores,
both without gradient; the loss exam_loss + rank_loss, each ULTRA's
propensity-weighted softmax cross entropy over the clicks of the lists
that got one. Then, for each tower apart, the gradient clipped to the
global norm ``max_gradient_norm`` and an Adagrad step (accumulator
starting at zero, update -lr g / (sqrt(acc) + 1e-10)).

:func:`follow` runs the steps of a run's first windows from the run's
seed and reads what the check compares. Alone it runs from its own
states; given the states another run reached (the program's), it
shadows that run: each of the first three steps, and the first full
window, starts from the state the other run had there, so every step is
judged by itself and no step carries an earlier step's rounding on.
`fault` plants one of the faults the check has to catch, in place of the
program: ``unchanged`` (no update), ``half_batch`` (the loss over the
first half of each batch only)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.yardstick.clicks import ClickDraws
from perfbench.yardstick.trees import flatten

ADAGRAD_EPS = 1e-10
CHECK_STEPS = 3
# (every leaf, every Adagrad accumulator), each in the leaves' order.
State = Tuple[List[torch.Tensor], List[torch.Tensor]]


def softmax_loss(scores: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ULTRA's softmax loss: each list's label distribution (labels +
    1e-7, weighted) against the softmax of its scores, weighted by the
    list's total label weight, over the total weight; masked positions
    carry no label and score -1e9."""
    weighted = (labels + 1e-7) * weights * mask
    scores = torch.where(mask > 0, scores, torch.full_like(scores, -1e9))
    denom = weighted.sum(dim=1, keepdim=True)
    dist = torch.where(denom > 0, weighted / torch.where(
        denom > 0, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    per_list = -(dist * F.log_softmax(scores, dim=-1)).sum(dim=1)
    total = weighted.sum()
    return (per_list * denom.squeeze(1)).sum() / torch.where(
        total > 0, total, torch.ones_like(total))


def dla_loss(scores: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             clicks: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exam_loss + rank_loss of one batch."""
    tower = F.elu(w + b)[None, :].expand(clicks.shape)
    p = torch.softmax(tower, dim=-1)
    ipw = (p[:, :1] / p).detach()
    q = torch.softmax(scores, dim=-1)
    relevance = (q[:, :1] / q).detach()
    return (softmax_loss(tower, clicks, relevance, mask)
            + softmax_loss(scores, clicks, ipw, mask))


class PlainDLA:
    """Both towers' leaves and Adagrad accumulators, stepped in place."""

    def __init__(self, forward: Callable, ranker: Dict, propensity: Dict,
                 learning_rate: float, max_gradient_norm: float,
                 fault: Optional[str] = None):
        self.forward = forward
        self.ranker = {k: v for k, v in ranker.items()}
        self.ranker_leaves = [t.detach().clone().requires_grad_(True)
                              for _, t in flatten(ranker)]
        self.tree_paths = [p for p, _ in flatten(ranker)]
        self.prop = [propensity["b"].detach().clone().requires_grad_(True),
                     propensity["w"].detach().clone().requires_grad_(True)]
        self.towers = [self.ranker_leaves, self.prop]
        self.acc = [[torch.zeros_like(t) for t in tower]
                    for tower in self.towers]
        self.lr, self.max_norm, self.fault = (learning_rate,
                                              max_gradient_norm, fault)

    def leaves(self) -> List[torch.Tensor]:
        """Every leaf: the ranker's in tree order, then b and w."""
        return self.ranker_leaves + self.prop

    def accumulators(self) -> List[torch.Tensor]:
        return self.acc[0] + self.acc[1]

    def state(self) -> State:
        """A copy of every leaf and every accumulator."""
        return ([t.detach().clone() for t in self.leaves()],
                [a.clone() for a in self.accumulators()])

    def load(self, state: State) -> None:
        """Every leaf and accumulator from `state` (tensors in the leaves'
        order and shapes, on any device)."""
        with torch.no_grad():
            for t, v in zip(self.leaves() + self.accumulators(),
                            state[0] + state[1]):
                t.copy_(torch.as_tensor(v).reshape(t.shape))

    def _tree(self):
        it = iter(self.ranker_leaves)

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            if isinstance(node, (list, tuple)):
                return [build(sub) for sub in node]
            return next(it)

        return build(self.ranker)

    def step(self, x: torch.Tensor, clicks: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """One step on features [B, L, F]; returns the loss."""
        if self.fault == "half_batch":
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
        scores = self.forward(self._tree(), x, mask)
        loss = dla_loss(scores, self.prop[1], self.prop[0], clicks, mask)
        grads = torch.autograd.grad(loss, self.leaves())
        if self.fault == "unchanged":
            return loss.detach()
        n = len(self.ranker_leaves)
        with torch.no_grad():
            for tower, acc, g in zip(self.towers, self.acc,
                                     (grads[:n], grads[n:])):
                norm = torch.sqrt(sum((gi * gi).sum() for gi in g))
                scale = torch.where(norm < self.max_norm,
                                    torch.ones_like(norm),
                                    self.max_norm / norm)
                for t, a, gi in zip(tower, acc, g):
                    gi = gi * scale
                    a.add_(gi * gi)
                    t.add_(-self.lr * gi / (torch.sqrt(a) + ADAGRAD_EPS))
        return loss.detach()


def batch_features(table: torch.Tensor, list_length: int, qs: torch.Tensor,
                   cutoff: int) -> torch.Tensor:
    """The top-`cutoff` documents' features of queries `qs`: query q's
    documents are rows q * list_length .. of the table."""
    rows = qs[:, None] * list_length + torch.arange(cutoff,
                                                    device=qs.device)
    return table[rows]


def leaf_norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def follow(cfg: Dict, table: torch.Tensor, labels: torch.Tensor,
           ranker: Dict, propensity: Dict, forward: Callable,
           seeds: Sequence[int], window_steps: int, philox_clicks: bool,
           fault: Optional[str] = None,
           shadow: Optional[Sequence[State]] = None) -> Dict:
    """The run's first three one-step windows (seeds[0:3]) and its first
    window of `window_steps` steps (seeds[3]), plain; with `shadow` (the
    states another run had after each of the three steps) each step and
    the window start from that run's state before them. Returns each
    step's loss, every leaf's first-gradient norm (from the accumulators
    after one step), every leaf's change after three steps, the window's
    mean loss, the states after each step and the leaves' paths."""
    cutoff = cfg["selection_bias_cutoff"]
    draws = ClickDraws(cfg, labels[:, :cutoff], philox_clicks)
    hp = cfg["algorithm_hparams"]
    run = PlainDLA(forward, ranker, propensity, hp["learning_rate"],
                   hp["max_gradient_norm"], fault)
    start = run.state()

    def step(qs, clicks, valid):
        x = batch_features(table, cfg["list_length"], qs, cutoff)
        mask = valid[:, None].to(torch.float32).expand(clicks.shape)
        return run.step(x, clicks, mask)

    losses, grad_norms, states = [], None, []
    for k, seed in enumerate(seeds[:CHECK_STEPS]):
        if shadow is not None:
            run.load(shadow[k - 1] if k else start)
        losses.append(float(step(*draws.window(seed, 1)[0])))
        if grad_norms is None:
            grad_norms = [float(a.double().sum()) ** 0.5
                          for a in run.accumulators()]
        states.append(run.state())
    change = leaf_norms([t - s for t, s in zip(states[-1][0], start[0])])
    if shadow is not None:
        run.load(shadow[-1])
    window = [step(*d) for d in draws.window(seeds[CHECK_STEPS],
                                             window_steps)]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change,
            "window_loss": float(torch.stack(window).mean()),
            "states": states,
            "leaves": run.tree_paths + ["/propensity/b", "/propensity/w"],
            "pool": draws.pool}
