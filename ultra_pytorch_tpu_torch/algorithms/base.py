"""Learning-algorithm protocol: ``init_state``, ``train_step``, ``score``.

The port's counterpart of the JAX package's ``algorithms/base.py``. An
algorithm owns the ranker (an ``nn.Module``) and works on a
:class:`TrainState` that holds the ranker, the optimizer state, the
algorithm's auxiliary state (DLA's propensity tower, Regression-EM's
propensity, PairDebias' and LambdaRank's t+/t-, NSGD's bad-noise memory;
``None`` for the others) and the step count. ``train_step`` updates the
tensors in place with autograd and returns the state and the step's
metrics as 0-dim device tensors (no host round trip per step).

A step is split so that each part can be driven alone: ``losses(state,
batch, ..., generator=None)`` returns a tuple whose first element is the
differentiable loss (the rest is what the aux update needs),
``trainable(state)`` the tensors it is differentiated in,
``apply_gradients`` the optimizer step and ``update_aux`` the aux state's
update from the ``losses`` tuple. Both write into the state's tensors in
place (``copy_``, ``add_``), never rebinding one, so a window captured as
a CUDA graph (``run/window.py``) replays into the same tensors.
``losses`` scores in training mode through
:meth:`BaseAlgorithm.score_with_params`, which hands the ranker the
step's generator for its dropout (SetRank at ``rate > 0``; every other
ranker, and ``rate = 0``, draws nothing, so the streams are those of a
ranker without dropout). The DBGD family takes no gradient: it overrides
``train_step`` with its own parts (``algorithms/dbgd.py``).

The optimizers follow ``make_optimizer`` of the JAX package exactly: a
clip by global norm written to optax's rule (``g / norm * max_norm`` when
``norm >= max_norm``, no 1e-6 added, unlike
``torch.nn.utils.clip_grad_norm_``), then ``ada`` (Adagrad with torch's
``g / (sqrt(acc) + eps)``), ``ada_reset`` (the accumulator reset every
step) or ``sgd``, all over ONE flat vector in JAX's ravel order
(``optax.flatten``): the leaves in JAX's tree order, each raveled in C
order, a Linear's ``w`` as ``[in, out]``. So the Adagrad accumulator is
the same vector, element for element, as the JAX checkpoint's.

Checkpoints hold the state in the JAX ``TrainState``'s leaf order: the
ranker's leaves, the flat optimizer vectors, the aux leaves (dict keys
sorted; ``None`` gives no leaf, as in ``jax.tree_util``), the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ultra_pytorch_tpu_torch.metrics import ranking as metrics_lib
from ultra_pytorch_tpu_torch.models.base import Leaf
from ultra_pytorch_tpu_torch.ops import losses
from ultra_pytorch_tpu_torch.utils import spans
from ultra_pytorch_tpu_torch.utils.checkpoint import tree_leaves
from ultra_pytorch_tpu_torch.utils.hparams import HParams

PADDING_SCORE = metrics_lib.PADDING_SCORE
ADAGRAD_EPS = 1e-10

@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module      # the ranker
    opt_state: Dict[str, torch.Tensor]
    aux: Any                     # algorithm-specific state (or None)
    step: int


def flatten_leaves(leaves: Sequence[Leaf]) -> torch.Tensor:
    """One flat float32 vector in JAX's ravel order."""
    return torch.cat([(t.t() if transposed else t).reshape(-1).float()
                      for t, transposed in leaves])


def add_flat_(leaves: Sequence[Leaf], flat: torch.Tensor) -> None:
    """``leaf += flat[its slice]`` for every leaf, in place."""
    off = 0
    with torch.no_grad():
        for t, transposed in leaves:
            n = t.numel()
            piece = flat[off: off + n]
            if transposed:
                piece = piece.view(t.shape[1], t.shape[0]).t()
            t.add_(piece.view(t.shape))
            off += n


def gradients(loss: torch.Tensor, inputs: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """``d loss / d input`` for every input; zeros for an input the loss
    does not reach (a skipped LayerNorm under ``norm=none``), as
    ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, list(inputs), allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, grads)]


def clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on one flat vector."""
    norm = torch.sqrt(torch.sum(g * g))
    return torch.where(norm < max_norm, g, (g / norm) * max_norm)


def adagrad_torch_(g: torch.Tensor, sum_of_squares: torch.Tensor,
                   learning_rate: float) -> torch.Tensor:
    """Adagrad with torch's ``g / (sqrt(acc) + eps)``: adds ``g * g`` to
    the accumulator `sum_of_squares` in place; returns the update."""
    sum_of_squares.add_(g * g)
    return -learning_rate * g / (torch.sqrt(sum_of_squares) + ADAGRAD_EPS)


def adagrad_reset(g: torch.Tensor, learning_rate: float) -> torch.Tensor:
    """Adagrad whose accumulator restarts every step (the reference DLA's
    per-step optimizer re-creation): ``-lr * g / (|g| + eps)``."""
    return -learning_rate * g / (torch.sqrt(g * g) + ADAGRAD_EPS)


class FlatOptimizer:
    """``make_optimizer`` of the JAX package on one flat vector:
    clip-by-global-norm (when ``max_gradient_norm > 0``) then ``ada``,
    ``ada_reset`` or ``sgd``."""

    def __init__(self, grad_strategy: str, learning_rate: float,
                 max_gradient_norm: float):
        self.strategy = grad_strategy
        self.lr = float(learning_rate)
        self.max_norm = float(max_gradient_norm)

    def init(self, n: int, device) -> Dict[str, torch.Tensor]:
        if self.strategy in ("sgd", "ada_reset"):
            return {}
        return {"sum_of_squares": torch.zeros(n, dtype=torch.float32,
                                              device=device)}

    def update_(self, g: torch.Tensor, state: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """The update for the flat gradient `g`; `state` is updated in
        place."""
        if self.max_norm > 0:
            g = clip_by_global_norm(g, self.max_norm)
        if self.strategy == "sgd":
            return -self.lr * g
        if self.strategy == "ada_reset":
            return adagrad_reset(g, self.lr)
        return adagrad_torch_(g, state["sum_of_squares"], self.lr)

    def step(self, leaves: Sequence[Leaf], g: torch.Tensor,
             state: Dict[str, torch.Tensor]) -> None:
        """Apply one update from the flat gradient `g` to `leaves`, and to
        the optimizer `state`, in place."""
        add_flat_(leaves, self.update_(g, state))


def flat_gradient(grads: Sequence[torch.Tensor],
                  leaves: Sequence[Leaf]) -> torch.Tensor:
    """`grads` (one a leaf of `leaves`, in the leaves' layouts) as one flat
    vector in JAX's ravel order."""
    return flatten_leaves([(gr, tr) for gr, (_, tr) in zip(grads, leaves)])


def window_plan(algorithm, feed, generator: Optional[torch.Generator],
                start, num_steps: int):
    """The window's draws in one pass (``feed.train_batch_plan`` from
    ``algorithm.per_shard(generator)``, `generator` itself on one device)
    for steps `start`, ..., `start` + `num_steps` - 1; `start` is an int or
    a 0-dim int64 tensor on the feed's device. None for a feed that cannot
    plan."""
    if not feed.can_plan():
        return None
    return feed.train_batch_plan(algorithm.per_shard(generator), start,
                                 num_steps)


def window_steps(algorithm, feed, state: TrainState,
                 generator: Optional[torch.Generator], plan,
                 num_steps: int, start):
    """`num_steps` steps of `algorithm`: step i on
    ``feed.batch_from_plan(plan, i)``, or, without a plan, on a batch the
    feed draws from ``algorithm.per_shard(generator)`` given the current
    state at step `start` + i (`start` as :func:`window_plan` takes it);
    each step takes `generator`. Returns the state, the metric names and
    their window means as one tensor (no host read)."""
    draws = algorithm.per_shard(generator)
    total, keys = None, None
    for i in range(num_steps):
        spans.mark("step.start", last=i == num_steps - 1)
        batch = (feed.batch_from_plan(plan, i) if plan is not None
                 else feed.train_batch(draws, state, start + i))
        state, metrics = algorithm.train_step(state, batch, generator)
        keys = keys or sorted(metrics)
        values = torch.stack([metrics[k] for k in keys])
        total = values if total is None else total + values
        spans.mark("step.update")
    return state, keys, total / num_steps


def train_window(algorithm, feed, state: TrainState,
                 generator: Optional[torch.Generator], num_steps: int,
                 start=None):
    """:func:`window_plan` (from `start`, default ``state.step``), then
    :func:`window_steps` on it: the window that ``run/window.py`` captures
    as one CUDA graph. Its points go to ``utils/spans.mark``: the window's
    edges, the plan's end and each step's phases (the last step's are the
    graph's stamp nodes)."""
    start = state.step if start is None else start
    spans.mark("window.start")
    plan = window_plan(algorithm, feed, generator, start, num_steps)
    spans.mark("window.plan")
    out = window_steps(algorithm, feed, state, generator, plan, num_steps,
                       start)
    spans.mark("window.end")
    return out


def make_optimizer(grad_strategy: str, learning_rate: float,
                   max_gradient_norm: float) -> FlatOptimizer:
    return FlatOptimizer(grad_strategy, learning_rate, max_gradient_norm)


def shown_ndcg(relevance: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """nDCG@L of lists ``[B, L]`` in the order shown, padded positions
    (mask 0) last and without gain."""
    L = mask.shape[1]
    shown = metrics_lib.mask_padding(
        -torch.arange(L, dtype=torch.float32, device=mask.device).expand(
            mask.shape), mask)
    return metrics_lib.normalized_discounted_cumulative_gain(
        relevance * mask, shown, None, [L])[0]


class BaseAlgorithm:
    """Shared construction and evaluation logic for learning algorithms."""

    name = "base"

    def __init__(self, ranker, exp_settings: Dict[str, Any],
                 max_label: float = 1.0):
        self.ranker = ranker
        self.exp_settings = exp_settings
        self.max_label = max_label
        self.max_candidate_num = exp_settings["max_candidate_num"]
        self.rank_list_size = exp_settings.get(
            "selection_bias_cutoff", self.max_candidate_num)
        self.hparams = HParams(**self.default_hparams())
        self.hparams.parse(exp_settings.get("learning_algorithm_hparams", ""))
        self.loss_fn = losses.LOSS_FUNCTIONS.get(
            self.hparams.get("loss_func", "softmax_loss"),
            losses.softmax_loss)
        # Bound by parallel.dp_train_steps for a data-parallel window: the
        # cross-rank mean (see sync) and this rank's shard generator (see
        # per_shard). None on one device.
        self.grad_sync = None
        self.shard_generator: Optional[torch.Generator] = None

    def default_hparams(self) -> Dict[str, Any]:
        return {
            "learning_rate": 0.05,
            "max_gradient_norm": 5.0,
            "loss_func": "softmax_loss",
            "l2_loss": 0.0,
            "grad_strategy": "ada",
        }

    @property
    def device(self) -> torch.device:
        return next(self.ranker.parameters()).device

    def optimizer(self) -> FlatOptimizer:
        hp = self.hparams
        return make_optimizer(hp.get("grad_strategy", "ada"),
                              float(hp.get("learning_rate", 0.05)),
                              float(hp.get("max_gradient_norm", 5.0)))

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Draw the ranker's weights from `generator` (a CPU generator, so
        they are the same on every device); a fresh flat optimizer state,
        no aux state, step 0."""
        self.ranker.reset_parameters(generator)
        n = sum(p.numel() for p in self.ranker.parameters())
        return TrainState(params=self.ranker,
                          opt_state=self.optimizer().init(n, self.device),
                          aux=None, step=0)

    # -- a step, in parts -------------------------------------------------
    def losses(self, state: TrainState, batch: Dict[str, torch.Tensor],
               *, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, ...]:
        """(loss, ...): the differentiable loss first, then whatever
        :meth:`update_aux` needs; `generator` goes to
        :meth:`score_with_params`."""
        raise NotImplementedError

    def trainable(self, state: TrainState) -> List[torch.Tensor]:
        """The tensors the loss is differentiated in: the ranker's, in
        JAX's leaf order."""
        return [t for t, _ in state.params.jax_leaves()]

    def apply_gradients(self, state: TrainState,
                        grads: Sequence[torch.Tensor]) -> TrainState:
        """One optimizer step (`grads` in :meth:`trainable` order, averaged
        over the ranks as one flat vector before the clip), in place;
        advances the step."""
        leaves = state.params.jax_leaves()
        self.optimizer().step(leaves, self.sync(flat_gradient(grads, leaves)),
                              state.opt_state)
        state.step += 1
        return state

    def update_aux(self, state: TrainState, out: Tuple[torch.Tensor, ...]
                   ) -> TrainState:
        """The aux state's update from :meth:`losses`' tuple, after the
        optimizer step; none by default."""
        return state

    def metrics(self, out: Tuple[torch.Tensor, ...]
                ) -> Dict[str, torch.Tensor]:
        return {"loss": out[0].detach()}

    def _step(self, state: TrainState, batch: Dict[str, torch.Tensor],
              *extra, generator: Optional[torch.Generator] = None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        out = self.losses(state, batch, *extra, generator=generator)
        spans.mark("step.forward")
        grads = gradients(out[0], self.trainable(state))
        spans.mark("step.backward")
        state = self.update_aux(self.apply_gradients(state, grads), out)
        return state, self.metrics(out)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step. `generator` is the window's device generator, the
        same on every rank; the draws of one example (the ranker's dropout
        masks, and an algorithm's own per-example draws before them) come
        from ``per_shard(generator)``, in step order."""
        return self._step(state, batch, generator=self.per_shard(generator))

    # -- data parallelism -------------------------------------------------
    def sync(self, x):
        """The mean over the ranks of a tensor (or a list of tensors) under
        data parallelism; `x` itself on one device."""
        return x if self.grad_sync is None else self.grad_sync(x)

    def per_shard(self, generator: Optional[torch.Generator]
                  ) -> Optional[torch.Generator]:
        """The generator of this rank's own draws: the shard generator
        under data parallelism, `generator` itself on one device."""
        if self.shard_generator is None:
            return generator
        return self.shard_generator

    # -- checkpoint layout ------------------------------------------------
    def _state_targets(self, state: TrainState) -> List[Leaf]:
        """The state's tensors in the JAX TrainState's leaf order (the
        step follows)."""
        return (state.params.jax_leaves()
                + [(t, False) for t in tree_leaves(state.opt_state)]
                + [(t, False) for t in tree_leaves(state.aux)])

    def state_tensors(self, state: TrainState) -> List[torch.Tensor]:
        """The state's tensors, each as it lies (the tensors that a step
        updates in place), in the checkpoint's leaf order."""
        return [t for t, _ in self._state_targets(state)]

    def state_leaves(self, state: TrainState,
                     snapshot: Optional[Tuple[Sequence[torch.Tensor], int]]
                     = None) -> List[Any]:
        """The state as numpy arrays in JAX's leaf order and layouts; with
        `snapshot` (a copy of :meth:`state_tensors` and the step it was
        taken at), that in place of the live state."""
        targets = self._state_targets(state)
        tensors, step = snapshot or ([t for t, _ in targets], state.step)
        return [(t.t() if transposed else t).detach().cpu().numpy().copy()
                for t, (_, transposed) in zip(tensors, targets)] + [
                    np.asarray(step, np.int32)]

    def load_state_leaves(self, state: TrainState, leaves: List[Any]
                          ) -> TrainState:
        """Copy `leaves` (numpy, JAX's leaf order and layouts) into
        `state`; returns it."""
        it = iter(leaves)
        with torch.no_grad():
            for t, transposed in self._state_targets(state):
                src = torch.as_tensor(np.array(next(it)))
                t.copy_(src.t() if transposed else src.reshape(t.shape))
        state.step = int(np.asarray(next(it)))
        return state

    # -- shared helpers ---------------------------------------------------
    @torch.no_grad()
    def score(self, state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """Eval-mode scoring of a full candidate list."""
        return state.params(batch["features"], batch.get("mask"))

    def score_with_params(self, params: torch.nn.Module,
                          batch: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator] = None,
                          training: bool = True) -> torch.Tensor:
        """Scoring with `params` (a ranker), in training mode unless
        `training` is false: the ranker's dropout (if any) draws from
        `generator`; without one, a ranker with ``rate > 0`` raises."""
        return params(batch["features"], batch.get("mask"),
                      generator=generator, training=training)

    def validation_metrics(self, state: TrainState,
                           batch: Dict[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scores and the experiment's ``metrics x metrics_topn`` summary;
        with a `generator`, tied scores are ordered at random."""
        output = self.score(state, batch)
        summary = metrics_lib.evaluate(
            batch["labels"], output,
            self.exp_settings.get("metrics", ["mrr", "ndcg"]),
            self.exp_settings.get("metrics_topn", [3, 5, 10]),
            max_label=self.max_label, mask=batch.get("mask"),
            generator=generator)
        return output, summary

    def online_reward_metric(self, batch: Dict[str, torch.Tensor]
                             ) -> Optional[Dict[str, torch.Tensor]]:
        """The shown list's online metrics when the batch came from an
        online feed (which attaches ``relevance``, the true labels in
        shown order): ``online_reward``, the mean clicks a list, and
        ``online_ndcg``, the nDCG@L of the shown order against
        ``relevance``. None for any other batch."""
        if "relevance" not in batch:
            return None
        L = self.rank_list_size
        mask = batch["mask"][:, :L]
        clicks = batch["labels"][:, :L] * mask
        reward, ndcg = self.sync(torch.stack([
            clicks.sum(dim=1).mean(),
            shown_ndcg(batch["relevance"][:, :L], mask)])).unbind(0)
        return {"online_reward": reward, "online_ndcg": ndcg}

    def l2_penalty(self, params: Sequence[torch.Tensor]) -> torch.Tensor:
        l2 = float(self.hparams.get("l2_loss", 0.0))
        if l2 > 0:
            return l2 * losses.l2_loss(params)
        return torch.zeros((), device=self.device)

    def train_slice(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Cut a batch to the top-``rank_list_size`` training list."""
        L = self.rank_list_size
        if batch["labels"].shape[1] <= L:
            return batch
        return {k: (v[:, :L] if v.dim() >= 2 else v)
                for k, v in batch.items()}
