"""MGD, ULTRA's multileave online learner, plain: the step that the
reference follows, and the numbers that decide a cell's ``correct``.

One step over B queries, as ULTRA's ``ultra/learning_algorithm/mgd.py``
and ``dbgd.py`` define it with the stochastic online feed
(``ultra/input_layer``), drawn from one generator in this order:

* the feed: B queries; the current ranker's scores of each whole list;
  a Plackett-Luce ranking at the feed's tau (keys ``tau s - log(-log
  u)``, ties kept in index order); 1 + 16 rounds of click uniforms on
  the top L positions under the click model, each list keeping its first
  round with a click, a list with none masked out; the batch in ranked
  order, its labels the clicks (zero past L);
* the noises: for each perturbed leaf (a Linear's weight and bias, never
  a LayerNorm's) one ``randn`` of ``ranker_num`` draws in ``nn.Linear``'s
  own layout, a weight's ``[R, out, in]``, each output unit's weights
  (a bias as a whole) scaled to unit norm;
* the scores of the current ranker and of each candidate, ``params +
  learning_rate * noise_r``, over the batch's whole lists;
* a Plackett-Luce ranking of each of the 1 + R rankers at the
  algorithm's tau; the drafting order (per query, independent random
  permutations of the rankers, concatenated, from one ``rand`` of ``[B,
  rounds, R + 1]`` argsorted); a team-draft multileave of the L shown
  positions (a prefix on which every ranking agrees is shown first and
  credits nobody; then the ranker whose turn it is adds its highest
  ranked document not yet shown); 1 + 16 rounds of click uniforms on
  the shown list, the algorithm's own click model judging the batch's
  labels (the feed's clicks) there;
* the credit: each ranker's share of a query's clicks on the documents
  it added, averaged over the batch; the update ``params -= lr *
  clip(sum_r share_{r+1} noise_r)`` (SGD, the global norm clipped at
  ``max_gradient_norm``), as ULTRA writes the credit-weighted noise into
  the parameters' gradient before its optimizer's step.

The reported loss is ``1 - nDCG@L`` of the current ranker's scores of
the batch's first L documents against its labels (the clicks), a list
without a click counting 0.

Where the port departs from ULTRA's torch code, and this reference
follows the port: the candidates are the current ranker plus the scaled
noise (``candidate_source=perturb``, as the DBGD and MGD papers have
it), where ULTRA's torch code perturbs a freshly initialised ranker
instance; and a clickless list is drawn again at most 16 times, in the
feed and in the comparison alike, where ULTRA redraws up to 100 times.

:func:`follow` runs the steps of a run's first windows from the run's
seed. Given the states another run reached (the program's), it shadows
that run as ``yardstick/dla.py`` does: each of the three checked steps,
and the first full window, starts from the state the other run had
there. Given also the scores that run's own checked steps produced
(`recorded`: the feed's pass, then the current ranker's and each
candidate's), it decides each checked step's rankings, draft, clicks and
credit from them, and holds its plain forward to them; given that run's
scoring (`score_program`), it decides the window's steps from it. So a
flip between two near-tied keys of a Plackett-Luce ranking, which is
rounding, cannot move the credit it compares nor part the two windows;
it counts the checked steps' queries whose decisions its own scores
would have changed. `fault` plants a fault the check has to catch:
``unchanged`` (no update)."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.yardstick.clicks import PBM_EXAM, click_model_json
from perfbench.yardstick.trees import flatten

CHECK_STEPS = 3
RESAMPLE_ROUNDS = 16
NEG_INF = -1e9
SHARE_EPS = 1e-7


def _stream(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class ClickModel:
    """The configuration's PBM: P(click) = exam[rank] * click_prob[grade]
    on the top L positions."""

    def __init__(self, cfg: Dict, length: int, device):
        model = click_model_json(cfg)
        self.click_prob = torch.tensor(model["click_prob"],
                                       dtype=torch.float32, device=device)
        exam = torch.tensor(PBM_EXAM, dtype=torch.float32, device=device)
        exam = exam ** torch.tensor(float(model["eta"]), device=device)
        self.exam = exam[torch.clamp(torch.arange(length, device=device),
                                     max=len(PBM_EXAM) - 1)]

    def clicks(self, labels: torch.Tensor, mask: torch.Tensor,
               u: torch.Tensor):
        """(clicks [B, L], whether a round clicked [B]) of lists with
        `labels` and `mask` [B, L] from uniforms ``u [rounds, B, L]``:
        each list's first round with a click, round 0 where none has one."""
        grades = torch.clamp(labels.to(torch.int64), 0,
                             self.click_prob.shape[0] - 1)
        probs = self.exam * self.click_prob[grades]
        every = (u < probs).to(torch.float32) * mask
        clicked = every.sum(dim=-1) > 0                       # [rounds, B]
        first = torch.argmax(clicked.to(torch.int8), dim=0)
        rows = torch.arange(u.shape[1], device=u.device)
        return every[first, rows], clicked.any(dim=0)


def plackett_luce(u: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
                  tau: float) -> torch.Tensor:
    """The ranking of each row of `scores` by its Gumbel keys from the
    uniforms `u`; masked documents last, in index order."""
    keys = tau * scores - torch.log(-torch.log(u.clamp_min(1e-20)))
    tie = -torch.arange(scores.shape[1], dtype=scores.dtype,
                        device=scores.device)
    keys = torch.where(mask > 0, keys, NEG_INF + tie)
    return torch.argsort(-keys, dim=1, stable=True)


def team_draft(rankings: np.ndarray, order: np.ndarray, positions: int):
    """Team-draft multileave of one query's rankings ``[R, N]`` in the
    drafting `order`: (documents shown, the ranker credited for each, -1
    in the common prefix)."""
    n_rankers, length = rankings.shape
    prefix = 0
    while prefix < length and (rankings[:, prefix] == rankings[0, prefix]
                               ).all():
        prefix += 1
    pointer = [0] * n_rankers
    shown, teams, used = [], [], set()
    for m in range(positions):
        if m < prefix:
            doc, team = int(rankings[0, m]), -1
            pointer = [max(p, m + 1) for p in pointer]
        else:
            team = int(order[m])
            j = pointer[team]
            while int(rankings[team, j]) in used:
                j += 1
            doc = int(rankings[team, j])
            pointer[team] = j + 1
        used.add(doc)
        shown.append(doc)
        teams.append(team)
    return shown, teams


def ndcg_at(labels: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor
            ) -> torch.Tensor:
    """Mean nDCG over the whole of each list [B, L] (gain 2^label - 1,
    discount 1 / log2(rank + 1)), masked documents ranked last; a list
    without gain scores 0."""
    scores = torch.where(mask > 0, scores, torch.full_like(scores, NEG_INF))
    discount = 1.0 / torch.log2(torch.arange(
        labels.shape[1], dtype=torch.float32, device=labels.device) + 2.0)

    def dcg(key):
        order = torch.argsort(-key, dim=1, stable=True)
        return ((2.0 ** torch.gather(labels, 1, order) - 1.0)
                * discount).sum(dim=1)

    got, ideal = dcg(scores), dcg(labels)
    return torch.where(ideal > 0, got / torch.where(ideal > 0, ideal,
                                                    torch.ones_like(ideal)),
                       torch.zeros_like(got)).mean()


class PlainMGD:
    """The ranker's leaves (tree order) and one MGD step on them."""

    def __init__(self, cfg: Dict, table: torch.Tensor, grades: torch.Tensor,
                 params: Dict, forward: Callable, noise: Callable,
                 fault: Optional[str] = None):
        hp = cfg["algorithm_hparams"]
        if not (hp["need_interleave"] and hp["interleave_strategy"]
                == "Stochastic" and hp["grad_strategy"] == "sgd"
                and hp["candidate_source"] == "perturb"):
            raise ValueError("the plain MGD runs the configuration's "
                             "Stochastic multileave with sgd on perturbed "
                             "candidates only")
        self.cfg, self.table, self.grades = cfg, table, grades
        self.tree = params
        self.paths = [p for p, _ in flatten(params)]
        self.leaves = [t.detach().clone() for _, t in flatten(params)]
        self.forward, self.noise, self.fault = forward, noise, fault
        self.rankers = 1 + int(hp["ranker_num"])
        self.lr = float(hp["learning_rate"])
        self.max_norm = float(hp["max_gradient_norm"])
        self.tau = float(hp["tau"])
        self.feed_tau = float(cfg["feed_hparams"]["tau"])
        self.N = cfg["list_length"]
        self.L = min(cfg["selection_bias_cutoff"], self.N)
        self.clicks = ClickModel(cfg, self.L, table.device)

    def params(self, leaves: Sequence[torch.Tensor]) -> Dict:
        it = iter(leaves)

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            if isinstance(node, (list, tuple)):
                return [build(sub) for sub in node]
            return next(it)

        return build(self.tree)

    def load(self, leaves: Sequence) -> None:
        for t, v in zip(self.leaves, leaves):
            t.copy_(torch.as_tensor(v).reshape(t.shape))

    def _rankers(self, noises: List[torch.Tensor]) -> List[Dict]:
        """The current ranker's tree, then each candidate's."""
        out = [self.params(self.leaves)]
        for r in range(self.rankers - 1):
            out.append(self.params([torch.add(t, n[r], alpha=self.lr)
                                    for t, n in zip(self.leaves, noises)]))
        return out

    def feed(self, gen: torch.Generator, score: Callable) -> Dict:
        """The online feed's batch from the current ranker's `score`
        (`score(params, x)`), with the uniforms it used."""
        B, N, L = self.cfg["batch_size"], self.N, self.L
        device = self.table.device
        qs = torch.randint(0, self.grades.shape[0], (B,), generator=gen,
                           device=device)
        x = self.table[qs[:, None] * N + torch.arange(N, device=device)]
        grades = self.grades[qs]
        mask = torch.ones_like(grades)
        scores = score(self.params(self.leaves), x)
        u_rank = torch.rand((B, N), generator=gen, device=device)
        u_click = torch.rand((1 + RESAMPLE_ROUNDS, B, L), generator=gen,
                             device=device)
        ranking = plackett_luce(u_rank, scores, mask, self.feed_tau)
        labels = torch.gather(grades, 1, ranking)
        clicks, valid = self.clicks.clicks(labels[:, :L], mask[:, :L],
                                           u_click)
        return {"whole": x, "scores": scores, "u_rank": u_rank,
                "ranking": ranking,
                "features": torch.gather(x, 1, ranking[:, :, None].expand(
                    -1, -1, x.shape[-1])),
                "labels": torch.cat([clicks, torch.zeros_like(
                    labels[:, L:])], dim=1),
                "mask": mask * valid[:, None].to(mask.dtype)}

    def decide(self, scores: List[torch.Tensor], batch: Dict,
               u_rank: torch.Tensor, order: torch.Tensor,
               u_click: torch.Tensor) -> Dict:
        """The rankings, the draft, the clicks and each query's credit
        [B, 1 + R] from the rankers' `scores` and the uniforms."""
        B, N, L, R = self.cfg["batch_size"], self.N, self.L, self.rankers
        mask = batch["mask"]
        stacked = torch.stack(scores, dim=1).reshape(B * R, N)
        rankings = plackett_luce(u_rank, stacked, mask[:, None].expand(
            B, R, N).reshape(B * R, N), self.tau).reshape(B, R, N)
        host_rankings = rankings.cpu().numpy()
        host_order = order.cpu().numpy()
        drafted = [team_draft(host_rankings[q], host_order[q], L)
                   for q in range(B)]
        device = mask.device
        shown = torch.tensor([d for d, _ in drafted], device=device)
        teams = torch.tensor([t for _, t in drafted], device=device)
        clicks, _ = self.clicks.clicks(
            torch.gather(batch["labels"], 1, shown),
            torch.gather(mask, 1, shown), u_click)
        credit = torch.stack([((teams == r) * clicks).sum(dim=1)
                              for r in range(R)], dim=1)
        credit = credit / (credit.sum(dim=1, keepdim=True) + SHARE_EPS)
        return {"rankings": rankings, "shown": shown, "teams": teams,
                "clicks": clicks, "credit": credit}

    def step(self, gen: torch.Generator,
             score_program: Optional[Callable] = None,
             recorded: Optional[Sequence[torch.Tensor]] = None,
             plain: bool = True) -> Dict:
        """One step, its draws from `gen`, updating the leaves in place.
        Its rankings, draft, clicks and credit come from `recorded` where
        given (the scores of the program's own step: the feed's pass,
        then the rankers'), else from `score_program`'s scores
        (``score_program(params, x)``) where given, else from the plain
        forward's. Returns the loss, the credit the update applied
        (``share_{r+1}`` times the clip's scale), the noises, the scores
        decided on (``decided``: the feed's pass, then the rankers'), the
        feed's batch, the decisions (:meth:`decide`) and the leaves after
        the update; with `plain`, also the plain forward's scores of the
        same six passes (``scores``) and, where the decisions came from
        other scores, the number of queries whose feed ranking, draft or
        clicks the plain scores would have changed (``flipped``)."""
        own = lambda p, x: self.forward(self.cfg, p, x)  # noqa: E731
        if recorded is not None:
            passes = iter(recorded)     # in the order the step scores

            def decide_with(p, x):
                return next(passes).to(x.dtype)
        else:
            decide_with = score_program or own
        other = plain and decide_with is not own
        batch = self.feed(gen, decide_with)
        B, N, L, R = self.cfg["batch_size"], self.N, self.L, self.rankers
        device = self.table.device
        noises = self.noise(self.params(self.leaves), R - 1, gen)
        rankers = self._rankers(noises)
        x = batch["features"]
        decided = [decide_with(p, x) for p in rankers]
        if other:       # before the update moves the current ranker
            scores = [own(rankers[0], batch["whole"])] + [
                own(p, x) for p in rankers]
        u_rank = torch.rand((B * R, N), generator=gen, device=device)
        rounds = -(-L // R) + 1
        order = torch.rand((B, rounds, R), generator=gen, device=device
                           ).argsort(dim=-1).reshape(B, -1)[:, :L]
        u_click = torch.rand((1 + RESAMPLE_ROUNDS, B, L), generator=gen,
                             device=device)
        out = self.decide(decided, batch, u_rank, order, u_click)
        share = out["credit"].mean(dim=0)
        grads = [torch.tensordot(share[1:], n, dims=1) for n in noises]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        if self.fault != "unchanged":
            for t, g in zip(self.leaves, grads):
                t.add_(-self.lr * (g * scale))
        reading = {
            "loss": float(1.0 - ndcg_at(batch["labels"][:, :L],
                                        decided[0][:, :L],
                                        batch["mask"][:, :L])),
            "credit": share[1:] * scale, "noises": noises,
            "decided": [batch["scores"]] + decided, "batch": batch,
            "decision": out,
            "leaves": [t.clone() for t in self.leaves]}
        if plain and not other:
            reading["scores"] = reading["decided"]
        if other:
            reading["scores"] = scores
            feed_own, scores = scores[0], scores[1:]
            mine = self.decide(scores, batch, u_rank, order, u_click)
            feed_rank = plackett_luce(batch["u_rank"], feed_own,
                                      torch.ones_like(feed_own),
                                      self.feed_tau)
            differs = (feed_rank[:, :L] != batch["ranking"][:, :L]).any(1)
            for key in ("shown", "teams", "clicks"):
                differs |= (mine[key] != out[key]).any(1)
            reading["flipped"] = int(differs.sum())
        return reading


def applied_credit(before: Sequence[torch.Tensor],
                   after: Sequence[torch.Tensor],
                   noises: Sequence[torch.Tensor], lr: float) -> torch.Tensor:
    """The credit ``a_r`` (``share_{r+1}`` times the clip's scale) that a
    step applied, from the leaves before and after it and its noises:
    the least-squares solution of ``after - before = -lr sum_r a_r
    noise_r`` over the perturbed leaves, in float64."""
    cols, target = [], []
    for b, a, n in zip(before, after, noises):
        if not bool(n.any()):
            continue
        cols.append(n.reshape(n.shape[0], -1).double())
        target.append(((torch.as_tensor(a).to(n.device).double()
                        - torch.as_tensor(b).to(n.device).double())
                       / -lr).reshape(-1))
    basis, y = torch.cat(cols, dim=1), torch.cat(target)
    return torch.linalg.solve(basis @ basis.T, basis @ y)


def follow(cfg: Dict, table: torch.Tensor, grades: torch.Tensor,
           params: Dict, forward: Callable, noise: Callable,
           seeds: Sequence[int], window_steps: int, *,
           recorded: Optional[Sequence[Sequence[torch.Tensor]]] = None,
           score_program: Optional[Callable] = None,
           shadow: Optional[Sequence[Sequence[torch.Tensor]]] = None,
           fault: Optional[str] = None) -> Dict:
    """The run's first three one-step windows (seeds[0:3]) and its first
    window of `window_steps` steps (seeds[3]), plain; with `shadow` (the
    leaves another run had after each of the three steps) each step and
    the window start from that run's leaves before them, and each step
    reads the credit that run applied. Each checked step decides from
    `recorded[k]` (the scores that run's step k produced) where given,
    else as the window does: from `score_program`'s scores where given,
    else from the plain forward's. Returns each checked step's readings
    (``scores``, ``decided``, ``credit``, with `shadow`
    ``program_credit``, where the decisions came from other scores
    ``flipped``), the leaves at the start and after each step, which
    leaves are perturbed, the window's mean loss and the leaves'
    paths."""
    device = table.device
    run = PlainMGD(cfg, table, grades, params, forward, noise, fault)
    start = [t.clone() for t in run.leaves]
    steps, states, kept = [], [], None
    for k, seed in enumerate(seeds[:CHECK_STEPS]):
        if shadow is not None:
            run.load(shadow[k - 1] if k else start)
        before = [t.clone() for t in run.leaves]
        reading = run.step(_stream(seed, device), score_program,
                           None if recorded is None else recorded[k])
        noises = reading.pop("noises")
        kept = [bool(n.any()) for n in noises]
        if shadow is not None:
            reading["program_credit"] = applied_credit(before, shadow[k],
                                                       noises, run.lr)
        steps.append(reading)
        states.append([t.clone() for t in run.leaves])
    if shadow is not None:
        run.load(shadow[-1])
    gen = _stream(seeds[CHECK_STEPS], device)
    window = [run.step(gen, score_program, plain=False)["loss"]
              for _ in range(window_steps)]
    return {"steps": steps, "start": start, "states": states, "kept": kept,
            "window_loss": float(np.mean(window)), "leaves": run.paths}


def as_program(ref: Dict) -> Dict:
    """A plain run's :func:`follow` in the program's place: the leaves
    after each checked step, the scores each step decided with, and the
    window's mean loss."""
    return {"states": ref["states"],
            "scores": [step["decided"] for step in ref["steps"]],
            "window_loss": ref["window_loss"]}


def gaps(program: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of `program` (the leaves after each checked step,
    ``states``, and the first window's mean loss) against `ref` (a
    :func:`follow` that shadowed it, deciding from its scores):

    * ``score_gap``: the worst of each checked step's six passes (the
      feed's and the five rankers') of ``max |program - plain| / max
      |plain|`` over the batch's scores, the program's those its own
      step produced;
    * ``share_gap``: the worst ``|a_program - a_plain|`` of the credit
      each step applied, the program's read from its update
      (:func:`applied_credit`), the plain one decided from the program's
      scores;
    * ``change_gap``: the worst leaf's ``|change_program -
      change_plain|`` after three steps, over the larger of the plain
      change's norm and the median perturbed leaf's; a leaf that the
      noise never perturbs (LayerNorm's scale and bias) has a plain
      change of 0, so whatever the program moves it by counts in full;
    * ``window_loss_gap``: the relative gap of the first window's mean
      1 - nDCG, both windows deciding from the program's scoring;
    * ``flipped_queries`` (no limit): the checked steps' queries whose
      decisions the plain scores would have changed."""
    score = max(float((d - s).abs().max() / s.abs().max())
                for step in ref["steps"]
                for s, d in zip(step["scores"], step["decided"]))
    share = max(float((step["program_credit"].to(step["credit"].device)
                       - step["credit"].double()).abs().max())
                for step in ref["steps"])
    start = ref["start"]
    prog = [torch.as_tensor(a).to(s.device) - s
            for a, s in zip(program["states"][-1], start)]
    plain = [a - s for a, s in zip(ref["states"][-1], start)]
    norms = [float(torch.linalg.vector_norm(c.double())) for c in plain]
    median = statistics.median(n for n, k in zip(norms, ref["kept"]) if k)
    change = max(float(torch.linalg.vector_norm((p - c).double()))
                 / max(n, median) for p, c, n in zip(prog, plain, norms))
    return {"score_gap": score, "share_gap": share, "change_gap": change,
            "window_loss_gap": (abs(program["window_loss"]
                                    - ref["window_loss"])
                                / abs(ref["window_loss"])),
            "flipped_queries": sum(s.get("flipped", 0)
                                   for s in ref["steps"])}
