"""Vectorized click models: PBM, UBM and cascade.

The port's counterpart of the JAX package's ``sim/click_models.py``: the
ERR-inspired relevance -> click-probability mapping
``P(click | rel = i) = a + 2^i * b``, the published examination tables
raised to ``eta`` (PBM ``[10]``, UBM ``[10, 10]`` by rank and distance to
the last click, cascade ten ones), and batched sampling.

``eta`` is a tensor, so the feeds' dynamic-bias schedule is a tensor of
per-step etas: a per-step eta ``[n]`` goes with labels ``[n, C, L]``, and
the examination table becomes ``[n, 10]`` (PBM, cascade) or ``[n, 10,
10]`` (UBM).

Sampling is :func:`clicks_from_uniforms`, a function of given uniforms
(the CPU tests feed it JAX's), and :func:`sample_clicks` draws those
uniforms from an explicit ``torch.Generator``; :func:`resampled_clicks`
keeps each list's first clicked round of several given ones (the online
feeds' and the DBGD family's resampling). PBM's comparison
``u < exam * click_prob`` is :func:`clicks_from_uniform` of the K5 module,
which K5's plain version shares. UBM is sequential in the position: a
Python loop over the L positions of ``[..., L]`` tensors, with the last
click's rank as int64 (-1 before any click). Cascade is PBM's comparison
with ten ones, then JAX's cumulative "alive" mask, which zeroes clicks
and ``exam_p`` after the first click.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ultra_pytorch_tpu_torch.ops.kernels.click_sim import clicks_from_uniform

PBM = "position_biased_model"
UBM = "user_browsing_model"
CASCADE = "cascade_model"

_PBM_EXAM_LIST = [0.68, 0.61, 0.48, 0.34, 0.28, 0.20, 0.11, 0.10, 0.08, 0.06]
PBM_EXAM_PROB = np.array(_PBM_EXAM_LIST, dtype=np.float32)

# UBM: row r gives the examination probability at rank r by (distance to
# the last click - 1); the ragged rows are padded on the right with their
# own last value.
_UBM_ROWS = [
    [1.0],
    [0.98, 1.0],
    [1.0, 0.62, 0.95],
    [1.0, 0.77, 0.42, 0.82],
    [1.0, 0.92, 0.55, 0.31, 0.69],
    [1.0, 0.96, 0.63, 0.4, 0.22, 0.54],
    [1.0, 0.99, 0.73, 0.46, 0.29, 0.17, 0.47],
    [1.0, 1.0, 0.89, 0.52, 0.35, 0.24, 0.14, 0.43],
    [1.0, 1.0, 0.95, 0.68, 0.4, 0.29, 0.19, 0.12, 0.41],
    [1.0, 1.0, 1.0, 0.96, 0.52, 0.36, 0.27, 0.18, 0.12, 0.43],
]
UBM_EXAM_TABLE = np.array([row + row[-1:] * (10 - len(row))
                           for row in _UBM_ROWS], dtype=np.float32)
UBM_ROW_LENGTHS = [len(row) for row in _UBM_ROWS]

_CANONICAL = {
    "pbm": PBM, PBM: PBM,
    "ubm": UBM, UBM: UBM,
    "cascade": CASCADE, CASCADE: CASCADE,
}


@dataclasses.dataclass(frozen=True)
class ClickModelParams:
    """Click-model parameters as tensors on one device."""

    click_prob: torch.Tensor   # [G+1] P(click | examined, rel = g)
    exam_prob: torch.Tensor    # PBM, cascade: [10]; UBM: [10, 10]
    eta: torch.Tensor          # bias severity: scalar, or one per step
    model_name: str = PBM

    def replace(self, **changes) -> "ClickModelParams":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "ClickModelParams":
        return self.replace(click_prob=self.click_prob.to(device),
                            exam_prob=self.exam_prob.to(device),
                            eta=self.eta.to(device))


def make_click_model(name: str, neg_click_prob: float = 0.1,
                     pos_click_prob: float = 1.0,
                     relevance_grading_num: int = 4,
                     eta: float = 1.0) -> ClickModelParams:
    """A click model with the ERR-inspired click probabilities."""
    b = (pos_click_prob - neg_click_prob) / (2 ** relevance_grading_num - 1)
    a = neg_click_prob - b
    click_prob = np.array(
        [a + (2 ** i) * b for i in range(relevance_grading_num + 1)],
        dtype=np.float32)
    return _build(name, click_prob, eta)


def _build(name: str, click_prob: np.ndarray, eta: float) -> ClickModelParams:
    canonical = _CANONICAL[name]
    base = {UBM: UBM_EXAM_TABLE, CASCADE: np.ones(10, np.float32)}.get(
        canonical, PBM_EXAM_PROB)
    return ClickModelParams(
        click_prob=torch.as_tensor(np.asarray(click_prob, np.float32)),
        exam_prob=torch.as_tensor(base),
        eta=torch.tensor(float(eta), dtype=torch.float32),
        model_name=canonical)


def load_model_from_json(desc: Dict[str, Any]) -> ClickModelParams:
    """Load from the reference's JSON schema
    ``{model_name, eta, click_prob, exam_prob}``. The examination table is
    the canonical one of the model, not the JSON's ``exam_prob`` (as in
    the JAX package)."""
    return _build(desc["model_name"], np.asarray(desc["click_prob"]),
                  float(desc["eta"]))


def load_model_from_file(path: str) -> ClickModelParams:
    with open(path) as fin:
        return load_model_from_json(json.load(fin))


def exam_with_eta(params: ClickModelParams) -> torch.Tensor:
    """The examination table raised to eta: ``eta.shape + exam.shape``."""
    eta = params.eta.reshape(params.eta.shape
                             + (1,) * params.exam_prob.dim())
    return params.exam_prob ** eta


def exam_at_ranks(params: ClickModelParams, length: int) -> torch.Tensor:
    """PBM / cascade per-position examination probabilities ``exam^eta``;
    ranks beyond the table take its last entry. Shape ``eta.shape +
    [length]``."""
    exam = exam_with_eta(params)
    ranks = torch.clamp(torch.arange(length, device=exam.device),
                        max=exam.shape[-1] - 1)
    return exam[..., ranks]


def click_prob_of_labels(params: ClickModelParams,
                         labels: torch.Tensor) -> torch.Tensor:
    """P(click | examined) per item: integer-clip labels, clamp the grade
    index into the click_prob table."""
    grades = torch.clamp(labels.to(torch.int64), 0,
                         params.click_prob.shape[0] - 1)
    return params.click_prob[grades]


def _per_list(exam: torch.Tensor, params: ClickModelParams) -> torch.Tensor:
    """An ``eta.shape + [...]`` table lined up with ``[n, C, L]`` lists:
    a per-step eta gains the list axis."""
    return exam.unsqueeze(1) if params.eta.dim() else exam


def click_probs(params: ClickModelParams,
                labels: torch.Tensor) -> torch.Tensor:
    """PBM's ``exam^eta[min(pos, 9)] * click_prob[clip(grade)]`` for
    ``[..., L]`` labels. A per-step eta of shape ``[n]`` goes with labels
    ``[n, C, L]``."""
    exam = _per_list(exam_at_ranks(params, labels.shape[-1]), params)
    return exam * click_prob_of_labels(params, labels)


def _ubm_exam(table: torch.Tensor, rank: int,
              last_click: torch.Tensor) -> torch.Tensor:
    """UBM examination probability at `rank` given the last click's rank
    (``-1``: none), with the reference's handling of rank >= 10: row 9,
    its last column before any click, else column min(distance - 1, 8).
    `table` is ``[..., 10, 10]``, broadcastable to ``last_click``'s
    shape."""
    distance = rank - last_click
    rows = table.shape[-2]
    if rank < rows:
        row, col = table[..., rank, :], (distance - 1).clamp(0, rows - 1)
    else:
        row = table[..., rows - 1, :]
        col = torch.where(distance > rank, torch.full_like(distance, rows - 1),
                          (distance - 1).clamp(0, rows - 2))
    row = row.expand(last_click.shape + row.shape[-1:])
    return torch.gather(row, -1, col.unsqueeze(-1)).squeeze(-1)


def _ubm_walk(params: ClickModelParams, shape: torch.Size, device,
              clicked: Callable[[int, torch.Tensor], torch.Tensor]):
    """Walk the L positions of ``shape = [..., L]`` lists in order:
    `clicked(r, exam_r)` gives the float clicks at rank r. Returns the
    stacked (clicks, exam)."""
    table = _per_list(exam_with_eta(params), params)
    last = torch.full(shape[:-1], -1, dtype=torch.int64, device=device)
    clicks, exams = [], []
    for r in range(shape[-1]):
        exam = _ubm_exam(table, r, last)
        click = clicked(r, exam)
        last = torch.where(click > 0, torch.full_like(last, r), last)
        clicks.append(click)
        exams.append(exam)
    return torch.stack(clicks, dim=-1), torch.stack(exams, dim=-1)


def clicks_from_uniforms(params: ClickModelParams, labels: torch.Tensor,
                         u: torch.Tensor,
                         mask: Optional[torch.Tensor] = None):
    """Clicks of ``[..., L]`` lists given their uniforms `u` (a click
    where ``u < exam * click_prob``). Returns (clicks, exam_p, click_p), as
    the JAX ``sample_clicks``; pad positions (mask == 0) never click, and
    their ``exam_p`` is 0."""
    click_p = click_prob_of_labels(params, labels)
    mask = torch.ones_like(labels) if mask is None else mask
    if params.model_name == UBM:
        clicks, exam_p = _ubm_walk(
            params, labels.shape, labels.device,
            lambda r, exam: (u[..., r] < exam * click_p[..., r]).float())
        return clicks * mask, exam_p * mask, click_p
    exam_p = torch.broadcast_to(
        _per_list(exam_at_ranks(params, labels.shape[-1]), params),
        labels.shape)
    if params.model_name == PBM:
        return (clicks_from_uniform(exam_p * click_p, u, mask),
                exam_p * mask, click_p)
    # Cascade: the user stops after the first click.
    clicks = (u < exam_p * click_p).float()
    alive = ((torch.cumsum(clicks, dim=-1) - clicks) == 0).float()
    return clicks * alive * mask, exam_p * alive * mask, click_p


def sample_clicks(params: ClickModelParams, generator: torch.Generator,
                  labels: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Clicks for ``[..., L]`` lists with one ``torch.rand`` of the labels'
    shape from `generator` (on the labels' device); see
    :func:`clicks_from_uniforms`."""
    u = torch.rand(labels.shape, generator=generator, device=labels.device)
    return clicks_from_uniforms(params, labels, u, mask)


def resampled_clicks(model: ClickModelParams, labels: torch.Tensor,
                     mask: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clicks on ``[B, L]`` lists given the uniforms ``u [rounds, B, L]``
    of a first draw (round 0) and its resamples: (each list's first round
    with a click, or round 0 where none has one; whether any has)."""
    shape = u.shape
    clicks, _, _ = clicks_from_uniforms(
        model, labels.expand(shape), u, mask.expand(shape))
    valid = clicks.sum(dim=-1) > 0                               # [rounds, B]
    first = torch.argmax(valid.to(torch.int8), dim=0)            # 0 if none
    rows = torch.arange(shape[1], device=u.device)
    return clicks[first, rows], valid.any(dim=0)


def propensity_weights(params: ClickModelParams, clicks: torch.Tensor,
                       use_non_clicked_data: bool = False) -> torch.Tensor:
    """True propensity weights for a click pattern ``[B, L]`` (scalar
    eta), on the clicks' device: PBM and cascade ``exam[0] / exam``, UBM
    ``1 / exam`` given the clicks before each position; zero where nothing
    was clicked unless `use_non_clicked_data`."""
    params = params.to(clicks.device)
    if params.model_name == UBM:
        _, exam = _ubm_walk(params, clicks.shape, clicks.device,
                            lambda r, _: clicks[..., r])
        pw = 1.0 / exam
    else:
        exam = exam_at_ranks(params, clicks.shape[-1])
        pw = torch.broadcast_to(exam[0] / exam, clicks.shape)
    if not use_non_clicked_data:
        pw = pw * (clicks > 0)
    return pw


def model_to_json(params: ClickModelParams) -> Dict[str, Any]:
    """The reference's JSON schema ``{model_name, eta, click_prob,
    exam_prob}``, the examination probabilities raised to eta (UBM's rows
    ragged, as published)."""
    exam = exam_with_eta(params).cpu()
    if params.model_name == UBM:
        exam_list = [exam[i, :n].tolist()
                     for i, n in enumerate(UBM_ROW_LENGTHS)]
    else:
        exam_list = exam.tolist()
    return {
        "model_name": params.model_name,
        "eta": float(params.eta),
        "click_prob": params.click_prob.cpu().tolist(),
        "exam_prob": exam_list,
    }


def click_model_json_numpy(name: str, neg: float, pos: float, grades: int,
                           eta: float) -> Dict[str, Any]:
    """Pure-numpy JSON construction of a click model description."""
    b = (pos - neg) / (2 ** grades - 1)
    a = neg - b
    click_prob = [a + (2 ** i) * b for i in range(grades + 1)]
    canonical = _CANONICAL.get(name, name)
    if canonical == UBM:
        exam = [[float(x ** eta) for x in row] for row in _UBM_ROWS]
    elif canonical == CASCADE:
        exam = [1.0] * 10
    else:
        exam = [float(x ** eta) for x in _PBM_EXAM_LIST]
    return {"model_name": canonical, "eta": eta, "click_prob": click_prob,
            "exam_prob": exam}


def main(argv=None):
    """``python -m ultra_pytorch_tpu_torch.sim.click_models <model> <neg>
    <pos> <grades> <eta> <outdir>`` writes ``<outdir>/<args>.json``."""
    argv = argv if argv is not None else sys.argv[1:]
    name, neg, pos, grades, eta, outdir = argv[:6]
    desc = click_model_json_numpy(name, float(neg), float(pos), int(grades),
                                  float(eta))
    out = f"{outdir}/{'_'.join(argv[:5])}.json"
    with open(out, "w") as fout:
        json.dump(desc, fout, indent=4, sort_keys=True)
    print(out)


if __name__ == "__main__":
    main()
