"""Vectorized click models (PBM).

The port's counterpart of the JAX package's ``sim/click_models.py``: the
ERR-inspired relevance -> click-probability mapping
``P(click | rel = i) = a + 2^i * b``, the published PBM examination table
raised to ``eta``, and batched sampling. ``eta`` is a tensor, so the
feeds' dynamic-bias schedule is a tensor of per-step etas. UBM and cascade
are not ported yet (their loaders raise).

Sampling draws its uniforms from an explicit ``torch.Generator``; the
comparison ``u < exam * click_prob`` is :func:`clicks_from_uniform` of the
K5 module, which K5's plain version shares.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from ultra_pytorch_tpu_torch.ops.kernels.click_sim import clicks_from_uniform

_PBM_EXAM_LIST = [0.68, 0.61, 0.48, 0.34, 0.28, 0.20, 0.11, 0.10, 0.08, 0.06]
PBM_EXAM_PROB = np.array(_PBM_EXAM_LIST, dtype=np.float32)

_CANONICAL = {
    "pbm": "position_biased_model",
    "position_biased_model": "position_biased_model",
    "ubm": "user_browsing_model",
    "user_browsing_model": "user_browsing_model",
    "cascade": "cascade_model",
    "cascade_model": "cascade_model",
}


@dataclasses.dataclass(frozen=True)
class ClickModelParams:
    """Click-model parameters as tensors on one device."""

    click_prob: torch.Tensor   # [G+1] P(click | examined, rel = g)
    exam_prob: torch.Tensor    # PBM: [10]
    eta: torch.Tensor          # bias severity: scalar, or one per step
    model_name: str = "position_biased_model"

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
    if canonical != "position_biased_model":
        raise NotImplementedError(
            f"click model {canonical!r} is not yet ported to "
            "ultra_pytorch_tpu_torch (PBM only)")
    return ClickModelParams(
        click_prob=torch.as_tensor(np.asarray(click_prob, np.float32)),
        exam_prob=torch.as_tensor(PBM_EXAM_PROB),
        eta=torch.tensor(float(eta), dtype=torch.float32),
        model_name=canonical)


def load_model_from_json(desc: Dict[str, Any]) -> ClickModelParams:
    """Load from the reference's JSON schema
    ``{model_name, eta, click_prob, exam_prob}``."""
    return _build(desc["model_name"], np.asarray(desc["click_prob"]),
                  float(desc["eta"]))


def load_model_from_file(path: str) -> ClickModelParams:
    with open(path) as fin:
        return load_model_from_json(json.load(fin))


def exam_at_ranks(params: ClickModelParams, length: int) -> torch.Tensor:
    """Per-position examination probabilities ``exam^eta``; ranks beyond
    the table take its last entry. Shape ``eta.shape + [length]``."""
    exam = params.exam_prob ** params.eta[..., None]
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


def click_probs(params: ClickModelParams,
                labels: torch.Tensor) -> torch.Tensor:
    """``exam^eta[min(pos, 9)] * click_prob[clip(grade)]`` for ``[..., L]``
    labels. A per-step eta of shape ``[n]`` goes with labels
    ``[n, C, L]``."""
    exam = exam_at_ranks(params, labels.shape[-1])
    if params.eta.dim():
        exam = exam[..., None, :]
    return exam * click_prob_of_labels(params, labels)


def sample_clicks(params: ClickModelParams, generator: torch.Generator,
                  labels: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """PBM clicks for ``[..., L]`` lists with uniforms from `generator`
    (on the labels' device). Returns (clicks, exam_p, click_p), as the JAX
    ``sample_clicks``; pad positions (mask == 0) never click."""
    if params.model_name != "position_biased_model":
        raise NotImplementedError(f"{params.model_name} is not yet ported")
    click_p = click_prob_of_labels(params, labels)
    exam_p = exam_at_ranks(params, labels.shape[-1])
    if params.eta.dim():
        exam_p = exam_p[..., None, :]
    exam_p = torch.broadcast_to(exam_p, labels.shape)
    u = torch.rand(labels.shape, generator=generator, device=labels.device)
    mask = torch.ones_like(labels) if mask is None else mask
    clicks = clicks_from_uniform(exam_p * click_p, u, mask)
    return clicks, exam_p * mask, click_p


def propensity_weights(params: ClickModelParams, clicks: torch.Tensor,
                       use_non_clicked_data: bool = False) -> torch.Tensor:
    """True propensity weights ``exam[0] / exam`` (PBM, scalar eta) for a
    click pattern ``[B, L]``, on the clicks' device; zero where nothing
    was clicked unless `use_non_clicked_data`."""
    if params.model_name != "position_biased_model":
        raise NotImplementedError(
            f"propensity_weights for {params.model_name} is not yet ported "
            "to ultra_pytorch_tpu_torch (PBM only)")
    exam = exam_at_ranks(params.to(clicks.device), clicks.shape[1])
    pw = torch.broadcast_to(exam[0] / exam, clicks.shape)
    if not use_non_clicked_data:
        pw = pw * (clicks > 0)
    return pw


def model_to_json(params: ClickModelParams) -> Dict[str, Any]:
    """The reference's JSON schema ``{model_name, eta, click_prob,
    exam_prob}``, with the examination probabilities raised to eta."""
    return {
        "model_name": params.model_name,
        "eta": float(params.eta),
        "click_prob": params.click_prob.cpu().tolist(),
        "exam_prob": (params.exam_prob ** params.eta).cpu().tolist(),
    }


def click_model_json_numpy(name: str, neg: float, pos: float, grades: int,
                           eta: float) -> Dict[str, Any]:
    """Pure-numpy JSON construction of a click model description."""
    b = (pos - neg) / (2 ** grades - 1)
    a = neg - b
    click_prob = [a + (2 ** i) * b for i in range(grades + 1)]
    canonical = _CANONICAL.get(name, name)
    if canonical != "position_biased_model":
        raise NotImplementedError(f"{canonical} is not yet ported")
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
