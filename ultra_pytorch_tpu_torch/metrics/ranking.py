"""Listwise ranking metrics (MRR, ERR, ARP, NDCG, DCG, Precision, MAP, OPA).

The port's counterpart of the JAX package's ``metrics/ranking.py``, with
its conventions and its documented divergences from the original ULTRA
reference: ``topn`` is a list of cutoffs evaluated in one pass; labels < 0
are invalid (label zeroed, prediction pushed below the list's minimum);
ERR normalizes gains by ``2^max_label``; MRR / ARP / MAP / OPA are taken
over the full list and repeated across cutoffs; DCG is the mean per-list
discounted gain; OPA is the weighted TF-Ranking definition; Precision
honours the cutoff. Sorting is a stable descending argsort; pass a
``torch.Generator`` to :func:`evaluate` to order tied scores at random.
Everything works on ``[B, L]`` tensors on any device, and nothing reads
back to (or copies from) the host, so a validation pass can be captured
as a CUDA graph (``run/window.py``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch

PADDING_SCORE = -100000.0


class RankingMetricKey:
    MRR = "mrr"
    ERR = "err"
    ARP = "arp"
    NDCG = "ndcg"
    DCG = "dcg"
    PRECISION = "precision"
    MAP = "map"
    ORDERED_PAIR_ACCURACY = "ordered_pair_accuracy"


def _safe_div(num, den):
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / safe)


def _prepare(labels, predictions, weights, topn):
    labels = labels.float()
    predictions = predictions.float()
    weights = torch.ones_like(labels) if weights is None else (
        torch.ones_like(labels) * weights)
    list_size = predictions.shape[1]
    topn = [min(int(n), list_size) for n in (topn or [list_size])]
    valid = labels >= 0.0
    labels = torch.where(valid, labels, torch.zeros_like(labels))
    floor = -1e-6 + predictions.min(dim=1, keepdim=True).values
    predictions = torch.where(valid, predictions, floor)
    return labels, predictions, weights, topn


def _sort_by(predictions, *tensors):
    order = torch.argsort(-predictions, dim=1, stable=True)
    return tuple(torch.gather(t, 1, order) for t in tensors)


def _per_list_weights(weights, relevance):
    return _safe_div((weights * relevance).sum(1, keepdim=True),
                     relevance.sum(1, keepdim=True))


def _cutoff_cumsum(values, topn):
    """values [B, L] -> [B, len(topn)]: cumulative sums at each cutoff
    (picked by integer indices, not an index list: a list would be copied
    to the device, which a captured validation graph refuses)."""
    cum = torch.cumsum(values, dim=1)
    return torch.stack([cum[:, n - 1] for n in topn], dim=1)


def _positions(length, device):
    return torch.arange(1, length + 1, dtype=torch.float32, device=device)


def mean_reciprocal_rank(labels, predictions, weights=None, topn=None):
    labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    (sorted_labels,) = _sort_by(predictions, labels)
    relevance = (sorted_labels >= 1.0).float()
    rr = 1.0 / _positions(predictions.shape[1], predictions.device)
    mrr = torch.max(relevance * rr, dim=1, keepdim=True).values
    val = torch.mean(mrr * torch.ones_like(weights) * weights)
    return val.expand(len(topn)).clone()


def expected_reciprocal_rank(labels, predictions, weights=None, topn=None,
                             max_label=None):
    labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    sorted_labels, sorted_weights = _sort_by(predictions, labels, weights)
    relevance = (2.0 ** sorted_labels - 1.0) / (2.0 ** float(max_label))
    non_rel = torch.cumprod(1.0 - relevance, dim=1) / (1.0 - relevance)
    rr = 1.0 / _positions(sorted_labels.shape[1], sorted_labels.device)
    contrib = relevance * non_rel * rr * sorted_weights
    return torch.mean(_cutoff_cumsum(contrib, topn), dim=0)


def average_relevance_position(labels, predictions, weights=None, topn=None):
    labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    sorted_labels, sorted_weights = _sort_by(predictions, labels, weights)
    position = _positions(predictions.shape[1], predictions.device)
    weighted = sorted_labels * sorted_weights
    per_list = _safe_div((position * weighted).sum(1, keepdim=True),
                         weighted.sum(1, keepdim=True))
    return torch.mean(per_list).expand(len(topn)).clone()


def _dcg_of_sorted(sorted_labels, sorted_weights, topn):
    list_size = sorted_labels.shape[1]
    discounts = 1.0 / torch.log2(
        torch.arange(list_size, dtype=torch.float32,
                     device=sorted_labels.device) + 2.0)
    gains = sorted_weights * (2.0 ** sorted_labels - 1.0)
    return _cutoff_cumsum(gains * discounts, topn)


def normalized_discounted_cumulative_gain(labels, predictions, weights=None,
                                          topn=None):
    has_weights = weights is not None
    labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    dcg = _dcg_of_sorted(*_sort_by(predictions, labels, weights), topn)
    ideal = _dcg_of_sorted(*_sort_by(labels, labels, weights), topn)
    per_list = _safe_div(dcg, ideal)
    if has_weights:
        plw = _per_list_weights(weights, 2.0 ** labels - 1.0)
        return torch.mean(per_list * plw, dim=0)
    return torch.mean(per_list, dim=0)


def discounted_cumulative_gain(labels, predictions, weights=None, topn=None):
    labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    dcg = _dcg_of_sorted(*_sort_by(predictions, labels, weights), topn)
    return torch.mean(dcg, dim=0)


def precision(labels, predictions, weights=None, topn=None):
    labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    sorted_labels, sorted_weights = _sort_by(predictions, labels, weights)
    relevance = (sorted_labels >= 1.0).float()
    num = _cutoff_cumsum(relevance * sorted_weights, topn)
    den = _cutoff_cumsum(torch.ones_like(relevance) * sorted_weights, topn)
    per_list = _safe_div(num, den)
    plw = _per_list_weights(weights, (labels >= 1.0).float())
    return torch.mean(per_list * plw, dim=0)


def mean_average_precision(labels, predictions, weights=None, topn=None):
    labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    sorted_labels, sorted_weights = _sort_by(predictions, labels, weights)
    rel = (sorted_labels >= 1.0).float()
    rel_count = torch.cumsum(rel, dim=1)
    cutoffs = torch.cumsum(torch.ones_like(rel), dim=1)
    prec = _safe_div(rel_count, cutoffs)
    total_prec = (prec * sorted_weights * rel).sum(1, keepdim=True)
    total_rel = (sorted_weights * rel).sum(1, keepdim=True)
    per_list = _safe_div(total_prec, total_rel)
    plw = _per_list_weights(weights, (labels >= 1.0).float())
    return torch.mean(per_list * plw).expand(len(topn)).clone()


def ordered_pair_accuracy(labels, predictions, weights=None, topn=None):
    clean_labels, predictions, weights, topn = _prepare(
        labels, predictions, weights, topn)
    valid = clean_labels == labels.float()
    valid_pair = valid[:, :, None] & valid[:, None, :]
    label_diff = clean_labels[:, :, None] - clean_labels[:, None, :]
    pred_diff = predictions[:, :, None] - predictions[:, None, :]
    correct = ((label_diff > 0) & (pred_diff > 0)).float()
    pair_w = ((label_diff > 0).float() * weights[:, :, None]
              * valid_pair.float())
    val = _safe_div(torch.sum(correct * pair_w), torch.sum(pair_w))
    return val.expand(len(topn)).clone()


def make_ranking_metric_fn(metric_key: str, topn: Sequence[int],
                           max_label: Optional[float] = None):
    """fn(labels, predictions, weights) -> ``[len(topn)]`` tensor."""
    if metric_key == RankingMetricKey.ERR:
        if max_label is None:
            raise ValueError("ERR requires max_label (dataset settings.json)")
        return functools.partial(
            expected_reciprocal_rank, topn=list(topn), max_label=max_label)
    table = {
        RankingMetricKey.MRR: mean_reciprocal_rank,
        RankingMetricKey.ARP: average_relevance_position,
        RankingMetricKey.NDCG: normalized_discounted_cumulative_gain,
        RankingMetricKey.DCG: discounted_cumulative_gain,
        RankingMetricKey.PRECISION: precision,
        RankingMetricKey.MAP: mean_average_precision,
        RankingMetricKey.ORDERED_PAIR_ACCURACY: ordered_pair_accuracy,
    }
    if metric_key not in table:
        raise ValueError(f"metric_key {metric_key!r} not supported")
    fn = table[metric_key]
    return lambda labels, predictions, weights=None: fn(
        labels, predictions, weights=weights, topn=list(topn))


def mask_padding(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Push padded positions to PADDING_SCORE before metric computation."""
    return torch.where(mask > 0, scores, torch.full_like(scores,
                                                         PADDING_SCORE))


def random_tie_break(generator: torch.Generator,
                     predictions: torch.Tensor) -> torch.Tensor:
    """Perturb `predictions` so that tied scores sort in random order while
    every strict ordering is kept: per-entry uniform noise in
    ``[0, 0.5)`` times the smallest nonzero gap of the list."""
    sorted_p = torch.sort(predictions, dim=1).values
    diffs = torch.diff(sorted_p, dim=1)
    inf = torch.full_like(diffs, float("inf"))
    min_gap = torch.where(diffs > 0, diffs, inf).min(
        dim=1, keepdim=True).values if diffs.shape[1] else torch.ones_like(
            predictions[:, :1])
    min_gap = torch.where(torch.isfinite(min_gap), min_gap,
                          torch.ones_like(min_gap))
    u = 0.5 * torch.rand(predictions.shape, generator=generator,
                         device=predictions.device)
    return predictions + u * min_gap


def evaluate(labels: torch.Tensor, predictions: torch.Tensor,
             metric_keys: Sequence[str], topns: Sequence[int],
             max_label: float, mask: Optional[torch.Tensor] = None,
             weights: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """``{metric}_{n}`` for every metric x cutoff in one call; with a
    `generator`, tied scores are ordered at random."""
    if mask is not None:
        predictions = mask_padding(predictions, mask)
        labels = labels * mask
    if generator is not None:
        predictions = random_tie_break(generator, predictions)
    out: Dict[str, torch.Tensor] = {}
    for key in metric_keys:
        fn = make_ranking_metric_fn(key, list(topns), max_label=max_label)
        vals = fn(labels, predictions, weights)
        for n, v in zip(topns, vals):
            out[f"{key}_{n}"] = v
    return out


def ndcg(labels, predictions, topn: int = 10) -> torch.Tensor:
    """Scalar NDCG@`topn` of ``[B, L]`` lists, unweighted (the DBGD
    reward's metric, ref ``metric_utils.py:244-274``)."""
    return normalized_discounted_cumulative_gain(
        labels, predictions, None, [topn])[0]
