"""TREC-format ranklist output (the port's ``data/trec.py``).

Per query, sort the initial list's positions by rerank score descending
(stable), drop padding documents, and emit ``qid Q0 did rank score Model``
lines.
"""

from __future__ import annotations

import os

import numpy as np


def generate_ranklist_by_scores(dataset, rerank_scores: np.ndarray):
    """dataset: RankingDataset; rerank_scores: [Q, L] scores over the
    initial list positions. Returns {qid: [(did, score), ...]}."""
    rerank_scores = np.asarray(rerank_scores)
    if rerank_scores.shape[0] != dataset.num_queries:
        raise ValueError(
            "Rerank score count must equal the query count, "
            f"{rerank_scores.shape[0]} != {dataset.num_queries}")
    out = {}
    for i, qid in enumerate(dataset.qids):
        scores = rerank_scores[i]
        width = min(len(scores), dataset.initial_list.shape[1])
        order = np.argsort(-scores[:width], kind="stable")
        out[qid] = [(dataset.dids[dataset.initial_list[i][pos]],
                     float(scores[pos]))
                    for pos in order if dataset.initial_list[i][pos] >= 0]
    return out


def output_ranklist(dataset, rerank_scores: np.ndarray, output_path: str,
                    file_name: str = "test", model_tag: str = "Model") -> str:
    qid_map = generate_ranklist_by_scores(dataset, rerank_scores)
    os.makedirs(output_path or ".", exist_ok=True)
    path = os.path.join(output_path, file_name + ".ranklist")
    with open(path, "w") as fout:
        for qid in dataset.qids:
            for rank, (did, score) in enumerate(qid_map[qid], start=1):
                fout.write(f"{qid} Q0 {did} {rank} {score} {model_tag}\n")
    return path
