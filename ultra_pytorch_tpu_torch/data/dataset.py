"""Dataset ingestion: LETOR data -> fixed-shape device tensors.

The port's counterpart of the JAX package's ``data/dataset.py``. It reads
the ULTRA format (``<prefix>.feature`` sparse 1-based ``did idx:val`` rows,
``.init_list``, ``.labels``, optional ``.initial_scores`` and
``settings.json``), the ULTRE variant (features keyed by document id,
``qid did did ...`` initial lists, labels optionally replaced by logged
clicks from ``click_model_dir``) and raw libsvm ``label qid:X idx:val``
files (``<prefix>/<prefix>.txt``, in file order), with the same
semantics: queries with fewer than two documents or no positive label are
dropped, lists are densified with -1 sentinels, and ``pad`` extends them.
The ``.feature`` and ``.txt`` files go through the native parser
(``data/native.py``) when it builds, else through the Python one.
Ingestion happens once into a :class:`DeviceDataset` of tensors on one
device:

    features  [D+1, F]  float32  (row D is the zero PAD vector)
    doc_idx   [Q, L]    int64    (PAD positions point at row D)
    labels    [Q, L]    float32  (0 at pads)
    mask      [Q, L]    float32  (1 = real doc)

so a training batch is a gather on the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ultra_pytorch_tpu_torch.data import native

# The JAX package's label sentinel for padding. Neither package writes it:
# padded positions carry label 0 and mask 0 (``pad``, ``to_host_arrays``).
PAD_LABEL = -1.0


def _read_sparse_features(path: str, feature_size: int,
                          removed: List[int]) -> Tuple[List[str], np.ndarray]:
    """Read a `.feature` file of `did idx:val ...` rows (1-based idx),
    natively when the parser builds."""
    keep = None
    if removed:
        drop = set(removed)
        keep = np.array([i for i in range(feature_size) if (i + 1) not in drop],
                        dtype=np.int64)
    parsed = native.parse_letor_file(path, native.FORMAT_ULTRA, feature_size)
    if parsed is not None:
        feats, _, dids = parsed
        return dids, feats if keep is None else feats[:, keep]
    dids: List[str] = []
    rows: List[np.ndarray] = []
    with open(path) as fin:
        for line in fin:
            arr = line.split()
            if not arr:
                continue
            dids.append(arr[0])
            vec = np.zeros(feature_size, dtype=np.float32)
            for tok in arr[1:]:
                idx_s, val_s = tok.split(":")
                fi = int(idx_s) - 1
                if 0 <= fi < feature_size:
                    vec[fi] = float(val_s)
            rows.append(vec if keep is None else vec[keep])
    feats = (np.stack(rows) if rows
             else np.zeros((0, feature_size - len(removed)), np.float32))
    return dids, feats


def _read_indexed_lines(path: str, cast=float, rank_cut: Optional[int] = None
                        ) -> Tuple[List[str], List[List]]:
    keys, values = [], []
    with open(path) as fin:
        for line in fin:
            arr = line.split()
            if not arr:
                continue
            keys.append(arr[0])
            vals = [cast(x) for x in arr[1:]]
            if rank_cut is not None:
                vals = vals[:rank_cut]
            values.append(vals)
    return keys, values


@dataclasses.dataclass
class RankingDataset:
    """Host-side dataset with ragged lists densified to `rank_list_size`."""

    features: np.ndarray          # [D, F] float32 (no PAD row yet)
    initial_list: np.ndarray      # [Q, L] int64, -1 = pad
    labels: np.ndarray            # [Q, L] float32, 0 at pads
    qids: List[str]
    dids: List[str]
    feature_size: int
    rank_list_size: int
    max_label: float
    initial_scores: Optional[np.ndarray] = None  # [Q, L] float32
    initial_list_lengths: Optional[np.ndarray] = None  # [Q]

    def __post_init__(self):
        if self.initial_list_lengths is None:
            self.initial_list_lengths = (self.initial_list >= 0).sum(axis=1)

    @property
    def num_queries(self) -> int:
        return self.initial_list.shape[0]

    def pad(self, rank_list_size: int, pad_tails: bool = True) -> None:
        """Extend every list to `rank_list_size` with -1 sentinels (at the
        tail, or at the head with ``pad_tails=False``)."""
        q, cur = self.initial_list.shape
        if rank_list_size < cur:
            raise ValueError(
                f"pad({rank_list_size}) smaller than current width {cur}")
        if rank_list_size == cur:
            self.rank_list_size = rank_list_size
            return
        extra = rank_list_size - cur
        neg = -np.ones((q, extra), dtype=self.initial_list.dtype)
        zl = np.zeros((q, extra), dtype=self.labels.dtype)

        def join(a, b):
            return np.concatenate([a, b] if pad_tails else [b, a], 1)

        self.initial_list = join(self.initial_list, neg)
        self.labels = join(self.labels, zl)
        if self.initial_scores is not None:
            self.initial_scores = join(self.initial_scores, zl)
        self.rank_list_size = rank_list_size

    def to_host_arrays(self, list_size: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
        """Densified numpy arrays in DeviceDataset layout (PAD row
        appended, pads remapped to it)."""
        L = list_size or self.rank_list_size
        doc_idx = self.initial_list[:, :L].astype(np.int64)
        labels = self.labels[:, :L].astype(np.float32)
        mask = (doc_idx >= 0).astype(np.float32)
        d = self.features.shape[0]
        doc_idx = np.where(doc_idx >= 0, doc_idx, d)
        labels = labels * mask
        feats = np.concatenate(
            [self.features.astype(np.float32),
             np.zeros((1, self.features.shape[1]), np.float32)], 0)
        scores = (self.initial_scores[:, :L].astype(np.float32)
                  if self.initial_scores is not None
                  and self.initial_scores.shape[1] >= L
                  else np.zeros_like(labels))
        return {"features": feats, "doc_idx": doc_idx, "labels": labels,
                "mask": mask, "initial_scores": scores,
                "max_label": float(self.max_label)}

    def to_device(self, device, list_size: Optional[int] = None
                  ) -> "DeviceDataset":
        """The dataset as tensors on `device`, cut to `list_size`."""
        arrs = self.to_host_arrays(list_size)
        put = lambda k: torch.from_numpy(arrs[k]).to(device)  # noqa: E731
        return DeviceDataset(
            features=put("features"), doc_idx=put("doc_idx"),
            labels=put("labels"), mask=put("mask"),
            initial_scores=put("initial_scores"),
            max_label=arrs["max_label"])


@dataclasses.dataclass(frozen=True)
class DeviceDataset:
    """Dataset tensors on one device; a batch is `features[doc_idx[qs]]`."""

    features: torch.Tensor        # [D+1, F]  (last row zero PAD)
    doc_idx: torch.Tensor         # [Q, L] int64
    labels: torch.Tensor          # [Q, L] float32
    mask: torch.Tensor            # [Q, L] float32
    initial_scores: torch.Tensor  # [Q, L] float32
    max_label: float

    @property
    def num_queries(self) -> int:
        return self.doc_idx.shape[0]

    @property
    def list_size(self) -> int:
        return self.doc_idx.shape[1]

    @property
    def feature_size(self) -> int:
        return self.features.shape[1]

    @property
    def device(self) -> torch.device:
        return self.features.device

    def gather(self, query_indices: torch.Tensor,
               list_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Batch assembly: indices ``[B]`` -> batch dict. `list_size` cuts
        to the top-k of the initial list BEFORE the feature gather, so
        training at cutoff 10 moves 10 feature rows a query."""
        cut = slice(None) if list_size is None else slice(0, list_size)
        idx = self.doc_idx[query_indices][:, cut]
        return {
            "features": self.features[idx],               # [B, L, F]
            "labels": self.labels[query_indices][:, cut],
            "mask": self.mask[query_indices][:, cut],
            "initial_scores": self.initial_scores[query_indices][:, cut],
        }


def _densify(lists: List[List[int]], labels: List[List[float]],
             scores: Optional[List[List[float]]], rank_list_size: int
             ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    q = len(lists)
    il = -np.ones((q, rank_list_size), dtype=np.int64)
    lb = np.zeros((q, rank_list_size), dtype=np.float32)
    sc = np.zeros((q, rank_list_size), dtype=np.float32) if scores else None
    for i, docs in enumerate(lists):
        il[i, :len(docs)] = docs
        lb[i, :len(labels[i])] = labels[i][:rank_list_size]
        if sc is not None and i < len(scores) and scores[i]:
            s = scores[i][:rank_list_size]
            sc[i, :len(s)] = s
    return il, lb, sc


def _remove_invalid(qids, lists, labels, scores):
    """Drop queries with fewer than 2 docs or no positive label."""
    keep = [i for i in range(len(lists))
            if len(lists[i]) >= 2 and any(lab > 0 for lab in labels[i])]

    def pick(xs):
        return [xs[i] for i in keep]

    return (pick(qids), pick(lists), pick(labels),
            pick(scores) if scores else scores)


def load_ultra_format(data_path: str, file_prefix: str,
                      rank_cut: Optional[int] = None) -> RankingDataset:
    """Load one split of ULTRA-format data."""
    with open(os.path.join(data_path, "settings.json")) as fin:
        settings = json.load(fin)
    feature_size = settings["feature_size"]
    max_label = float(settings.get("max_label", 1.0))
    removed = sorted(i for i in settings.get("removed_feature_ids", [])
                     if i <= feature_size)

    sub = os.path.join(data_path, file_prefix)
    dids, features = _read_sparse_features(
        os.path.join(sub, file_prefix + ".feature"), feature_size, removed)
    qids, lists = _read_indexed_lines(
        os.path.join(sub, file_prefix + ".init_list"), int, rank_cut)
    _, labels = _read_indexed_lines(
        os.path.join(sub, file_prefix + ".labels"), float, rank_cut)
    scores_path = os.path.join(sub, file_prefix + ".initial_scores")
    scores = None
    if os.path.isfile(scores_path):
        _, scores = _read_indexed_lines(scores_path, float, rank_cut)

    qids, lists, labels, scores = _remove_invalid(qids, lists, labels, scores)
    rank_list_size = max((len(docs) for docs in lists), default=0)
    il, lb, sc = _densify(lists, labels, scores, rank_list_size)
    return RankingDataset(
        features=features, initial_list=il, labels=lb, qids=qids, dids=dids,
        feature_size=feature_size - len(removed),
        rank_list_size=rank_list_size, max_label=max_label,
        initial_scores=sc)


def load_ultre_format(data_path: str, file_prefix: str,
                      click_model_dir: Optional[str] = None,
                      rank_cut: Optional[int] = None) -> RankingDataset:
    """Load one split of ULTRE-format data: features keyed by document id,
    ``qid did did ...`` initial lists (unknown ids dropped), and the labels
    of ``<click_model_dir>/<prefix>.labels`` when that file exists, else
    the split's own."""
    with open(os.path.join(data_path, "settings.json")) as fin:
        settings = json.load(fin)
    feature_size = settings["feature_size"]
    max_label = float(settings.get("max_label", 1.0))

    sub = os.path.join(data_path, file_prefix)
    raw_dids, features = _read_sparse_features(
        os.path.join(sub, file_prefix + ".feature"), feature_size, [])
    did_to_row = {d: i for i, d in enumerate(raw_dids)}
    qids, str_lists = _read_indexed_lines(
        os.path.join(sub, file_prefix + ".init_list"), str, rank_cut)
    lists = [[did_to_row[d] for d in docs if d in did_to_row]
             for docs in str_lists]

    label_path = os.path.join(sub, file_prefix + ".labels")
    if click_model_dir:
        logged = os.path.join(click_model_dir, file_prefix + ".labels")
        if os.path.isfile(logged):
            label_path = logged
    _, labels = _read_indexed_lines(label_path, float, rank_cut)

    qids, lists, labels, _ = _remove_invalid(qids, lists, labels, None)
    rank_list_size = max((len(docs) for docs in lists), default=0)
    il, lb, _ = _densify(lists, labels, None, rank_list_size)
    return RankingDataset(
        features=features, initial_list=il, labels=lb, qids=qids,
        dids=raw_dids, feature_size=feature_size,
        rank_list_size=rank_list_size, max_label=max_label)


def _assemble_libsvm(features: np.ndarray, labels_flat: np.ndarray,
                     row_qids: List[str],
                     rank_cut: Optional[int] = None) -> RankingDataset:
    """Group libsvm rows (file order; a new query where the qid changes)
    into a dataset: the first `rank_cut` rows of a query, documents named
    ``"{qid}_{i}"``, ``max_label`` the largest label (at least 1)."""
    qids: List[str] = []
    lists: List[List[int]] = []
    labels: List[List[float]] = []
    dids: List[str] = []
    keep_rows: List[int] = []
    max_label = 1.0
    cur = None
    for row, qid in enumerate(row_qids):
        if qid != cur:
            qids.append(qid)
            lists.append([])
            labels.append([])
            cur = qid
        if rank_cut is not None and len(lists[-1]) >= rank_cut:
            continue
        lists[-1].append(len(keep_rows))
        lab = float(labels_flat[row])
        labels[-1].append(lab)
        max_label = max(max_label, lab)
        dids.append(f"{qid}_{len(lists[-1]) - 1}")
        keep_rows.append(row)
    if len(keep_rows) != features.shape[0]:
        features = features[np.asarray(keep_rows, dtype=np.int64)]
    qids, lists, labels, _ = _remove_invalid(qids, lists, labels, None)
    rank_list_size = max((len(docs) for docs in lists), default=0)
    il, lb, _ = _densify(lists, labels, None, rank_list_size)
    return RankingDataset(
        features=features, initial_list=il, labels=lb, qids=qids, dids=dids,
        feature_size=features.shape[1], rank_list_size=rank_list_size,
        max_label=max_label)


def _parse_libsvm_python(path: str
                         ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(features [rows, F], labels [rows], qids) of a libsvm file, F its
    largest 1-based index; a ``#`` token ends a row."""
    labels, qids, rows = [], [], []
    feature_size = 0
    with open(path) as fin:
        for line in fin:
            toks = line.split()
            if not toks:
                continue
            labels.append(float(toks[0]))
            qids.append(toks[1].split(":")[1])
            fv = {}
            for tok in toks[2:]:
                if tok.startswith("#"):
                    break
                i_s, v_s = tok.split(":")
                fi = int(i_s)
                feature_size = max(feature_size, fi)
                fv[fi - 1] = float(v_s)
            rows.append(fv)
    features = np.zeros((len(rows), feature_size), np.float32)
    for r, fv in enumerate(rows):
        for k, v in fv.items():
            features[r, k] = v
    return features, np.asarray(labels, np.float32), qids


def load_libsvm_format(data_path: str, file_prefix: str,
                       rank_cut: Optional[int] = None) -> RankingDataset:
    """Load raw libsvm ``label qid:X idx:val...`` data
    (``<data_path>/<prefix>/<prefix>.txt``) in file order."""
    path = os.path.join(data_path, file_prefix, file_prefix + ".txt")
    parsed = native.parse_letor_file(path, native.FORMAT_LIBSVM, None)
    if parsed is None:
        parsed = _parse_libsvm_python(path)
    return _assemble_libsvm(*parsed, rank_cut=rank_cut)


def read_data(data_path: str, file_prefix: str, rank_cut: Optional[int] = None,
              click_model_dir: Optional[str] = None) -> RankingDataset:
    """Format-detecting entry point: `.feature` present -> ULTRA (ULTRE
    with a `click_model_dir`), else `.txt` -> libsvm."""
    sub = os.path.join(data_path, file_prefix)
    if os.path.isfile(os.path.join(sub, file_prefix + ".feature")):
        if click_model_dir:
            return load_ultre_format(
                data_path, file_prefix, click_model_dir, rank_cut)
        return load_ultra_format(data_path, file_prefix, rank_cut)
    if os.path.isfile(os.path.join(sub, file_prefix + ".txt")):
        return load_libsvm_format(data_path, file_prefix, rank_cut)
    raise FileNotFoundError(
        f"No ULTRA (.feature) or libsvm (.txt) data under {sub}")


def merge_summary(summary_list: List[Dict[str, float]],
                  counts: List[int]) -> Dict[str, float]:
    """Count-weighted average of per-batch metric dicts."""
    total = float(sum(counts))
    out: Dict[str, float] = {}
    for summary, c in zip(summary_list, counts):
        for k, v in summary.items():
            out[k] = out.get(k, 0.0) + float(v) * (c / total)
    return out
