"""Initial rankings from a pairwise linear ranker trained on the card.

The port's counterpart of ``libsvm_tools/initial_ranking_with_linear.py``:
it trains a linear scorer ``s = x @ w + b`` on a (sampled) libsvm training
file and writes train/valid/test ``.predict`` files, one score a line,
which ``libsvm_tools/prepare_exp_data_with_rank.py`` consumes, and
``model.npz`` (``w`` float32 ``[n_feat]``, ``b`` a 0-d float64).

Each step draws 4,096 rows ``i`` and 4,096 rows ``j`` uniformly over all
training rows from an explicit Philox generator (the reference draws
threefry), takes the logistic pairwise loss over the pairs of one query
with different labels, and applies optax's ``adagrad(0.5)``
(:func:`adagrad_update`). Scores are ``dense @ w + b`` in numpy float32,
as the reference computes them, so the same weights give the same
``.predict`` text byte for byte (:func:`predict`, which reads either
package's ``model.npz``).

Usage::

    python -m ultra_pytorch_tpu_torch.pipeline.initial_ranking \\
        <train> <valid> <test> <out>/ [steps] [--seed N] [--device cuda|cpu]
    python -m ultra_pytorch_tpu_torch.pipeline.initial_ranking \\
        --predict <model.npz> <libsvm> <out.predict> [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from ultra_pytorch_tpu_torch.data import native
from ultra_pytorch_tpu_torch.utils.device import resolve_device

PAIRS = 4096            # rows i and rows j drawn a step
LEARNING_RATE = 0.5     # optax.adagrad(0.5)
ACCUMULATOR_INIT = 0.1  # optax's initial_accumulator_value
EPS = 1e-7              # optax's eps, inside the root
SPLITS = ("train", "valid", "test")

# A token with no ':' after a line's first (the reader skips it), a
# feature index 0, a comment, a carriage return, or a line that is empty or
# starts with a blank: files the native parser is not held to, which the
# plain reader takes.
_PLAIN_ONLY = re.compile(rb"[ \t][^\s:]+(?=\s|$)|[ \t]0+:|[#\r]|^\s", re.M)


def read_libsvm(path: str) -> Tuple[List[float], List[str],
                                    List[Dict[int, float]], int]:
    """``(labels, qids, rows, n_feat)`` of a libsvm file: labels as floats,
    qids as strings, each row a ``{0-based index: value}`` dict (a token
    without ``:`` skipped), ``n_feat`` the largest 1-based index."""
    labels, qids, rows = [], [], []
    n_feat = 0
    with open(path) as fin:
        for line in fin:
            arr = line.split()
            if not arr:
                continue
            labels.append(float(arr[0]))
            qids.append(arr[1].split(":")[1])
            fv = {}
            for tok in arr[2:]:
                if ":" not in tok:
                    continue
                i_s, v_s = tok.split(":")
                fv[int(i_s) - 1] = float(v_s)
                n_feat = max(n_feat, int(i_s))
            rows.append(fv)
    return labels, qids, rows, n_feat


def dense(rows: List[Dict[int, float]], n_feat: int) -> np.ndarray:
    """The rows as a float32 ``[len(rows), n_feat]`` matrix; indices at or
    past `n_feat` are dropped."""
    x = np.zeros((len(rows), n_feat), dtype=np.float32)
    for i, fv in enumerate(rows):
        for k, v in fv.items():
            if k < n_feat:
                x[i, k] = v
    return x


def read_dense(path: str, n_feat: int = None
               ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """``(x, labels, qids)`` of a libsvm file: :func:`dense` of
    :func:`read_libsvm` (at `n_feat` columns, the file's largest index by
    default), through the native parser where the file holds nothing it
    is not held to (a comment, a token without ``:``, index 0, an empty
    line), else through the plain reader."""
    with open(path, "rb") as fin:
        blob = fin.read()
    if blob and not _PLAIN_ONLY.search(blob):
        parsed = native.parse_letor_file(path, native.FORMAT_LIBSVM, n_feat)
        if parsed is not None and len(parsed[2]) == blob.count(b"\n") + (
                not blob.endswith(b"\n")):
            x, labels, qids = parsed
            return x, labels, qids
    labels, qids, rows, width = read_libsvm(path)
    return (dense(rows, width if n_feat is None else n_feat),
            np.asarray(labels, np.float32), qids)


def _widen(x: np.ndarray, n_feat: int) -> np.ndarray:
    """`x` with zero columns appended up to `n_feat`."""
    if x.shape[1] == n_feat:
        return x
    out = np.zeros((x.shape[0], n_feat), dtype=np.float32)
    out[:, :x.shape[1]] = x
    return out


def adagrad_update(params, grads, accumulators,
                   lr: float = LEARNING_RATE, eps: float = EPS) -> None:
    """One step of optax's ``adagrad(lr)`` in place: ``acc += g^2``, then
    ``p -= lr * g * rsqrt(acc + eps)`` where ``acc > 0`` (nothing where it
    is 0). Accumulators start at ACCUMULATOR_INIT, not at 0, and eps sits
    inside the root: ``torch.optim.Adagrad`` does neither."""
    with torch.no_grad():
        for p, g, acc in zip(params, grads, accumulators):
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + eps),
                              torch.zeros_like(acc))
            p.add_(g * inv * -lr)


def pairwise_loss(w, b, x, y, gid, ii, jj) -> torch.Tensor:
    """The mean logistic loss over the drawn pairs of one query with
    different labels (0 when there are none)."""
    si = x[ii] @ w + b
    sj = x[jj] @ w + b
    sign = torch.sign(y[ii] - y[jj]) * (gid[ii] == gid[jj])
    margin = torch.log1p(torch.exp(-sign * (si - sj))) * sign.abs()
    return margin.sum() / torch.clamp(sign.abs().sum(), min=1.0)


def train(x: np.ndarray, labels, qids, steps: int = 500, seed: int = 0,
          device=None) -> Tuple[np.ndarray, float]:
    """Train ``(w, b)`` for `steps` steps on `x` (float32 ``[n, F]``) with
    `labels` and `qids` (rows grouped by qid in order of first
    appearance); returns ``w`` as float32 and ``b`` as a Python float."""
    dev = resolve_device(device)
    uniq = {q: i for i, q in enumerate(dict.fromkeys(qids))}
    xd = torch.as_tensor(x, dtype=torch.float32).to(dev)
    yd = torch.as_tensor(np.asarray(labels, np.float32)).to(dev)
    gd = torch.as_tensor(np.asarray([uniq[q] for q in qids],
                                    np.int32)).to(dev)
    n = x.shape[0]
    w = torch.zeros(x.shape[1], device=dev, requires_grad=True)
    b = torch.zeros((), device=dev, requires_grad=True)
    accs = [torch.full_like(w, ACCUMULATOR_INIT),
            torch.full_like(b, ACCUMULATOR_INIT)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(steps):
        ii = torch.randint(0, n, (PAIRS,), generator=gen, device=dev)
        jj = torch.randint(0, n, (PAIRS,), generator=gen, device=dev)
        loss = pairwise_loss(w, b, xd, yd, gd, ii, jj)
        grads = torch.autograd.grad(loss, [w, b])
        adagrad_update([w, b], grads, accs)
    return w.detach().cpu().numpy().astype(np.float32), float(b.item())


def write_predict(path: str, scores: np.ndarray) -> None:
    with open(path, "w") as f:
        for s in scores:
            f.write(f"{float(s):.8f}\n")


def predict(rows_or_path, model_npz: str) -> np.ndarray:
    """Scores ``dense @ w + b`` in numpy float32 of a libsvm file (a path)
    or of :func:`read_libsvm`'s rows, with the weights of `model_npz`,
    written by either package."""
    with np.load(model_npz) as m:
        w, b = m["w"], float(m["b"])
    if isinstance(rows_or_path, str):
        x = read_dense(rows_or_path, w.shape[0])[0]
    else:
        x = dense(rows_or_path, w.shape[0])
    return x @ w + b


def train_and_predict(train_file: str, valid_file: str, test_file: str,
                      output_path: str, steps: int = 500, seed: int = 0,
                      device=None) -> None:
    """Train on `train_file` (the width the largest index of all three
    files) and write ``model.npz`` and the three ``.predict`` files under
    `output_path`."""
    resolve_device(device)
    read = {split: read_dense(path) for split, path in zip(
        SPLITS, (train_file, valid_file, test_file))}
    n_feat = max(x.shape[1] for x, _, _ in read.values())
    x, labels, qids = read["train"]
    w, b = train(_widen(x, n_feat), labels, qids, steps, seed, device)
    os.makedirs(output_path, exist_ok=True)
    np.savez(os.path.join(output_path, "model.npz"), w=w, b=b)
    for split, (x, _, _) in read.items():
        write_predict(os.path.join(output_path, split + ".predict"),
                      _widen(x, n_feat) @ w + b)
    print(f"wrote predictions to {output_path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Initial rankings from a pairwise linear ranker.")
    parser.add_argument("files", nargs="+",
                        help="<train> <valid> <test> <out>/ [steps], or "
                             "with --predict: <libsvm> <out.predict>")
    parser.add_argument("--predict", metavar="MODEL_NPZ", default=None,
                        help="score a libsvm file with a model.npz")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    if args.predict:
        if len(args.files) != 2:
            parser.error("--predict takes <libsvm> <out.predict>")
        write_predict(args.files[1], predict(args.files[0], args.predict))
        return 0
    if len(args.files) not in (4, 5):
        parser.error("expected <train> <valid> <test> <out>/ [steps]")
    steps = int(args.files[4]) if len(args.files) == 5 else 500
    train_and_predict(*args.files[:4], steps=steps, seed=args.seed,
                      device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
