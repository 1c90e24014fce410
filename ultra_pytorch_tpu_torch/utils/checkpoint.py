"""Checkpoints in the JAX package's ``.npz`` format.

A checkpoint is one ``<path>.npz`` holding the flattened leaves of a
parameter tree as ``leaf_0 .. leaf_{n-1}`` plus a JSON entry
``__ultra_meta__`` (``{"n", "metadata", "structure"}``). The tree structure
itself is not stored: a reader re-derives it from a template tree. The
JAX trainer saves ``(TrainState, rng)``, and ``TrainState`` flattens its
``params`` first, so a ranker's parameters are always the first leaves of
the file. That is the contract both ways: the port reads checkpoints the
JAX trainer wrote, and the JAX package's ``load_params_prefix`` reads the
ones the port writes.

Trees here are nested ``dict``/``list``/``tuple`` of numpy arrays, and
they flatten in the order ``jax.tree_util`` uses for the same containers:
dict keys sorted, sequences in order, and ``None`` an empty subtree (no
leaf).
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np

_META_KEY = "__ultra_meta__"


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a dict/list/tuple tree, in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def _tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """Rebuild `template`'s structure with `leaves` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    return build(template)


def _structure(tree: Any) -> str:
    """Human-readable structure fingerprint (diagnostics only)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(s) for s in tree) + "]"
    return "*"


def save_checkpoint(path: str, tree: Any, metadata: dict = None) -> None:
    """Atomically write `tree`'s leaves + metadata to ``<path>.npz``."""
    leaves = tree_leaves(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays[_META_KEY] = np.array(json.dumps({
        "n": len(leaves),
        "metadata": metadata or {},
        "structure": _structure(tree),
    }))
    tmp = path + ".npz.tmp.npz"  # np.savez appends .npz if missing
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")


def load_checkpoint(path: str, template: Any) -> Tuple[Any, dict]:
    """Load every leaf of ``<path>.npz`` into `template`'s structure,
    shape-checked leaf by leaf; returns (tree, metadata)."""
    with np.load(path + ".npz") as data:
        if _META_KEY not in data.files:
            raise ValueError(f"{path}.npz is not a framework checkpoint")
        meta = json.loads(str(data[_META_KEY]))
        tpl_leaves = tree_leaves(template)
        if meta["n"] != len(tpl_leaves):
            raise ValueError(
                f"checkpoint {path}.npz has {meta['n']} leaves but the "
                f"template has {len(tpl_leaves)} — saved structure: "
                f"{meta['structure']}")
        leaves = []
        for i, tpl in enumerate(tpl_leaves):
            saved = data[f"leaf_{i}"]
            if tuple(saved.shape) != tuple(np.shape(tpl)):
                raise ValueError(
                    f"checkpoint leaf_{i} shape {tuple(saved.shape)} != "
                    f"template shape {tuple(np.shape(tpl))}")
            leaves.append(saved)
    return _tree_unflatten(template, leaves), meta.get("metadata", {})


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(path + ".npz")


def load_params_prefix(path: str, params_template: Any) -> Any:
    """Restore only the ranker params: the first ``len(leaves(template))``
    stored leaves, each shape-checked against the template."""
    with np.load(path + ".npz") as data:
        if _META_KEY not in data.files:
            raise ValueError(f"{path}.npz is not a framework checkpoint")
        tpl_leaves = tree_leaves(params_template)
        n_saved = json.loads(str(data[_META_KEY]))["n"]
        if n_saved < len(tpl_leaves):
            raise ValueError(
                f"checkpoint {path}.npz has {n_saved} leaves, fewer than "
                f"the {len(tpl_leaves)} params leaves of this model")
        leaves = []
        for i, tpl in enumerate(tpl_leaves):
            saved = data[f"leaf_{i}"]
            if tuple(saved.shape) != tuple(np.shape(tpl)):
                raise ValueError(
                    f"checkpoint params leaf_{i} shape {tuple(saved.shape)} "
                    f"!= model shape {tuple(np.shape(tpl))} — different "
                    "ranker architecture?")
            leaves.append(saved)
    return _tree_unflatten(params_template, leaves)


def read_metadata(path: str) -> dict:
    """Read only the JSON metadata of a checkpoint (no template needed)."""
    with np.load(path + ".npz") as data:
        if _META_KEY in data.files:
            return json.loads(str(data[_META_KEY])).get("metadata", {})
    return {}
