"""Parameter trees: nested dicts and lists of tensors, flattened in the
order of ``jax.tree_util`` (dict keys sorted, lists in order). That is
the order of the port's checkpoints and of its optimizers' flat vectors,
so a leaf's slice of a flat vector is found by the sizes of the leaves
before it."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in tree order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [pair for i, sub in enumerate(tree)
                for pair in flatten(sub, f"{path}/{i}")]
    return [(path, tree)]


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """`tree` with `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [map_tree(fn, sub) for sub in tree]
    return fn(tree)


def _is_spec(node: Any) -> bool:
    """A leaf's spec (kind, shape, fan_in) is a tuple that starts with a
    string."""
    return isinstance(node, tuple) and bool(node) and isinstance(node[0],
                                                                 str)
