"""Minimal pytree helpers for parameter trees: nested dicts and lists of
tensors, the same structure the JAX package uses (`{"w","b"}`,
`{"layers": [{"w","b"}, ...], "out": {"w","b"}}`). Anything that is not a
dict or a list is a leaf."""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply `fn` leaf-wise over `tree` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in `jax.tree.leaves` order (dict keys sorted), so leaf lists of
    the two packages zip together."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_stack(trees: list) -> Any:
    """Trees of the same structure -> one tree whose leaves stack theirs on
    a new leading axis. Tensor leaves go through `torch.stack`; Python
    numbers become a CPU tensor of the values."""
    def stack(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return torch.tensor(leaves)
    return tree_map(stack, trees[0], *trees[1:])


def tree_index(tree: Any, k: int) -> Any:
    """Slice k of every leaf along the leading axis (views of the leaves)."""
    return tree_map(lambda leaf: leaf[k], tree)
