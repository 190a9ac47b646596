"""Trees of tensors (nested dicts and lists), the port's counterpart of
``jax.tree_util`` for the training state.

One order for every flat view: dict keys sorted, list entries in order, the
order in which ``jax.tree_util`` flattens the JAX package's trees.  The
optimizer walks the parameters, their gradients and its moments in it, and
a checkpoint stores its leaves in it with their key paths.
"""
from __future__ import annotations

import torch


def flatten_with_paths(tree, path=()) -> list[tuple[tuple, torch.Tensor]]:
    """(key path, tensor) pairs; a path holds dict keys and list indices."""
    if torch.is_tensor(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_paths(tree[k], path + (k,))]
    return [kv for i, v in enumerate(tree) for kv in flatten_with_paths(v, path + (i,))]


def leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in flatten_with_paths(tree)]


def unflatten(like, new_leaves):
    """A tree shaped like ``like`` with ``new_leaves`` in :func:`leaves`
    order."""
    paths = [p for p, _ in flatten_with_paths(like)]
    return from_paths(paths, new_leaves)


def from_paths(paths, new_leaves):
    """The tree whose leaves sit at ``paths`` (an int key makes a list)."""
    root: dict = {}
    for path, leaf in zip(paths, new_leaves, strict=True):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
