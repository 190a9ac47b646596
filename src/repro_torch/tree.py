"""Trees of tensors (nested dicts and lists), the port's counterpart of
``jax.tree_util`` for the training state.

One order for every flat view: dict keys sorted, list entries in order, the
order in which ``jax.tree_util`` flattens the JAX package's trees.  The
optimizer walks the parameters, their gradients and its moments in it, and
a checkpoint stores its leaves in it with their key paths.  A subtree
with no leaves (olmo's parameter-free norms, ``{}``) has no place in the
flat view; :func:`unflatten` keeps it from the tree it copies, and
:func:`from_paths` from the paths :func:`empty_paths` lists.
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


def empty_paths(tree, path=()) -> list[tuple]:
    """The key paths of the empty dicts and lists in ``tree``."""
    if torch.is_tensor(tree):
        return []
    if not tree:
        return [path]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    return [p for k, v in items for p in empty_paths(v, path + (k,))]


def leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in flatten_with_paths(tree)]


def unflatten(like, new_leaves):
    """A tree shaped like ``like``, empty subtrees included, with
    ``new_leaves`` in :func:`leaves` order."""
    it = iter(new_leaves)

    def build(node):
        if torch.is_tensor(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return [build(v) for v in node]

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def from_paths(paths, new_leaves, empties=()):
    """The tree whose leaves sit at ``paths`` (an int key makes a list),
    with an empty dict at each path of ``empties``."""
    root: dict = {}
    for path, leaf in zip(paths, new_leaves, strict=True):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    for path in empties:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node.setdefault(path[-1], {})

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
