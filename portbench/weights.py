"""The weights of a configuration, made by the benchmark from the seed.

Both sides get the same tensors: the program serves or trains them, and
the plain reference reads them (it upcasts them to float32 a layer at a
time).  The tree has the port's layout, which is a data format like a
checkpoint's; the configuration's family module gives it
(``reference.<family>.layout``).  Every matrix is drawn from
N(0, initializer_range²) (OLMo's and OLMoE's published initialisation,
0.02); a norm's scale is its identity (RMSNorm scales are held as
``1 + scale``, so zeros).

Each leaf is one ``normal_`` call of a ``torch.Generator`` on the device,
in the type it is used in: matrices in the configuration's ``torch_dtype``
to serve, every leaf in float32 as training masters; the router and the
norm scales stay float32 either way.
"""
from __future__ import annotations

import torch

from portbench import reference


def iter_leaves(cfg: dict, seed: int, device, master: bool = False):
    """Yield (path, tensor) in draw order, one leaf at a time, and
    (path, None) for a node with no leaves: the same values as
    :func:`make` for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    mdtype = torch.float32 if master else getattr(torch, cfg["torch_dtype"])
    std = float(cfg["initializer_range"])
    for path, shape, kind in reference.family(cfg).layout(cfg):
        if kind == "empty":
            yield path, None
        elif kind == "norm":
            yield path, torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            dt = mdtype if kind == "matrix" else torch.float32
            yield path, torch.empty(shape, dtype=dt, device=device).normal_(0.0, std,
                                                                             generator=gen)


def get(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


def assemble(leaves) -> dict:
    """The tree of (path, tensor) pairs: a string key makes a dict, an
    integer key a list; a None tensor leaves an empty dict at its path."""
    tree: dict = {}
    for path, t in leaves:
        node = tree
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(k, int):
                while len(node) <= k:
                    node.append([] if isinstance(nxt, int) else {})
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        last = path[-1]
        if isinstance(last, int):
            raise ValueError(f"{path}: a leaf path ends in a key, not an index")
        node[last] = {} if t is None else t
    return tree


def make(cfg: dict, seed: int, device, master: bool = False) -> dict:
    """The whole tree (serving weights, or float32 training masters)."""
    return assemble(iter_leaves(cfg, seed, device, master))


def leaf_paths(cfg: dict) -> list[tuple]:
    """The paths of the tensors (not the empty nodes), in draw order."""
    return [path for path, _, kind in reference.family(cfg).layout(cfg) if kind != "empty"]
