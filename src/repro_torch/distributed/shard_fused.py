"""Per-shard fused dispatch: run the hand-written kernels inside ``local_map``.

The torch port of ``repro/distributed/shard_fused.py``.  A kernel's wrapper
reads raw pointers, so it never sees a DTensor (it refuses one): under a
mesh every fused call goes through :func:`run_sharded`, the counterpart of
``shard_map``, whose body receives the plain local tensors of each rank.
Specs, the JAX package's:

  * batch dims shard over the rules' "batch" axes when divisible, else
    replicate;
  * head / feature dims shard over their logical axis ("act_heads", "mlp",
    "cache_kv", ...) when the dim divides the mesh extent, else replicate,
    as ``sanitize_spec`` does to the unfused path;
  * PWL tables are closed over by the body, never passed as operands: every
    rank holds the same small table.

Gradients.  ``local_map`` hands each input's gradient back with the
placements it is told.  An input sharded on a mesh dim gets its shard's
gradient; an input replicated on a mesh dim over which the body's work is
split (another operand is sharded there) gets a ``Partial`` sum, which the
redistribution back to the input's placements reduces (a replicated-in
FSDP weight's gradient is reduce-scattered so); an input replicated where
every operand is, the body's work is redundant there, keeps ``Replicate``.
A body with collectives of its own states its gradients' placements
(``in_grad_specs``).  Collectives inside a body are the autograd functions
below: a reduction whose result every rank of the group then uses alike has
the identity as its backward (each rank already holds the whole gradient).

Design doc: docs/distributed.md (the JAX package's).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .sharding import (
    P,
    Rules,
    is_dtensor,
    logical_extent,
    mesh_shape,
    placements,
    spec_axes,
)


def dim_entry(rules: Rules, logical_axis: Optional[str], dim: int):
    """The spec entry of one tensor dim: the logical axis' mesh axes when
    their extent divides ``dim``, else None (replicate)."""
    axes = spec_axes(rules, logical_axis)
    if not axes:
        return None
    if dim % logical_extent(rules, logical_axis) != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def shard_spec(rules: Rules, logical_axes, shape) -> P:
    """Per-shard spec of a tensor: one logical axis per dim (None =
    replicated), with non-dividing entries dropped."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    return P(*(dim_entry(rules, ax, d) for ax, d in zip(logical_axes, shape)))


def local_shape(rules: Rules, spec, shape) -> tuple:
    """The shape each rank's block of a ``shape`` tensor has under ``spec``."""
    sizes = mesh_shape(rules.mesh)
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            n *= sizes[a]
        out.append(d // n)
    return tuple(out)


def gqa_shard_entries(rules: Rules, q_axis: str, H: int, kv_axis: str, Hkv: int):
    """Spec entries for sharding (q heads, kv heads) together: GQA folds G
    query heads onto each KV head, so a split keeps whole groups per shard,
    q and kv heads over the same mesh axes or not at all (either dim not
    dividing drops both to replicated, as ``sanitize_spec`` does)."""
    h = dim_entry(rules, q_axis, H)
    hk = dim_entry(rules, kv_axis, Hkv)
    if h != hk:
        return None, None
    return h, hk


def batch_entry(rules: Rules, n: int):
    """Spec entry of a leading batch dim (over the "batch" axes when they
    divide ``n``, else replicated)."""
    return dim_entry(rules, "batch", n)


def mesh_axis_sizes(rules: Rules) -> dict:
    """{axis name: size} of the rules' mesh (empty without a mesh)."""
    if rules.mesh is None:
        return {}
    return mesh_shape(rules.mesh)


def replicated(t: torch.Tensor, mesh) -> DTensor:
    """A plain tensor that every rank holds alike, as a replicated DTensor
    (no communication)."""
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def place(t: torch.Tensor, mesh, spec) -> DTensor:
    """A plain tensor that every rank holds alike, as a DTensor placed by
    ``spec``: each rank keeps its own block (no communication)."""
    if is_dtensor(t):
        return t.redistribute(mesh, placements(mesh, spec))
    return replicated(t, mesh).redistribute(mesh, placements(mesh, spec))


def _grad_placements(mesh, in_pl):
    """Each operand's gradient placements (the module docstring's rule)."""
    split = [any(pl is not None and isinstance(pl[m], Shard) for pl in in_pl)
             for m in range(mesh.ndim)]
    out = []
    for pl in in_pl:
        if pl is None:
            out.append(None)
            continue
        out.append([p if isinstance(p, Shard) else (Partial() if split[m] else Replicate())
                    for m, p in enumerate(pl)])
    return tuple(out)


def _out_placements(mesh, out_specs):
    """A spec's placements; a list is placements already (``Partial``
    among them); a tuple holds one of either per output."""
    if out_specs is None or isinstance(out_specs, list):
        return out_specs
    if isinstance(out_specs, P):
        return placements(mesh, out_specs)
    return tuple(_out_placements(mesh, s) for s in out_specs)


def run_sharded(rules: Rules, fn, operands, in_specs, out_specs, in_grad_specs=None):
    """``fn(*operands)`` per shard on the rules' mesh (``local_map`` with
    ``redistribute_inputs=True``): operands are redistributed to
    ``in_specs`` first (a plain tensor operand must be alike on every rank),
    ``fn`` receives each rank's local blocks and returns local blocks that
    ``out_specs`` (a spec, a list of placements, or a tuple of them)
    describe.
    ``in_grad_specs`` overrides the gradients' placements (a list per
    operand, None for the default rule)."""
    mesh = rules.mesh
    ops, in_pl = [], []
    for t, s in zip(operands, in_specs):
        if torch.is_tensor(t):
            ops.append(t if is_dtensor(t) else replicated(t, mesh))
            in_pl.append(placements(mesh, s))
        else:
            ops.append(t)
            in_pl.append(None)
    grad_pl = list(_grad_placements(mesh, in_pl))
    if in_grad_specs is not None:
        for i, g in enumerate(in_grad_specs):
            if g is not None:
                grad_pl[i] = g
    return local_map(fn, out_placements=_out_placements(mesh, out_specs),
                     in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*ops)


def sharded_call(rules: Rules, in_specs, out_specs, in_grad_specs=None):
    """Decorator form of :func:`run_sharded`."""
    def wrap(fn):
        def call(*operands):
            return run_sharded(rules, fn, operands, in_specs, out_specs, in_grad_specs)
        return call
    return wrap


# ---------------------------------------------------------------------------
# collectives inside a local body


class _SumToAlike(torch.autograd.Function):
    """All-reduce SUM whose result every rank of the group uses alike; the
    backward is the identity (each rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanToAlike(torch.autograd.Function):
    """All-reduce mean; each rank's input contributes 1/n of the result."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _CopyToSplit(torch.autograd.Function):
    """The identity, feeding work split over the group: the backward sums
    the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _SumToSplit(torch.autograd.Function):
    """All-reduce SUM whose result each rank uses for its own shard of the
    work: the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum_split(x, group):
    """Sum over ``group``, each rank then using it for its own shard
    (differentiable; see :class:`_SumToSplit`)."""
    return _SumToSplit.apply(x, group)


def psum(x, group):
    """Sum over ``group`` (differentiable; see :class:`_SumToAlike`)."""
    return _SumToAlike.apply(x, group)


def pmean(x, group):
    """Mean over ``group`` (differentiable)."""
    return _MeanToAlike.apply(x, group)


def copy_to_split(x, group):
    """``x`` unchanged, its gradient summed over ``group``."""
    return _CopyToSplit.apply(x, group)


def pmax(x, group):
    """Max over ``group`` (no gradient: the callers stop it, as JAX does)."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather_dim(x, group, dim: int):
    """The blocks of ``x`` that the ranks of ``group`` hold, concatenated
    along ``dim`` in rank order (a functional all-gather; no gradient: the
    callers gather cache writes)."""
    n = dist.get_world_size(group)
    c10d = torch.ops._c10d_functional
    y = c10d.wait_tensor(c10d.all_gather_into_tensor(x.detach().contiguous(), n,
                                                     group.group_name))
    return torch.cat(y.chunk(n), dim=dim)


def entry_axes(entry) -> tuple:
    """The mesh axes of a spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def entry_index(rules: Rules, entry) -> int:
    """This rank's block index along a dim sharded by ``entry`` (several
    axes split it major to minor)."""
    sizes = mesh_shape(rules.mesh)
    i = 0
    for a in entry_axes(entry):
        i = i * sizes[a] + axis_index(rules, a)
    return i


def axis_index(rules: Rules, axis: str) -> int:
    """This rank's coordinate on the mesh axis ``axis``."""
    mesh = rules.mesh
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def axis_group(rules: Rules, axis: str):
    return rules.mesh.get_group(axis)


def entry_group(rules: Rules, entry):
    """The process group of the ranks that share every coordinate but those
    on the mesh axes of a spec entry: one axis' group, or one group over
    several axes (the mesh flattened over them, in mesh order, so that a
    rank's place in it is :func:`entry_index`)."""
    axes = entry_axes(entry)
    if len(axes) == 1:
        return rules.mesh.get_group(axes[0])
    return rules.mesh[axes]._flatten().get_group()


__all__ = [
    "P",
    "all_gather_dim",
    "axis_group",
    "axis_index",
    "batch_entry",
    "copy_to_split",
    "dim_entry",
    "entry_axes",
    "entry_group",
    "entry_index",
    "gqa_shard_entries",
    "local_shape",
    "mesh_axis_sizes",
    "place",
    "pmax",
    "pmean",
    "psum",
    "psum_split",
    "replicated",
    "run_sharded",
    "shard_spec",
    "sharded_call",
]
