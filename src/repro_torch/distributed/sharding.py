"""Logical-axis sharding rules: one table maps model-space axes to mesh axes.

The torch port of ``repro/distributed/sharding.py``.  The model annotates
tensors with *logical* axes ("batch", "heads", "mlp", ...); a ``Rules``
object, chosen per mesh and per arch, maps them to the axes of a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the JAX
package's axis names ("pod", "data", "model").  Where the JAX package
builds a ``PartitionSpec`` and a ``NamedSharding``, the port builds its own
:class:`P` (a tuple of entries: None, an axis name, or a tuple of names) and
turns it into DTensor placements (:func:`placements`): a tensor dim sharded
over ``("pod", "data")`` takes ``Shard(d)`` on both mesh dims, in mesh
order.  ``constrain`` is ``with_sharding_constraint``: it redistributes a
DTensor to the sanitised placements (a ``Partial`` sum is reduced there).

Auto-selection (``make_rules``), the JAX package's:
  * attention TP over heads when head counts divide the model axis,
    sequence-parallel attention otherwise;
  * experts always shard over "model" (EP);
  * FSDP shards the d_model rows of weights over "data";
  * batch shards over ("pod", "data") so pods compose data parallelism.

A mesh is a ``DeviceMesh``, or an :class:`AbstractMesh` (axis names and
sizes, no process group) for deriving specs and shapes without ranks.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
import warnings
from typing import Optional

from torch.distributed.tensor import DTensor, Replicate, Shard


class P(tuple):
    """A partition spec: one entry per tensor dim (None, a mesh axis name,
    or a tuple of names), the port's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices or process group."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_names(mesh) -> tuple:
    if isinstance(mesh, AbstractMesh):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class Rules:
    table: dict
    mesh_axes: tuple
    mesh: object = None  # DeviceMesh or AbstractMesh

    def spec(self, *logical_axes) -> P:
        phys = []
        used = set()
        for ax in logical_axes:
            m = self.table.get(ax) if ax is not None else None
            if m is None:
                phys.append(None)
                continue
            ms = tuple(m) if isinstance(m, (tuple, list)) else (m,)
            ms = tuple(a for a in ms if a in self.mesh_axes and a not in used)
            used.update(ms)
            phys.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return P(*phys)

    def tree_specs(self, logical_tree):
        return _map_axes(lambda axes: self.spec(*axes), logical_tree)


def _map_axes(fn, tree):
    """Map ``fn`` over the logical-axis tuples of a tree of dicts and lists."""
    if isinstance(tree, tuple):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return [_map_axes(fn, v) for v in tree]


_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "active_rules", default=None)


def active_rules() -> Optional[Rules]:
    """The Rules activated by the innermost ``use_rules`` (or None)."""
    return _ACTIVE.get()


def active_mesh_rules() -> Optional[Rules]:
    """The active Rules when they carry a mesh of more than one rank: the
    shard-aware dispatch predicate of the fused call sites, which then run
    their kernel per shard (``distributed.shard_fused``).  None for no
    rules, no mesh, or a one-rank mesh."""
    rules = _ACTIVE.get()
    if rules is not None and rules.mesh is not None and mesh_size(rules.mesh) > 1:
        return rules
    return None


def spec_axes(rules: Rules, logical_axis: Optional[str]) -> tuple:
    """Mesh axes one logical axis maps to under ``rules`` (may be ())."""
    if logical_axis is None:
        return ()
    return _entry_axes(rules.spec(logical_axis)[0])


def logical_extent(rules: Rules, logical_axis: Optional[str]) -> int:
    """Product of the mesh-axis sizes a logical axis shards over."""
    if rules.mesh is None:
        return 1
    return _axis_size(rules.mesh, spec_axes(rules, logical_axis) or None)


class use_rules:
    """Context manager activating a Rules table for ``constrain`` and the
    fused call sites."""

    def __init__(self, rules: Optional[Rules]):
        self.rules = rules

    def __enter__(self):
        self._tok = _ACTIVE.set(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tok)


def unruled(fn):
    """``fn`` run with no rules active: a per-shard body computes as on one
    device."""
    def body(*args):
        with use_rules(None):
            return fn(*args)
    return body


def _axis_size(mesh, entry) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _entry_axes(entry))


# (axis entry, shape) pairs sanitize_spec already reported: a dropped entry
# replicates the tensor, which the user should see once, not at every call
_SANITIZE_WARNED: set = set()


def sanitize_spec(mesh, spec, shape) -> P:
    """Drop spec entries whose mesh-axis product doesn't divide the dim
    (ragged dims: 1500-frame encoders, S=1 decode), replicating that dim.
    Each dropped (axis entry, shape) pair is reported once per process; a
    dim of 1 is replicated without a word."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            key = (tuple(entry) if isinstance(entry, (tuple, list)) else entry,
                   tuple(shape))
            if dim > 1 and key not in _SANITIZE_WARNED:
                _SANITIZE_WARNED.add(key)
                warnings.warn(
                    f"sharding spec entry {entry!r} (mesh extent "
                    f"{_axis_size(mesh, entry)}) does not divide dim {dim} of "
                    f"shape {tuple(shape)}; replicating that dim instead",
                    stacklevel=2,
                )
            entry = None
        out.append(entry)
    return P(*out)


def reset_sanitize_warnings() -> None:
    """Clear the sanitize_spec warn-once state (tests)."""
    _SANITIZE_WARNED.clear()


def placements(mesh, spec) -> list:
    """DTensor placements of a spec on ``mesh``: ``Shard(d)`` on every mesh
    dim that tensor dim ``d``'s entry names, ``Replicate()`` elsewhere.  A
    dim sharded over several axes is split in mesh order, so the entry must
    list them in mesh order (as every rule does): that is the JAX package's
    major-to-minor order."""
    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x, *logical_axes):
    """``with_sharding_constraint`` through the active rules: a DTensor is
    redistributed to the sanitised placements of its logical axes (a
    ``Partial`` result is reduced here).  A no-op without active rules or
    on a plain tensor."""
    rules = _ACTIVE.get()
    if rules is None or not is_dtensor(x):
        return x
    spec = sanitize_spec(rules.mesh, rules.spec(*logical_axes), x.shape)
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def fsdp_gather(x, logical_axes):
    """A DTensor parameter with its "embed" (FSDP) entries gathered, under
    the active rules; anything else as it is."""
    rules = _ACTIVE.get()
    if rules is None or not is_dtensor(x):
        return x
    spec = rules.spec(*(None if a == "embed" else a for a in logical_axes))
    spec = sanitize_spec(x.device_mesh, spec, x.shape)
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def make_rules(cfg, mesh, *, fsdp: bool = True, seq_parallel_attn: Optional[bool] = None,
               shard_vocab: bool = True) -> Rules:
    """Build the rules table for (arch config, mesh): the JAX package's
    table, key for key."""
    shape = mesh_shape(mesh)
    axes = mesh_axis_names(mesh)
    model_size = shape.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)

    heads_divisible = (cfg.n_heads % model_size == 0 and cfg.n_kv_heads % model_size == 0)
    if seq_parallel_attn is None:
        seq_parallel_attn = not heads_divisible

    table = {
        "batch": batch_axes,
        "embed": "data" if fsdp else None,
        "mlp": "model",
        "vocab": "model" if shard_vocab else None,
        "experts": "model",
        "capacity": "data",
        "flat_tokens": batch_axes,
        "layers": None,
        "state": None,
        "conv": None,
        # activation axes: act_seq stays unsharded (sequence-sharded
        # activations force per-product gathers against model-sharded weights)
        "act_embed": None,
        "act_heads": None if seq_parallel_attn else "model",
        "act_kv": None if seq_parallel_attn else "model",
        "act_seq": None,
        # cache axes: kv-heads over model when divisible, else the cache's
        # sequence over model
        "cache_seq": "model" if seq_parallel_attn else None,
        "cache_kv": None if seq_parallel_attn else "model",
        # weight-space attention axes
        "heads": None if seq_parallel_attn else "model",
        "kv": None if seq_parallel_attn else "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
    }
    return Rules(table=table, mesh_axes=tuple(axes), mesh=mesh)


def specs_for_params(rules: Rules, logical_tree):
    """The spec tree of a logical-axes tree (``Model.param_logical()``)."""
    return rules.tree_specs(logical_tree)
