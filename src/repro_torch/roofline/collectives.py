"""Collective traffic, FLOPs and the op histogram of one rank's traced step.

The port's counterpart of ``repro/roofline/hlo_parse.py``.  JAX reads these
from the compiled SPMD program's HLO text; the port has no HLO, so it reads
the program as it runs: :class:`trace` is a ``TorchDispatchMode`` that
records every op one rank issues.  A DTensor op is handed back to DTensor
(``NotImplemented``, as ``CommDebugMode`` does), so what is recorded is the
rank's own program: its local products at their local shapes, and every
collective, whether DTensor's redistributions issue it (the functional
``_c10d_functional.*`` ops) or a ``local_map`` body does (the in-place
``c10d.*_`` ops of ``torch.distributed``); the ops DTensor runs on fake
tensors to propagate global shapes are not the rank's and are left out.
On meta tensors under a fake
process group (``launch/dryrun.py``) nothing runs and nothing is sent.

  * :func:`collective_bytes` sums the output bytes of every collective, by
    the JAX package's kinds: the same ``{kind: bytes, "total", "count"}``.
  * FLOPs are counted by ``torch.utils.flop_counter``'s formulas
    (``FlopCounterMode``'s registry, the fused kernels' meta ops among
    them) on the local shapes: per device, as ``cost_analysis`` counts the
    partitioned program, where ``FlopCounterMode`` on DTensors counts the
    global product.
  * ``transcendentals`` counts the output elements of the transcendental
    ops (exp, log, tanh, sigmoid, sqrt, ...), and ``bytes`` the bytes every
    op other than a view or an allocation reads and writes: the eager
    program's traffic, with no fusion (JAX's ``bytes accessed`` is the
    fused program's).
  * :func:`op_histogram` counts the products (``mm``, ``bmm``, ``addmm``,
    ``convolution``) and the port's own ops (``custom-call``: the
    ``repro_torch::*`` meta ops of the fused kernels), the counterpart of
    JAX's ``dot``, ``convolution`` and ``custom-call``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# op-name fragments of each kind, the first that matches wins
_KINDS = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_gather", "all-gather"),
    ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
    ("send", "collective-permute"),
    ("recv", "collective-permute"),
)
_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional", "_c10d_functional_autograd")


def collective_kind(op_name: str):
    """The JAX kind of a ``namespace::name`` collective op, or None (not a
    collective, or a kind JAX's parser has none of: broadcast, scatter)."""
    ns, _, name = op_name.partition("::")
    if ns not in _NAMESPACES:
        return None
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


def _nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "sqrt", "rsqrt",
    "sin", "cos", "erf", "pow", "silu", "gelu", "softplus"})


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in pytree.tree_leaves(tree))


@dataclasses.dataclass
class Record:
    """One rank's traced program: its collectives as (kind, output bytes),
    its FLOPs, transcendentals and bytes, and every op's count by
    ``namespace::name``."""

    collectives: list = dataclasses.field(default_factory=list)
    flops: int = 0
    transcendentals: int = 0
    bytes: int = 0
    ops: Counter = dataclasses.field(default_factory=Counter)


class trace(TorchDispatchMode):
    """``with trace() as rec: step(...)`` records what this rank issues
    (the module docstring) into ``rec``, a :class:`Record`."""

    def __init__(self):
        super().__init__()
        self.record = Record()

    def __enter__(self):
        super().__enter__()
        return self.record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not isinstance(func, torch._ops.OpOverload):  # a higher-order op
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor issues the rank's own ops, seen here
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's shape propagation on global shapes: not run

        packet = func._overloadpacket
        name = f"{func.namespace}::{packet.__name__}"
        rec = self.record
        rec.ops[name] += 1
        kind = collective_kind(name)
        if kind is not None:
            # functional ops return their output; in-place c10d ops write
            # their first argument (the tensors, or the output buffer)
            rec.collectives.append((kind, _nbytes(args[0] if func.namespace == "c10d" else out)))
        elif packet in flop_registry:
            rec.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if packet.__name__ in _TRANSCENDENTAL:
            rec.transcendentals += sum(t.numel() for t in pytree.tree_leaves(out)
                                       if torch.is_tensor(t))
        if not func.is_view and not packet.__name__.startswith("empty"):
            rec.bytes += _tree_bytes((args, kwargs)) + _tree_bytes(out)
        return out


def collective_bytes(record: Record) -> dict:
    """Sum output sizes of collective ops, by kind.  Returns
    {kind: bytes, ..., "total": bytes, "count": n_ops}."""
    out: dict = defaultdict(int)
    for kind, nbytes in record.collectives:
        out[kind] += nbytes
    out["total"] = sum(v for k, v in out.items() if k in COLLECTIVE_OPS)
    out["count"] = len(record.collectives)
    return dict(out)


def collective_counts(record: Record) -> dict:
    """The number of collectives of each kind."""
    return dict(Counter(kind for kind, _ in record.collectives))


def op_histogram(record: Record, ops=("mm", "bmm", "addmm", "convolution",
                                      "custom-call")) -> dict:
    """How often each of ``ops`` ran: aten's products by name, and
    ``custom-call`` for the port's own ops (``repro_torch::*``)."""
    hist: dict = defaultdict(int)
    for name, n in record.ops.items():
        ns, _, op = name.partition("::")
        key = "custom-call" if ns == "repro_torch" else op if ns == "aten" else None
        if key in ops:
            hist[key] += n
    return dict(hist)
