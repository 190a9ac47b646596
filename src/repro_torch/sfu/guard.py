"""sfu.guard — opt-in numerical guardrails for the PWL activation path.

The torch port of ``repro/sfu/guard.py``, with its names and semantics.  A
PWL table is only fitted over a finite breakpoint range; inputs outside it
are clamped to the end segments, and a corrupted table (or an injected
fault) can emit non-finite values that would silently poison a whole
continuous batch.  This module holds:

- **clamp counters**: per-site counts of inputs that fell outside the
  fitted table range ``[bp[0], bp[-1]]``;
- **finite checks**: per-site counts of non-finite outputs at the
  fused-kernel checkpoints (MLP hidden, MoE combine, the fused attention's
  and the paged decode's outputs);
- **NaN fault injection**: a context that corrupts one element of a chosen
  site's output (used by ``serving.faults``, which lives above this module:
  the hook lives here so the model layers never import the serving
  package).

Counters are collected through a context stack: the serving engine opens
:func:`collecting` around one model call, the layers' hooks add to it, and
the engine reads ``{site: int32[2]}`` back (index 0 = clamped inputs, index
1 = non-finite outputs).  Each hook adds one small device tensor and reads
nothing back; :meth:`GuardCollector.to_host` stacks a call's counts and
copies them to the host in one transfer.

With no collector and no armed fault every hook returns its input as it is
and launches nothing, so the guard costs nothing unless the engine asked
for it.

The JAX package also has ``capture()`` and ``emit()``: its layer stack is a
``lax.scan``, whose body cannot add traced counts to a collector opened
outside it, so the counts travel out as the scan's outputs.  The port runs
its layers in a Python loop (``models/transformer.py:_run_layers``), where
every hook adds to the open collector directly, so it needs neither.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

# Context stacks (one model call at a time per process, as the engine runs).
_COLLECTORS: list["GuardCollector"] = []
_FORCE_NAN: list[str] = []


class GuardCollector:
    """Accumulates per-site ``int32[2]`` = [clamped, nonfinite] counts, as
    device tensors."""

    def __init__(self):
        self._counts: dict[str, list[torch.Tensor]] = {}

    def add(self, key: str, clamped, nonfinite: torch.Tensor) -> None:
        """``clamped`` a 0-d count tensor or None (no clamp count);
        ``nonfinite`` a 0-d count tensor."""
        if clamped is None:
            clamped = torch.zeros_like(nonfinite)
        self._counts.setdefault(key, []).append(torch.stack([clamped, nonfinite]))

    def result(self) -> dict:
        """``{site: int32[2]}`` on the device, each summed over its hooks."""
        return {k: recs[0] if len(recs) == 1 else torch.stack(recs).sum(dim=0, dtype=torch.int32)
                for k, recs in self._counts.items()}

    def to_host(self) -> dict:
        """:meth:`result` as numpy ``int32[2]`` arrays, in one transfer."""
        counts = self.result()
        if not counts:
            return {}
        host = torch.stack(list(counts.values())).cpu().numpy()
        return dict(zip(counts, host))


def active() -> bool:
    return bool(_COLLECTORS)


def _top():
    return _COLLECTORS[-1] if _COLLECTORS else None


@contextlib.contextmanager
def collecting():
    """Engine-level scope: collect the guard counts the hooks add."""
    col = GuardCollector()
    _COLLECTORS.append(col)
    try:
        yield col
    finally:
        _COLLECTORS.pop()


@contextlib.contextmanager
def force_nan(site: str):
    """Fault hook: while active, ``check_fused(site, y)`` replaces element 0
    of ``y`` with NaN.  Used by ``serving.faults``."""
    _FORCE_NAN.append(site)
    try:
        yield
    finally:
        _FORCE_NAN.pop()


def _maybe_corrupt(key: str, y):
    """``y``, or a copy of it with element 0 (in row-major order) NaN while
    a fault is armed for ``key`` (a copy: ``y`` may be a kernel's output
    that something else still reads)."""
    if _FORCE_NAN and _FORCE_NAN[-1] == key:
        y = y.clone(memory_format=torch.contiguous_format)
        y.view(-1)[0] = float("nan")
    return y


def count_nonfinite(y) -> torch.Tensor:
    """The number of non-finite elements of ``y``, an int32 0-d tensor:
    ``y * 0`` is 0 exactly where ``y`` is finite and NaN elsewhere (three
    kernels on the card; ``torch.isfinite`` alone takes four)."""
    return torch.mul(y, 0).ne_(0).sum(dtype=torch.int32)


def count_outside(x, lo: float, hi: float) -> torch.Tensor:
    """The number of elements of ``x`` outside ``[lo, hi]`` (compared in x's
    dtype, as JAX compares against a weakly typed float), an int32 0-d
    tensor."""
    return torch.logical_or(x < lo, x > hi).sum(dtype=torch.int32)


def check_fused(key: str, y, clamped=None):
    """Guard checkpoint at a fused-kernel output.

    Applies any armed NaN fault for ``key`` (even with no collector, so
    corruption propagates as it would when the guard is off), then — under
    an active collector — counts non-finite outputs.  ``clamped`` is an
    optional pre-computed clamp count (fused kernels consume the
    pre-activation internally; callers that can recompute it pass it here,
    others report 0)."""
    y = _maybe_corrupt(key, y)
    col = _top()
    if col is not None:
        col.add(key, clamped, count_nonfinite(y))
    return y


def wrap_elementwise(key: str, fn, lo: float, hi: float):
    """Wrap an elementwise activation so that, under an active collector,
    inputs outside the fitted table range ``[lo, hi]`` and non-finite
    outputs are counted.  The counts never feed the output value, so
    autograd through the wrapped fn is unchanged."""

    def guarded(x):
        y = fn(x)
        col = _top()
        if col is not None:
            col.add(key, count_outside(x, lo, hi), count_nonfinite(y))
        return y

    return guarded


# Warn-once latch for the degradation path (reset via sfu.reset_all_warnings).
_WARNED: set = set()


def warn_nonfinite(key: str, degraded_to: str) -> None:
    """Warn once per site that its output went non-finite and the step is
    being re-run with a degraded impl.  The message deliberately avoids the
    word "fused" so zero-fallback warning filters don't count it."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(
        f"sfu.guard: non-finite values detected in output of activation "
        f"site {key!r}; re-running the step with impl={degraded_to!r} for "
        f"that site (recorded in the engine health summary)",
        stacklevel=2,
    )


def reset_guard_warnings() -> None:
    _WARNED.clear()

