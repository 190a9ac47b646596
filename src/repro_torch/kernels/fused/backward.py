"""Backward-implementation selector for the fused kernels.

The fused ops that train (the GLU, the row softmax and the flash
attention) carry two interchangeable backwards, as in the JAX package:

* ``"fused"`` (the default) — the backward kernel: the pre-activation is
  recomputed inside it and the PWL per-segment slope (the activation's exact
  local derivative) is decoded there, so ``dL/dz = g * m_seg(z)`` never goes
  through device memory;
* ``"recompute"`` — plain PyTorch recomputation of the forward (for the
  flash attention, of its dense oracle), then its derivative.  The oracle
  the backward kernels are held against, and the escape hatch if one
  misbehaves.

The forward runs its kernel under both.  Selection is per call
(``impl_bwd=`` on each op) with a process-wide default that
:func:`use_impl_bwd` overrides for a scope.  The mode is read when the
forward runs and kept for its backward.
"""
from __future__ import annotations

import contextlib

IMPL_BWD_MODES = ("fused", "recompute")

_default_impl_bwd = "fused"


def _validate(mode: str) -> str:
    if mode not in IMPL_BWD_MODES:
        raise ValueError(f"impl_bwd must be one of {IMPL_BWD_MODES}, got {mode!r}")
    return mode


def current_impl_bwd() -> str:
    """The process-wide default backward implementation."""
    return _default_impl_bwd


def resolve_impl_bwd(override: str | None) -> str:
    """Resolve a per-call ``impl_bwd=`` argument against the default."""
    if override is None:
        return _default_impl_bwd
    return _validate(override)


@contextlib.contextmanager
def use_impl_bwd(mode: str):
    """Scope the default backward implementation (``"fused"|"recompute"``)."""
    global _default_impl_bwd
    prev, _default_impl_bwd = _default_impl_bwd, _validate(mode)
    try:
        yield
    finally:
        _default_impl_bwd = prev
