"""Plain oracles of the PWL activation (the JAX package's
``kernels/ref.py``): a compare-count decode, a coefficient gather and a
multiply-add, computed in the table's dtype.

They are other functions than the kernels' plain versions in
:mod:`.pwl_act`: the decode here gathers the segment's (m, q) where the
kernels accumulate deltas, and the uniform oracle divides by the segment
width where the uniform kernel multiplies by its inverse.
"""
from __future__ import annotations

import torch

from repro_torch.core.pwl import PWLTable


def pwl_activation_ref(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """Non-uniform PWL: compare-count decode + coefficient gather + MADD."""
    m, q, bp = (t.to(x.device) for t in (table.m, table.q, table.bp))
    xf = x.to(m.dtype)
    idx = (xf[..., None] > bp.to(m.dtype)).sum(dim=-1)
    return (m[idx] * xf + q[idx]).to(x.dtype)


def pwl_activation_uniform_ref(x: torch.Tensor, lo: float, hi: float, m: torch.Tensor,
                               q: torch.Tensor) -> torch.Tensor:
    """Uniform PWL baseline: segment i covers [lo + (i-1)h, lo + ih), with a
    boundary segment on each side; m and q have n_inner + 2 entries.  The
    constants are rounded to the table's dtype first, as JAX's weakly typed
    scalars are."""
    m, q = m.to(x.device), q.to(x.device)
    cdtype = m.dtype
    xf = x.to(cdtype)
    n_inner = m.shape[0] - 2
    lo_t = torch.tensor(lo, dtype=cdtype, device=x.device)
    h_t = torch.tensor((hi - lo) / n_inner, dtype=cdtype, device=x.device)
    idx = torch.clamp(torch.floor((xf - lo_t) / h_t).to(torch.int32) + 1, 0, n_inner + 1)
    idx = idx.long()
    return (m[idx] * xf + q[idx]).to(x.dtype)


def pwl_softmax_ref(x: torch.Tensor, table: PWLTable, axis: int = -1) -> torch.Tensor:
    """Softmax with the PWL exp (paper Sec. V-B: exp(x - max)), negative
    dips of the table's left tail clamped at 0."""
    e = pwl_activation_ref(x - x.amax(dim=axis, keepdim=True), table)
    e = torch.clamp(e, min=0.0)
    return e / e.sum(dim=axis, keepdim=True)
