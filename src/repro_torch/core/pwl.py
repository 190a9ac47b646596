"""Coefficient-form piecewise-linear tables and their plain evaluation.

A ``PWLTable`` holds n sorted breakpoints ``bp`` and n+1 per-segment
``(m, q)`` with ``y = m_i x + q_i``; segment i covers ``(bp_{i-1}, bp_i]``.
The address decode is the strict compare-count ``idx = Σ_i (x > bp_i)``,
so an input exactly on a breakpoint belongs to the segment on its left.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PWLTable:
    """Coefficient-form PWL table (host tensors).

    storage: the format the table was quantized to ("f32" | "bf16" | "f16"
      | "int8").  An "int8" table holds f32 arrays of de-quantized int8-grid
      values, so the tag is the only record of that format.
    """

    bp: torch.Tensor
    m: torch.Tensor
    q: torch.Tensor
    name: str = "?"
    storage: str = "f32"

    @property
    def n_breakpoints(self) -> int:
        return int(self.bp.shape[0])


def eval_coeff(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """Compare-count decode + gather + multiply-add, in the table's dtype."""
    dev = x.device
    bp, m, q = (t.to(dev) for t in (table.bp, table.m, table.q))
    xf = x.to(m.dtype)
    idx = (xf[..., None] > bp).sum(dim=-1)
    return (m[idx] * xf + q[idx]).to(x.dtype)
