"""Piecewise-linear tables and their plain evaluation.

A ``PWLTable`` holds n sorted breakpoints ``bp`` and n+1 per-segment
``(m, q)`` with ``y = m_i x + q_i``; segment i covers ``(bp_{i-1}, bp_i]``.
The address decode is the strict compare-count ``idx = Σ_i (x > bp_i)``,
so an input exactly on a breakpoint belongs to the segment on its left.

Two forms, as in the paper (Sec. IV): the interpolation form (breakpoints
p, values v, outer slopes m_l and m_r), which :func:`eval_interp` evaluates
and :func:`params_to_coeffs` converts, and the coefficient form the kernels
consume.  :func:`make_uniform_table` builds the uniform-breakpoint table
(the prior-work baseline), :func:`mse` and :func:`mae` measure a table
against its exact function.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import functions as F


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

    def __call__(self, x):
        return eval_coeff(x, self)


def eval_coeff(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """Compare-count decode + gather + multiply-add, in the table's dtype."""
    dev = x.device
    bp, m, q = (t.to(dev) for t in (table.bp, table.m, table.q))
    xf = x.to(m.dtype)
    idx = (xf[..., None] > bp).sum(dim=-1)
    return (m[idx] * xf + q[idx]).to(x.dtype)


def params_to_coeffs(p, v, m_l, m_r, name: str = "?") -> PWLTable:
    """Interpolation form -> coefficient form.  Inner segment i (between
    p_{i-1} and p_i) has m = (v_i - v_{i-1}) / (p_i - p_{i-1}) and
    q = v_{i-1} - m p_{i-1}; the outer segments follow the lines of slope
    m_l through (p_0, v_0) and m_r through (p_{n-1}, v_{n-1})."""
    dp = p[1:] - p[:-1]
    dv = v[1:] - v[:-1]
    m_in = dv / torch.where(dp == 0, torch.ones_like(dp), dp)
    q_in = v[:-1] - m_in * p[:-1]
    m_l = torch.as_tensor(m_l, dtype=p.dtype, device=p.device)
    m_r = torch.as_tensor(m_r, dtype=p.dtype, device=p.device)
    m = torch.cat([m_l[None], m_in, m_r[None]])
    q = torch.cat([(v[0] - m_l * p[0])[None], q_in, (v[-1] - m_r * p[-1])[None]])
    return PWLTable(bp=p, m=m, q=q, name=name)


def eval_interp(x, p, v, m_l, m_r):
    """The interpolation form evaluated directly (differentiable in p and
    v): the inner segment through its two end points, the outer lines
    beyond p_0 and p_{n-1}."""
    n = p.shape[0]
    idx = (x[..., None] > p).sum(dim=-1)
    im = torch.clamp(idx, 1, n - 1)  # inner segment's right end point
    p0, p1, v0, v1 = p[im - 1], p[im], v[im - 1], v[im]
    y_in = (v1 - v0) / (p1 - p0) * (x - p0) + v0
    y_l = m_l * (x - p[0]) + v[0]
    y_r = m_r * (x - p[-1]) + v[-1]
    return torch.where(idx == 0, y_l, torch.where(idx == n, y_r, y_in))


def _edge_slope(spec: F.FunctionSpec, at) -> float:
    """The exact function's derivative at a range edge, by autograd."""
    t = at.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(spec.fn(t).sum(), t)
    return float(g)


def boundary_slopes(spec: F.FunctionSpec, p):
    """Paper Sec. IV boundary condition: the outer slopes lie on the
    asymptotes; at a range edge (exp's right end) the tangent there."""
    m_l, m_r = spec.m_left, spec.m_right
    if spec.left_is_edge:
        m_l = _edge_slope(spec, p[0])
    if spec.right_is_edge:
        m_r = _edge_slope(spec, p[-1])
    return m_l, m_r


def _apply_boundary_values(spec: F.FunctionSpec, p, v):
    """Pin v_0 and v_{n-1} to the asymptote lines (or the exact edge value)."""
    v = v.clone()
    v[0] = spec.fn(p[0]) if spec.left_is_edge else spec.asymptote_left(p[0])
    v[-1] = spec.fn(p[-1]) if spec.right_is_edge else spec.asymptote_right(p[-1])
    return v


def make_uniform_table(spec: F.FunctionSpec, n_breakpoints: int, lo: Optional[float] = None,
                       hi: Optional[float] = None, dtype=torch.float32) -> PWLTable:
    """Uniform-breakpoint table with exact function values (the fit's init
    and the prior-work baseline: uniform segments, O(1) addressing).  The
    breakpoints are the f32 roundings of the evenly spaced points."""
    if lo is None or hi is None:
        lo, hi = spec.default_range
    p = torch.from_numpy(np.linspace(lo, hi, n_breakpoints).astype(np.float32))
    v = _apply_boundary_values(spec, p, spec.fn(p))
    m_l, m_r = boundary_slopes(spec, p)
    t = params_to_coeffs(p, v, m_l, m_r, name=spec.name)
    return PWLTable(t.bp.to(dtype), t.m.to(dtype), t.q.to(dtype), name=spec.name)


def _on_grid(table_or_fn, x):
    return eval_coeff(x, table_or_fn) if isinstance(table_or_fn, PWLTable) else table_or_fn(x)


def mse(table_or_fn, spec: F.FunctionSpec, lo: float, hi: float, n_grid: int = 8192) -> float:
    """Continuous MSE 1/(b-a) ∫ (f̂-f)² dx by the trapezoid rule on an f32
    grid."""
    x = torch.linspace(lo, hi, n_grid, dtype=torch.float32)
    err = (_on_grid(table_or_fn, x) - spec.fn(x)) ** 2
    return float(torch.trapezoid(err, x) / (hi - lo))


def mae(table_or_fn, spec: F.FunctionSpec, lo: float, hi: float, n_grid: int = 8192) -> float:
    """Max absolute error on an f32 grid of ``n_grid`` points."""
    x = torch.linspace(lo, hi, n_grid, dtype=torch.float32)
    return float((_on_grid(table_or_fn, x) - spec.fn(x)).abs().max())
