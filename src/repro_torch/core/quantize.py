"""Fixed-point table simulation (paper: 8/16/32-bit fixed-point support) and
full-space int8 table storage (the ``"int8"`` table format).

The hardware stores breakpoints and (m, q) coefficients in b-bit integer
memories with power-of-two scale factors and evaluates y = m·x + q in a wide
accumulator.  :func:`eval_fixed_point` simulates exactly that arithmetic on
the tensor's own device:

  x_q  = round(x / s_x)           (b-bit, saturating)
  bp_q = round(bp / s_x)          (compare in the *input* scale: exact decode)
  m_q  = round(m / s_m),  q_q = round(q / (s_m * s_x))
  y    = (m_q * x_q + q_q) * (s_m * s_x)

Decode compares x_q with bp_q: integer compares, the paper's SIMD integer
comparator.  Accumulator width: the paper's MADD accumulates at 2b bits;
b = 8/16 run in int32, b = 32 in int64 (torch has both on every device).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pwl import PWLTable

_INT_INFO = {8: (-128, 127), 16: (-32768, 32767), 32: (-(2**31), 2**31 - 1)}


def _pow2_scale(max_abs: float, bits: int) -> float:
    """Smallest power-of-two scale s such that max_abs/s fits in `bits`."""
    _, hi = _INT_INFO[bits]
    if max_abs == 0:
        return 1.0
    return float(2.0 ** np.ceil(np.log2(max_abs / hi)))


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


@dataclasses.dataclass
class QuantizedPWLTable:
    """Integer PWL table: the deployable fixed-point artifact.

    Tables are host (numpy) arrays: they are tiny, and a call copies them to
    its input's device once."""

    bp_q: np.ndarray   # (n,)   int64
    m_q: np.ndarray    # (n+1,) int64
    q_q: np.ndarray    # (n+1,) int64 (accumulator scale)
    s_x: float
    s_m: float
    bits: int
    name: str = "?"

    def __call__(self, x):
        return eval_fixed_point(x, self)


def quantize_table(table: PWLTable, bits: int, x_range: tuple[float, float]) -> QuantizedPWLTable:
    if bits not in _INT_INFO:
        raise ValueError(f"bits must be one of {sorted(_INT_INFO)}")
    lo, hi = _INT_INFO[bits]
    bp, m, q = _f64(table.bp), _f64(table.m), _f64(table.q)
    s_x = _pow2_scale(max(abs(x_range[0]), abs(x_range[1]), np.abs(bp).max()), bits)
    s_m = _pow2_scale(np.abs(m).max(), bits)
    bp_q = np.clip(np.round(bp / s_x), lo, hi).astype(np.int64)
    m_q = np.clip(np.round(m / s_m), lo, hi).astype(np.int64)
    # q lives at the accumulator scale s_m*s_x with 2b-bit headroom
    acc_lo, acc_hi = -(2 ** (2 * bits - 1)), 2 ** (2 * bits - 1) - 1
    q_q = np.clip(np.round(q / (s_m * s_x)), acc_lo, acc_hi).astype(np.int64)
    return QuantizedPWLTable(
        bp_q=bp_q, m_q=m_q, q_q=q_q, s_x=s_x, s_m=s_m, bits=bits, name=table.name
    )


def full_space_int8(table: PWLTable) -> PWLTable:
    """Quantize a table to the int8 grid (per-array pow-2 scale) and return
    the de-quantized f32 table tagged ``storage="int8"``.

    Each coefficient array (bp, m, q) gets its own power-of-two scale
    spanning the array's full value range.  ``v_q * s`` is exact in f32
    (|v_q| <= 127 needs 7 mantissa bits, a power-of-two scale only shifts
    the exponent), so the table carries exactly the int8 format error while
    every evaluation path keeps its f32 decode arithmetic.  Unlike
    :func:`quantize_table` this is a *storage* format: inputs and arithmetic
    stay f32."""
    lo, hi = _INT_INFO[8]

    def q8(v):
        v = _f64(v)
        s = _pow2_scale(float(np.abs(v).max()), 8)
        vq = np.clip(np.round(v / s), lo, hi)
        return torch.from_numpy((vq * s).astype(np.float32))

    return PWLTable(bp=q8(table.bp), m=q8(table.m), q=q8(table.q),
                    name=table.name, storage="int8")


def eval_fixed_point(x: torch.Tensor, qt: QuantizedPWLTable) -> torch.Tensor:
    """Simulate the integer datapath on ``x.device``: quantize the input,
    decode by integer compares, accumulate the MADD at 2b bits, de-quantize.
    Returns ``x.dtype``.

    The decode index is ``searchsorted`` (side left) of x_q in bp_q: the
    count of breakpoints strictly below x_q, as the compare-count gives it,
    ties between quantized breakpoints included, without the (..., n)
    compare tensor.  It needs non-decreasing breakpoints, which every table
    quantizes to; others are refused."""
    if np.any(np.diff(qt.bp_q) < 0):
        raise ValueError(f"quantized breakpoints of {qt.name!r} are not non-decreasing")
    lo, hi = _INT_INFO[qt.bits]
    dev = x.device
    if qt.bits == 32:
        xq = torch.clamp(torch.round(x.to(torch.float64) / qt.s_x), lo, hi).to(torch.int64)
        idx = torch.searchsorted(torch.as_tensor(qt.bp_q, device=dev), xq)
        m = torch.as_tensor(qt.m_q, device=dev)[idx]
        q = torch.as_tensor(qt.q_q, device=dev)[idx]
        acc = m * xq + q  # int64 accumulate
        y = acc.to(torch.float64) * (qt.s_m * qt.s_x)
        return y.to(torch.float32).to(x.dtype)
    # round and clip in x's own dtype, the bounds rounded to it (32767 is
    # 32768 in bf16 and f16), as the reference's weak-typed scalars are
    lo_x, hi_x = (float(torch.tensor(v, dtype=x.dtype)) for v in (lo, hi))
    xq = torch.clamp(torch.round(x / qt.s_x), lo_x, hi_x).to(torch.int32)
    idx = torch.searchsorted(torch.as_tensor(qt.bp_q, dtype=torch.int32, device=dev), xq)
    m = torch.as_tensor(qt.m_q, dtype=torch.int32, device=dev)[idx]
    q = torch.as_tensor(qt.q_q, dtype=torch.int32, device=dev)[idx]
    acc = m * xq + q  # int32 accumulate (exact for b<=16)
    return (acc.to(torch.float32) * (qt.s_m * qt.s_x)).to(x.dtype)
