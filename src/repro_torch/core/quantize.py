"""Full-space int8 table storage (the ``"int8"`` table format).

Each coefficient array (bp, m, q) is quantized to int8 with its own
power-of-two scale spanning the array's full value range, then de-quantized
back to f32.  ``v_q * s`` is exact in f32 (|v_q| <= 127 needs 7 mantissa
bits, a power-of-two scale only shifts the exponent), so the returned table
carries exactly the int8 format error while every evaluation path keeps its
f32 decode arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from .pwl import PWLTable

INT8_LO, INT8_HI = -128, 127


def _pow2_scale(max_abs: float) -> float:
    """Smallest power-of-two scale s such that max_abs/s fits in int8."""
    if max_abs == 0:
        return 1.0
    return float(2.0 ** np.ceil(np.log2(max_abs / INT8_HI)))


def full_space_int8(table: PWLTable) -> PWLTable:
    """Quantize a table to the int8 grid (per-array pow-2 scale) and return
    the de-quantized f32 table tagged ``storage="int8"``."""
    def q8(v):
        v = v.detach().cpu().numpy().astype(np.float64)
        s = _pow2_scale(float(np.abs(v).max()))
        vq = np.clip(np.round(v / s), INT8_LO, INT8_HI)
        return torch.from_numpy((vq * s).astype(np.float32))

    return PWLTable(bp=q8(table.bp), m=q8(table.m), q=q8(table.q),
                    name=table.name, storage="int8")
