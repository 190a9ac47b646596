"""Frozen counting: operations and bytes of the port's kernels at a cell's
shapes, and the H100's peaks.

The kernel counts are ``chip_smoke.py``'s (``_bound``, ``_moe_bytes``): a
kernel's bound is the larger of the bytes it must move once over the HBM
rate and the FLOPs of its matrix products over the bf16 tensor-core rate.
They live here, beside the benchmark, so that a change to the program
cannot move the yardstick.  The model FLOPs of the ``mfu`` metrics depend
on the architecture and live with its plain reference
(``reference/<family>.py``).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time for a kernel: bytes over the HBM rate against its
    products' FLOPs over the bf16 tensor-core rate."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


def glu_fwd(E: int, M: int, K: int, N: int, esize: int = 2) -> float:
    """The GLU (E = 1) or MoE GLU forward: x (E, M, K), both weights
    (E, K, N) and the output (E, M, N) once each; two products."""
    nbytes = (E * M * K + 2 * E * K * N + E * M * N) * esize
    return bound_s(nbytes, 4.0 * E * M * K * N)


def glu_bwd(E: int, M: int, K: int, N: int, esize: int = 2) -> float:
    """The GLU's backward epilogue kernel: the forward's operands and the
    incoming gradient read once, the f32 dzg and dzu written; it recomputes
    the two products (dx and dW are separate GEMMs)."""
    nbytes = (E * M * K + 2 * E * K * N + E * M * N) * esize + 2 * E * M * N * 4
    return bound_s(nbytes, 4.0 * E * M * K * N)


def _pairs(B: int, H: int, S: int, T: int, causal: bool) -> float:
    """Query-key pairs that a call keeps: S·(S + 1)/2 a head of a square
    causal call (the diagonal kept), S·T without the mask."""
    if causal and S != T:
        raise ValueError("causal counting is for square calls")
    return B * H * (S * (S + 1) / 2.0 if causal else S * T)


def flash_fwd(B: int, H: int, S: int, T: int, dh: int, causal: bool = True,
              esize: int = 2) -> float:
    """Flash attention forward: q·k and p·v over the kept pairs; q, k, v
    read and the output written once."""
    nbytes = (2 * B * S * H * dh + 2 * B * T * H * dh) * esize
    return bound_s(nbytes, 4.0 * _pairs(B, H, S, T, causal) * dh)


def flash_bwd(B: int, H: int, S: int, T: int, dh: int, causal: bool = True,
              esize: int = 2) -> float:
    """Flash attention backward (the three kernels of one call): the five
    products q·k, dout·v, ds·k, ds·q and u·dout over the kept pairs; seven
    (B, S, H, dh) tensors (q, k, v, dout read, dq, dk, dv written) once and
    the f32 row maxima."""
    nbytes = 7 * B * S * H * dh * esize + B * H * S * 4
    return bound_s(nbytes, 10.0 * _pairs(B, H, S, T, causal) * dh)
