"""Fused MoE-expert GLU: ``act(x[e] @ Wg[e]) * (x[e] @ Wu[e])`` per expert.

Replaces ``repro/kernels/fused/moe.py:_moe_glu_kernel`` (forward) and
``_moe_bwd_kernel`` (backward).  After dispatch every expert owns a
``(capacity, d_model)`` bucket of tokens; unfused, the two ``ecd,edf->ecf``
products would each write an ``(E, C, F)`` pre-activation to device memory
for the activation and the gating to read back.  The CUDA kernels are the
fused GLU's (``csrc/glu.cu``) with the expert on ``blockIdx.z``: both
products of an expert share its x tile and accumulate in f32 registers, the
forward decodes the gate accumulator before the one store in x's dtype, and
the backward recomputes both accumulators and writes
``(dzg, dzu) = (g·zu·m(zg), g·PWL(zg))`` in f32.  ``dx``, ``dWg`` and ``dWu``
are then batched f32 products, as the JAX package leaves them to XLA.  The
autograd op, the wrappers and the plain versions are the GLU's
(``glu.py``), which take an expert axis; the dense GLU is the E = 1 case.

What bounds them on an H100 at olmoe-1b-7b's experts (E = 64, K = 2048,
N = 1024): the gate and up weights are 537 MB of bf16, read once per call,
~160 us at 3.35 TB/s for the bucket capacities of serving (C = 1 at a
4-slot decode step, 5 for a 32-token prefill, 40 for 256 tokens); at
C = 640 (8 x 512 training tokens) the 344 GFLOP of the two products bound
it.  Every bucket is computed, empty or not, as the JAX kernel computes it.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.  ``impl_bwd="recompute"`` keeps the forward kernel and
recomputes the backward with plain ops.
"""
from __future__ import annotations

import torch

from repro_torch.core.pwl import PWLTable

from .backward import resolve_impl_bwd
from .epilogue import device_operands
from .glu import _GLUOp


def fused_moe_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
                  table: PWLTable | None = None, act: str | None = None,
                  impl_bwd: str | None = None) -> torch.Tensor:
    """Per-expert ``act(x[e] @ w_gate[e]) * (x[e] @ w_up[e])``.

    x: (E, C, K) dispatched expert buckets; w_gate/w_up: (E, K, N).  Returns
    (E, C, N) in x's dtype.  Epilogue selection as in :func:`fused_glu`
    (table -> PWL, act -> exact, neither -> plain bilinear GLU); on a CUDA
    tensor each runs the kernels, with a table of any format (forward, and
    backward under ``impl_bwd="fused"``).
    Differentiable in x, w_gate and w_up.  Its plain versions are the GLU's,
    ``fused_glu_plain`` and ``fused_glu_bwd_plain``, on (E, C, ·) operands;
    ``fused_glu_bwd(..., counter=fused_moe_glu)`` is its backward kernel's
    wrapper."""
    if x.dim() != 3 or w_gate.dim() != 3 or w_up.dim() != 3:
        raise ValueError(f"fused_moe_glu takes x (E, C, K) and weights (E, K, N), got "
                         f"{tuple(x.shape)}, {tuple(w_gate.shape)}, {tuple(w_up.shape)}")
    plan, tables = device_operands(table, act, x.device)
    return _GLUOp.apply(x, w_gate, w_up, plan, tables, resolve_impl_bwd(impl_bwd),
                        fused_moe_glu)


fused_moe_glu.launches = 0
fused_moe_glu.bwd_launches = 0
