"""Fused GLU with a PWL epilogue: ``act(x @ Wg) * (x @ Wu)`` in one pass.

Replaces ``repro/kernels/fused/glu.py:_glu_kernel`` (forward).  The CUDA
kernel is ``csrc/glu.cu``: both products share each x tile, accumulate in
f32 registers, and the PWL decode (``csrc/pwl_decode.cuh``) runs on the gate
accumulator before the one store in x's dtype.

What bounds it on an H100: at the serving shapes (K = 768, N = 3072,
M = 4 per decode step, M = 32 per prefill) the call reads 9.4 MB of bf16
weights for ~0.3 GFLOP, so it is bound by weight bytes (~2.8 us at
3.35 TB/s).  The kernel streams every weight once per M tile through a
ring of 16-byte ``cp.async`` copies, uses narrow 4x16 / 8x16 output tiles
for small M (192 blocks at N = 3072, each K tile split over 8 warps) so
every SM streams weights, and masks ragged edges instead of padding copies
of the weights.

A CPU tensor takes the plain version below (same decode order); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pwl import PWLTable

from .epilogue import EpiloguePlan, check_kernel_operands, device_operands

_SIGNATURES = {
    "glu_pwl_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_glu_plain(x, w_gate, w_up, plan: EpiloguePlan, tables):
    """Plain PyTorch version: f32 products, the same epilogue, one cast."""
    xf = x.to(torch.float32)
    zg = xf @ w_gate.to(torch.float32)
    zu = xf @ w_up.to(torch.float32)
    return (plan.apply(zg, *tables) * zu).to(x.dtype)


def _launch(x2, w_gate, w_up, plan, tables):
    from repro_torch.kernels import _build

    check_kernel_operands("GLU", plan, tables, x2, w_gate, w_up)
    if x2.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_glu kernel takes float32 or bfloat16, got {x2.dtype}")
    dev = x2.device
    if w_gate.device != dev or w_up.device != dev:
        raise ValueError("x, w_gate and w_up must be on the same device")
    if w_gate.dtype != x2.dtype or w_up.dtype != x2.dtype:
        raise TypeError("w_gate and w_up must have x's dtype")
    M, K = x2.shape
    N = w_gate.shape[1]
    if w_gate.shape != (K, N) or w_up.shape != (K, N):
        raise ValueError(f"weights must be ({K}, {N}), got {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    x2, wg, wu = x2.contiguous(), w_gate.contiguous(), w_up.contiguous()
    bp, dmq = tables
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    lib = _build.load("glu", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.glu_pwl_forward(
            x2.data_ptr(), wg.data_ptr(), wu.data_ptr(), bp.data_ptr(), dmq.data_ptr(),
            plan.n_bp, out.data_ptr(), M, N, K, _KERNEL_DTYPES[x2.dtype], stream)
    _build.check(err, "glu_pwl_forward")
    fused_glu.launches += 1
    return out


def fused_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
              table: PWLTable | None = None, act: str | None = None) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)``.  x: (..., K); w_gate/w_up: (K, N).

    table -> PWL epilogue, act -> exact epilogue, neither -> plain bilinear
    GLU.  On a CUDA tensor the PWL epilogue with an f32 or int8 table runs
    the hand-written kernel; anything else there raises."""
    plan, tables = device_operands(table, act, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = fused_glu_plain(x2, w_gate, w_up, plan, tables)
    elif x.device.type == "cuda":
        y = _launch(x2, w_gate, w_up, plan, tables)
    else:
        raise ValueError(f"fused_glu runs on cpu or cuda tensors, got {x.device}")
    return y.reshape(*lead, w_gate.shape[1])


fused_glu.launches = 0
