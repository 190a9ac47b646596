"""Fused GLU with a PWL epilogue: ``act(x @ Wg) * (x @ Wu)`` in one pass.

Replaces ``repro/kernels/fused/glu.py:_glu_kernel`` (forward) and
``_glu_bwd_kernel`` (backward).  The CUDA kernels are in ``csrc/glu.cu``:
both products share each x tile and accumulate in f32 registers.  The
forward decodes the gate accumulator (``csrc/pwl_decode.cuh``) before the
one store in x's dtype.  The backward recomputes both accumulators the same
way, decodes value and slope at once and writes
``(dzg, dzu) = (g·zu·m(zg), g·PWL(zg))`` in f32, so the pre-activation never
goes through device memory.  ``dx``, ``dWg`` and ``dWu`` are then f32
``torch.matmul`` products, as the JAX package leaves them to XLA.

What bounds them on an H100: at the serving shapes (K = 768, N = 3072,
M = 4 per decode step, M = 32 per prefill) the forward reads 9.4 MB of bf16
weights for ~0.3 GFLOP, so it is bound by weight bytes (~2.8 us at
3.35 TB/s).  The kernel streams every weight once per M tile through a
ring of 16-byte ``cp.async`` copies, uses narrow 4x16 / 8x16 output tiles
for small M (192 blocks at N = 3072, each K tile split over 8 warps) so
every SM streams weights, and masks ragged edges instead of padding copies
of the weights.  At the training shape (M = 4096) both passes are
products: 38.7 GFLOP each, 39 us on bf16 tensor cores, 577 us as the f32
FMAs on CUDA cores that the 64x64 tiles of both kernels still use.

A CPU tensor takes the plain versions below (same decode order); a CUDA
tensor launches the kernels or raises.  ``impl_bwd="recompute"`` keeps the
forward kernel and recomputes the backward with plain ops.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pwl import PWLTable

from .backward import resolve_impl_bwd
from .epilogue import EpiloguePlan, check_kernel_operands, device_operands

_SIGNATURES = {
    "glu_pwl_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "glu_pwl_backward": [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_glu_plain(x, w_gate, w_up, plan: EpiloguePlan, tables):
    """Plain PyTorch version: f32 products, the same epilogue, one cast."""
    xf = x.to(torch.float32)
    zg = xf @ w_gate.to(torch.float32)
    zu = xf @ w_up.to(torch.float32)
    return (plan.apply(zg, *tables) * zu).to(x.dtype)


def fused_glu_bwd_plain(x, w_gate, w_up, g, plan: EpiloguePlan, tables):
    """Plain version of the backward kernel on (M, K) x and (M, N) g:
    ``(dzg, dzu) = (g·zu·act'(zg), g·act(zg))``, each (M, N) f32, from the
    recomputed f32 products."""
    xf = x.to(torch.float32)
    zg = xf @ w_gate.to(torch.float32)
    zu = xf @ w_up.to(torch.float32)
    act_zg, slope = plan.apply_value_and_slope(zg, *tables)
    gf = g.to(torch.float32)
    return gf * zu * slope, gf * act_zg


def _check_operands(x2, w_gate, w_up):
    if x2.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_glu kernel takes float32 or bfloat16, got {x2.dtype}")
    dev = x2.device
    if w_gate.device != dev or w_up.device != dev:
        raise ValueError("x, w_gate and w_up must be on the same device")
    if w_gate.dtype != x2.dtype or w_up.dtype != x2.dtype:
        raise TypeError("w_gate and w_up must have x's dtype")
    K = x2.shape[1]
    N = w_gate.shape[1]
    if w_gate.shape != (K, N) or w_up.shape != (K, N):
        raise ValueError(f"weights must be ({K}, {N}), got {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    return x2.contiguous(), w_gate.contiguous(), w_up.contiguous()


def _launch(x2, w_gate, w_up, plan, tables):
    from repro_torch.kernels import _build

    check_kernel_operands("GLU", plan, tables)
    x2, wg, wu = _check_operands(x2, w_gate, w_up)
    M, K = x2.shape
    N = wg.shape[1]
    bp, dmq = tables
    dev = x2.device
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


def _launch_bwd(x2, w_gate, w_up, g2, plan, tables):
    from repro_torch.kernels import _build

    check_kernel_operands("GLU backward", plan, tables)
    x2, wg, wu = _check_operands(x2, w_gate, w_up)
    M, K = x2.shape
    N = wg.shape[1]
    if g2.shape != (M, N) or g2.device != x2.device:
        raise ValueError(f"g must be ({M}, {N}) on {x2.device}, got {tuple(g2.shape)} "
                         f"on {g2.device}")
    g2 = g2.to(x2.dtype).contiguous()
    bp, dmq = tables
    dev = x2.device
    dzg = torch.empty((M, N), dtype=torch.float32, device=dev)
    dzu = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return dzg, dzu
    lib = _build.load("glu", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.glu_pwl_backward(
            x2.data_ptr(), wg.data_ptr(), wu.data_ptr(), g2.data_ptr(), bp.data_ptr(),
            dmq.data_ptr(), plan.n_bp, dzg.data_ptr(), dzu.data_ptr(), M, N, K,
            _KERNEL_DTYPES[x2.dtype], stream)
    _build.check(err, "glu_pwl_backward")
    fused_glu.bwd_launches += 1
    return dzg, dzu


def fused_glu_bwd(x2, w_gate, w_up, g2, plan: EpiloguePlan, tables):
    """``(dzg, dzu)`` of the GLU: the backward kernel on CUDA tensors, its
    plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return fused_glu_bwd_plain(x2, w_gate, w_up, g2, plan, tables)
    if x2.device.type == "cuda":
        return _launch_bwd(x2, w_gate, w_up, g2, plan, tables)
    raise ValueError(f"fused_glu runs on cpu or cuda tensors, got {x2.device}")


class _GLUOp(torch.autograd.Function):
    """The fused GLU with the JAX package's VJP (``glu.py:_glu_op_bwd``)."""

    @staticmethod
    def forward(ctx, x2, w_gate, w_up, plan, tables, impl_bwd):
        if x2.device.type == "cpu":
            y = fused_glu_plain(x2, w_gate, w_up, plan, tables)
        elif x2.device.type == "cuda":
            y = _launch(x2, w_gate, w_up, plan, tables)
        else:
            raise ValueError(f"fused_glu runs on cpu or cuda tensors, got {x2.device}")
        ctx.save_for_backward(x2, w_gate, w_up)
        ctx.plan, ctx.tables, ctx.impl_bwd = plan, tables, impl_bwd
        return y

    @staticmethod
    def backward(ctx, g):
        x, wg, wu = ctx.saved_tensors
        plan, tables = ctx.plan, ctx.tables
        if ctx.impl_bwd == "fused":
            dzg, dzu = fused_glu_bwd(x, wg, wu, g, plan, tables)
        else:
            dzg, dzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
        xf, wgf, wuf = (a.to(torch.float32) for a in (x, wg, wu))
        need_x, need_wg, need_wu = ctx.needs_input_grad[:3]
        dx = (dzg @ wgf.T + dzu @ wuf.T).to(x.dtype) if need_x else None
        dwg = (xf.T @ dzg).to(wg.dtype) if need_wg else None
        dwu = (xf.T @ dzu).to(wu.dtype) if need_wu else None
        return dx, dwg, dwu, None, None, None


def fused_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
              table: PWLTable | None = None, act: str | None = None,
              impl_bwd: str | None = None) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)``.  x: (..., K); w_gate/w_up: (K, N).

    table -> PWL epilogue, act -> exact epilogue, neither -> plain bilinear
    GLU.  On a CUDA tensor the PWL epilogue with an f32 or int8 table runs
    the hand-written kernels (forward, and backward under
    ``impl_bwd="fused"``); anything else there raises.  Differentiable in
    x, w_gate and w_up."""
    plan, tables = device_operands(table, act, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _GLUOp.apply(x2, w_gate, w_up, plan, tables, resolve_impl_bwd(impl_bwd))
    return y.reshape(*lead, w_gate.shape[1])


fused_glu.launches = 0
fused_glu.bwd_launches = 0
