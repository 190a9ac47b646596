"""Fused linear layer with a PWL epilogue: ``act(x @ W + b)`` in one pass.

Replaces ``repro/kernels/fused/linear.py:_linear_kernel`` (forward) and
``_linear_bwd_kernel`` (backward), whisper's MLP input projection.  The
CUDA kernels are the GLU's (``csrc/glu.cu``) with one weight matrix: the
product accumulates in f32 registers, the bias is added to the accumulator
after the last K tile, and the forward decodes it (``csrc/pwl_decode.cuh``)
before the one store in x's dtype.  The backward recomputes the accumulator
the same way and writes ``dz = g·m(x @ W + b)`` in f32, so the
pre-activation never goes through device memory.  ``dx = dz @ Wᵀ``,
``dW = xᵀ @ dz`` (f32 ``torch.matmul``, as the JAX package leaves them to
XLA) and ``db = Σ dz`` follow.

What bounds them on an H100: at whisper's decode and prefill shapes (K =
768, N = 3072, M = 4 or 128) the 4.7 MB of bf16 weights (~1.4 us at
3.35 TB/s); at the encoder's M = 6000 (4 x 1500 frames) the 28 GFLOP of
the product, which bf16 runs on the tensor cores and decodes by the
breakpoint search, as the GLU's (f32, and bf16 at M <= 4, keep the
CUDA-core kernel).

A CPU tensor takes the plain versions below; a CUDA tensor launches the
kernels or raises.  ``impl_bwd="recompute"`` keeps the forward kernel and
takes ``dz`` by plain recomputation.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pwl import PWLTable

from .backward import resolve_impl_bwd
from .epilogue import (
    EPILOGUE_ARGTYPES,
    EpiloguePlan,
    check_kernel_operands,
    device_operands,
    refuse_unsorted,
)
from .glu import kernel_table

# the epilogue, then the prefix table of the search decode
_SIGNATURES = {
    "linear_pwl_forward": [ctypes.c_void_p] * 3 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "linear_pwl_backward": [ctypes.c_void_p] * 4 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _preactivation(x, w, b):
    """``x @ w + b`` in f32: the product first, then the bias."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    return z if b is None else z + b.to(torch.float32)


def fused_linear_plain(x, w, b, plan: EpiloguePlan, tables):
    """Plain PyTorch version on (M, K) x, (K, N) w and (N,) b or None: the
    f32 product, the bias, the epilogue, one cast to x's dtype."""
    return plan.apply(_preactivation(x, w, b), *tables).to(x.dtype)


def fused_linear_bwd_plain(x, w, b, g, plan: EpiloguePlan, tables):
    """Plain version of the backward kernel: ``dz = g·act'(x @ w + b)``, f32
    in g's shape, from the recomputed pre-activation."""
    slope = plan.apply_value_and_slope(_preactivation(x, w, b), *tables)[1]
    return g.to(torch.float32) * slope


def _check_operands(what, x, w, b):
    """x (M, K), w (K, N), b (N,) or None, of one dtype on one CUDA device,
    made contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16, got {x.dtype}")
    M, K = x.shape
    N = w.shape[-1]
    if w.shape != (K, N) or (b is not None and b.shape != (N,)):
        raise ValueError(f"w must be ({K}, {N}) and b ({N},), got {tuple(w.shape)}, "
                         f"{None if b is None else tuple(b.shape)}")
    for t in (w,) if b is None else (w, b):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("w and b must have x's device and dtype")
    return x.contiguous(), w.contiguous(), None if b is None else b.contiguous()


def _launch(what, x, w, b, plan, tables, g=None):
    """The forward kernel (``g`` None; out in x's dtype) or the backward
    kernel (dz, f32) on (M, K) x.  The caller counts the launch."""
    from repro_torch.kernels import _build

    check_kernel_operands(what if g is None else f"{what} backward", plan, tables)
    x, w, b = _check_operands(what, x, w, b)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    if g is not None and (g.shape != (M, N) or g.device != dev):
        raise ValueError(f"g must be ({M}, {N}) on {dev}, got {tuple(g.shape)} on {g.device}")
    out = torch.empty((M, N), dtype=x.dtype if g is None else torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    bias = 0 if b is None else b.data_ptr()
    lib = _build.load("glu", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if g is None:
            err = lib.linear_pwl_forward(
                x.data_ptr(), w.data_ptr(), bias, *kernel_table(plan, tables),
                out.data_ptr(), M, N, K, _KERNEL_DTYPES[x.dtype], stream)
        else:
            g = g.to(x.dtype).contiguous()
            err = lib.linear_pwl_backward(
                x.data_ptr(), w.data_ptr(), bias, g.data_ptr(), *kernel_table(plan, tables),
                out.data_ptr(), M, N, K, _KERNEL_DTYPES[x.dtype], stream)
    _build.check(err, f"{what} {'forward' if g is None else 'backward'}")
    return out


def fused_linear_bwd(x, w, b, g, plan: EpiloguePlan, tables):
    """``dz`` of the fused linear layer on (M, K) x: the backward kernel on
    CUDA tensors, counted on ``fused_linear.bwd_launches``, its plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        refuse_unsorted(plan, tables)
        return fused_linear_bwd_plain(x, w, b, g, plan, tables)
    dz = _launch("fused_linear", x, w, b, plan, tables, g=g)
    fused_linear.bwd_launches += 1
    return dz


class _LinearOp(torch.autograd.Function):
    """The fused linear layer with the JAX package's VJP
    (``linear.py:_linear_op_bwd``); the tables get no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, plan, tables, impl_bwd):
        if x.device.type == "cpu":
            refuse_unsorted(plan, tables)
            y = fused_linear_plain(x, w, b, plan, tables)
        else:  # the kernel, or its refusals (another device among them)
            y = _launch("fused_linear", x, w, b, plan, tables)
            fused_linear.launches += 1
        ctx.save_for_backward(x, w, b)
        ctx.plan, ctx.tables, ctx.impl_bwd = plan, tables, impl_bwd
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        if ctx.impl_bwd == "fused":
            dz = fused_linear_bwd(x, w, b, g, ctx.plan, ctx.tables)
        else:
            dz = fused_linear_bwd_plain(x, w, b, g, ctx.plan, ctx.tables)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = (dz @ w.to(torch.float32).mT).to(x.dtype) if need_x else None
        dw = (x.to(torch.float32).mT @ dz).to(w.dtype) if need_w else None
        db = dz.sum(dim=0).to(b.dtype) if need_b else None
        return dx, dw, db, None, None, None


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                 table: PWLTable | None = None, act: str | None = None,
                 impl_bwd: str | None = None) -> torch.Tensor:
    """``act(x @ w + b)``.  x: (..., K); w: (K, N); b: (N,) or None.

    table -> PWL epilogue, act -> exact epilogue, neither -> identity.  On a
    CUDA tensor each of them runs the hand-written kernels (forward, and
    backward under ``impl_bwd="fused"``).  Differentiable in x, w and b."""
    plan, tables = device_operands(table, act, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _LinearOp.apply(x2, w, b, plan, tables, resolve_impl_bwd(impl_bwd))
    return y.reshape(*lead, w.shape[1])


fused_linear.launches = 0
fused_linear.bwd_launches = 0
