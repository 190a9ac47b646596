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

What bounds them on an H100: at the training shape (M = 4096, K = 768,
N = 3072) the products, 38.7 GFLOP a pass, 39 us on bf16 tensor cores;
bf16 runs them as ``mma.sync`` bf16 products with f32 accumulation, each
output summed over K in 16-wide chunks from 0 whatever the tile, and
decodes by a binary search over the breakpoints from a host-built prefix
table (:func:`.epilogue.search_prefix`).  At a decode step (M <= 16) the
forward reads 9.4 MB of bf16 weights for ~0.1 GFLOP, bound by weight bytes
(~2.8 us at 3.35 TB/s): bf16 runs the same kernel there in a decode
configuration (one 16-row tile, more warps copying weights by 16-byte
``cp.async`` than multiplying), in the same summation order, so a decode
step's row is bitwise the same row of a prefill.  f32 keeps the CUDA-core
kernel at every M.

A CPU tensor takes the plain versions below (same decode order); a CUDA
tensor launches the kernels or raises.  Both refuse a table whose
breakpoints do not ascend (:func:`.epilogue.check_ascending`).
``impl_bwd="recompute"`` keeps the forward kernel and recomputes the
backward with plain ops.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import _build

from . import meta
from .backward import resolve_impl_bwd
from .epilogue import (
    EPILOGUE_ARGTYPES,
    EpiloguePlan,
    check_kernel_operands,
    device_operands,
    kernel_epilogue,
    refuse_unsorted,
    search_prefix_ptr,
)

# the epilogue, then the prefix table of the search decode
_SIGNATURES = {
    "glu_pwl_forward": [ctypes.c_void_p] * 3 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "glu_pwl_backward": [ctypes.c_void_p] * 4 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_glu_plain(x, w_gate, w_up, plan: EpiloguePlan, tables):
    """Plain PyTorch version on (M, K) x and (K, N) weights, or per expert on
    (E, M, K) x and (E, K, N) weights: f32 products, the same epilogue, one
    cast."""
    xf = x.to(torch.float32)
    zg = xf @ w_gate.to(torch.float32)
    zu = xf @ w_up.to(torch.float32)
    return (plan.apply(zg, *tables) * zu).to(x.dtype)


def fused_glu_bwd_plain(x, w_gate, w_up, g, plan: EpiloguePlan, tables):
    """Plain version of the backward kernel on x and g of g's rank ((M, ·)
    or per expert (E, M, ·)): ``(dzg, dzu) = (g·zu·act'(zg), g·act(zg))``,
    each f32 in g's shape, from the recomputed f32 products."""
    xf = x.to(torch.float32)
    zg = xf @ w_gate.to(torch.float32)
    zu = xf @ w_up.to(torch.float32)
    act_zg, slope = plan.apply_value_and_slope(zg, *tables)
    gf = g.to(torch.float32)
    return gf * zu * slope, gf * act_zg


def kernel_table(plan: EpiloguePlan, tables) -> tuple:
    """The epilogue as the GLU-family kernels take it: :func:`kernel_epilogue`
    and the prefix table's pointer (null without a table).  Refuses a table
    whose breakpoints do not ascend."""
    return (*kernel_epilogue(plan, tables), search_prefix_ptr(plan, tables))


def _check_operands(what, x3, w_gate, w_up):
    """x (E, M, K), w_gate/w_up (E, K, N) of one dtype on one device, made
    contiguous."""
    if x3.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x3.device}")
    if x3.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16, got {x3.dtype}")
    dev = x3.device
    if w_gate.device != dev or w_up.device != dev:
        raise ValueError("x, w_gate and w_up must be on the same device")
    if w_gate.dtype != x3.dtype or w_up.dtype != x3.dtype:
        raise TypeError("w_gate and w_up must have x's dtype")
    E, _, K = x3.shape
    N = w_gate.shape[-1]
    if w_gate.shape != (E, K, N) or w_up.shape != (E, K, N):
        raise ValueError(f"weights must be ({E}, {K}, {N}), got {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    return x3.contiguous(), w_gate.contiguous(), w_up.contiguous()


def _launch_forward(what, x, w_gate, w_up, plan, tables):
    """The forward kernel, one grid slice per expert on (E, M, K) x and
    (E, K, N) weights, or the dense GLU on (M, K) and (K, N) as one expert:
    the output in x's rank and dtype.  The caller counts the launch."""
    from repro_torch.kernels import _build

    if x.dim() == 2:
        return _launch_forward(what, x[None], w_gate[None], w_up[None], plan, tables)[0]
    check_kernel_operands(what, plan, tables)
    x3, wg, wu = _check_operands(what, x, w_gate, w_up)
    E, M, K = x3.shape
    N = wg.shape[-1]
    dev = x3.device
    out = torch.empty((E, M, N), dtype=x3.dtype, device=dev)
    if E == 0 or M == 0 or N == 0:
        return out
    lib = _build.load("glu", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.glu_pwl_forward(
            x3.data_ptr(), wg.data_ptr(), wu.data_ptr(), *kernel_table(plan, tables),
            out.data_ptr(), E, M, N, K, _KERNEL_DTYPES[x3.dtype], stream)
    _build.check(err, f"{what} forward")
    return out


def _launch_backward(what, x, w_gate, w_up, g, plan, tables):
    """The backward kernel on the forward's operands and g of the output's
    shape: ``(dzg, dzu)``, each f32 in g's shape.  The caller counts the
    launch."""
    from repro_torch.kernels import _build

    if x.dim() == 2:
        dzg, dzu = _launch_backward(what, x[None], w_gate[None], w_up[None], g[None], plan,
                                    tables)
        return dzg[0], dzu[0]
    check_kernel_operands(f"{what} backward", plan, tables)
    x3, wg, wu = _check_operands(what, x, w_gate, w_up)
    E, M, K = x3.shape
    N = wg.shape[-1]
    if g.shape != (E, M, N) or g.device != x3.device:
        raise ValueError(f"g must be ({E}, {M}, {N}) on {x3.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    g3 = g.to(x3.dtype).contiguous()
    dev = x3.device
    dzg = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    dzu = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    if E == 0 or M == 0 or N == 0:
        return dzg, dzu
    lib = _build.load("glu", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.glu_pwl_backward(
            x3.data_ptr(), wg.data_ptr(), wu.data_ptr(), g3.data_ptr(),
            *kernel_table(plan, tables), dzg.data_ptr(), dzu.data_ptr(), E, M, N, K,
            _KERNEL_DTYPES[x3.dtype], stream)
    _build.check(err, f"{what} backward")
    return dzg, dzu


def fused_glu_bwd(x, w_gate, w_up, g, plan: EpiloguePlan, tables, counter=None):
    """``(dzg, dzu)`` of the GLU (x (M, K)) or of the per-expert GLU (x
    (E, M, K)): the backward kernel on CUDA tensors, counted on
    ``counter.bwd_launches`` (``fused_glu``'s unless the caller passes its
    own wrapper) unless the problem is empty, its plain version on CPU
    tensors."""
    _build.refuse_dtensor("fused_glu_bwd", x, w_gate, w_up, g)
    if meta.is_meta(x):  # shapes only (meta.py)
        return meta.glu_bwd(x, w_gate, w_up, g)
    if x.device.type == "cpu":
        refuse_unsorted(plan, tables)
        return fused_glu_bwd_plain(x, w_gate, w_up, g, plan, tables)
    counter = counter or fused_glu
    out = _launch_backward(counter.__name__, x, w_gate, w_up, g, plan, tables)
    if out[0].numel():  # an empty problem launches nothing
        counter.bwd_launches += 1
    return out


class _GLUOp(torch.autograd.Function):
    """The fused GLU, dense or per expert, with the JAX package's VJP
    (``glu.py:_glu_op_bwd``, ``moe.py:_moe_glu_op_bwd``); the tables get no
    gradient.  ``counter`` is the public wrapper whose launches it counts."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, plan, tables, impl_bwd, counter):
        if x.device.type == "cpu":
            refuse_unsorted(plan, tables)
            y = fused_glu_plain(x, w_gate, w_up, plan, tables)
        elif meta.is_meta(x):  # shapes only (meta.py)
            y = meta.glu(x, w_gate, w_up)
        else:  # the kernel, or its refusals (another device among them)
            y = _launch_forward(counter.__name__, x, w_gate, w_up, plan, tables)
            if y.numel():  # an empty problem launches nothing
                counter.launches += 1
        ctx.save_for_backward(x, w_gate, w_up)
        ctx.plan, ctx.tables, ctx.impl_bwd, ctx.counter = plan, tables, impl_bwd, counter
        return y

    @staticmethod
    def backward(ctx, g):
        x, wg, wu = ctx.saved_tensors
        plan, tables = ctx.plan, ctx.tables
        if ctx.impl_bwd == "fused":
            dzg, dzu = fused_glu_bwd(x, wg, wu, g, plan, tables, ctx.counter)
        else:
            dzg, dzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
        xf, wgf, wuf = (a.to(torch.float32) for a in (x, wg, wu))
        need_x, need_wg, need_wu = ctx.needs_input_grad[:3]
        dx = (dzg @ wgf.mT + dzu @ wuf.mT).to(x.dtype) if need_x else None
        dwg = (xf.mT @ dzg).to(wg.dtype) if need_wg else None
        dwu = (xf.mT @ dzu).to(wu.dtype) if need_wu else None
        return dx, dwg, dwu, None, None, None, None


def fused_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
              table: PWLTable | None = None, act: str | None = None,
              impl_bwd: str | None = None) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)``.  x: (..., K); w_gate/w_up: (K, N).

    table -> PWL epilogue, act -> exact epilogue, neither -> plain bilinear
    GLU.  On a CUDA tensor every epilogue, and a table of any format, runs
    the hand-written kernels (forward, and backward under
    ``impl_bwd="fused"``).  Differentiable in x, w_gate and w_up."""
    _build.refuse_dtensor("fused_glu", x, w_gate, w_up)
    plan, tables = device_operands(table, act, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _GLUOp.apply(x2, w_gate, w_up, plan, tables, resolve_impl_bwd(impl_bwd), fused_glu)
    return y.reshape(*lead, w_gate.shape[1])


fused_glu.launches = 0
fused_glu.bwd_launches = 0
