"""Fused RMSNorm with an epilogue: ``act(x·rsqrt(mean(x²)+eps)·(1+scale))``
in one pass, and its backward.

Replaces ``repro/kernels/fused/norm.py:_rmsnorm_kernel`` (forward) and
``_rmsnorm_bwd_kernel`` (backward).  The CUDA kernels are in
``csrc/norm.cu``.  Lane l of a row owns the row's columns l, l + 32, ...,
and rows up to 4096 wide (1024 in the backward) live in registers, so x is
read once: a forward row is one warp's up to 768 columns, a wider one split
over 2 or 4 warps in column order; a backward row is one warp's
(:func:`_row_plan`).  A row's sum of squares is reduced in f32 over the
true width D, then ``rsqrt``, the ``(1 + scale)`` gain and the epilogue
(``csrc/epilogue.cuh``: identity, an exact function or the PWL table,
decoded by the breakpoint search from the prefix table
:func:`.epilogue.search_prefix`) come before the one store in x's dtype.
The backward gives a block one 16-row tile; it recomputes ``r``, ``xh`` and
``y``, decodes each element's slope once and writes, in f32, the
closed-form VJP of the JAX module's comment::

    dy = g·act'(y)      du = dy·(1+scale)      dx = r·(du - xh·mean(du·xh))

and one partial of ``ds = Σ dy·xh`` per 16-row tile, summed in row order,
which ``torch.sum`` adds up outside (no atomics: ``ds`` is bitwise the same
from run to run).

What bounds them on an H100: the bytes.  The forward reads x and writes y
once (~3.8 µs at 4096 × 768 bf16); the search is ~14 f32 operations an
element (~0.7 µs there).  The backward reads x and g and writes dx in f32.

No model path calls it, in the JAX package or here (the models compute
RMSNorm in plain ops).  A CPU tensor takes the plain versions below; a CUDA
tensor launches the kernels or raises.  Both refuse a table whose
breakpoints do not ascend, on either device.  ``impl_bwd="recompute"`` keeps
the forward kernel and takes the backward by autograd through the plain
forward.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.pwl import PWLTable

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

DEFAULT_BLOCK_ROWS = 256  # the JAX kernel's row tile (the TPU's; see fused_rmsnorm)

_SIGNATURES = {
    "rmsnorm_tile_rows": [],
    "rmsnorm_forward": [ctypes.c_void_p] * 2 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "rmsnorm_backward": [ctypes.c_void_p] * 3 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The splits csrc/norm.cu builds its row kernels for, (columns a lane, warps),
# in the order the plan prefers them: the fewest warps, then the fewest
# registers (24 a lane: the 768-wide rows of repro-100m and whisper-small,
# which 32 would hold in a third more registers).  A forward row splits over
# up to 4 warps (4096 columns), a backward row is one warp's (1024 columns).
FWD_SPLITS = ((4, 1), (8, 1), (16, 1), (24, 1), (16, 2), (24, 2), (32, 2), (24, 4), (32, 4))
BWD_SPLITS = ((4, 1), (8, 1), (16, 1), (24, 1), (32, 1))


class RowPlan(NamedTuple):
    """How the kernels hold a row of D in registers: over ``warps`` warps,
    part s holding lane l's columns l + 32 (s ``per_lane`` + j), j <
    ``per_lane`` (the forward holds x there, the backward dy); ``(0, 0)`` for
    a row the kernels stream (the forward reads x twice, the backward parks
    dy in dx's buffer)."""

    per_lane: int
    warps: int


def _row_plan(D: int, backward: bool = False) -> RowPlan:
    """The plan the kernels run a row of width D with: the first of
    :data:`FWD_SPLITS` (:data:`BWD_SPLITS`) that holds the row, or streamed.
    Forward: 40 -> (4, 1), 768 -> (24, 1), 2048 -> (32, 2), past 4096
    streamed; backward: 768 -> (24, 1), past 1024 streamed."""
    splits = BWD_SPLITS if backward else FWD_SPLITS
    return next((RowPlan(*sp) for sp in splits if 32 * sp[0] * sp[1] >= D), RowPlan(0, 0))


def fused_rmsnorm_plain(x, scale, plan: EpiloguePlan, tables, eps: float):
    """Plain PyTorch version on (M, D) rows (the JAX package's
    ``_rmsnorm_ref_jnp``): f32 inside, the epilogue, one cast to x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return plan.apply(y, *tables).to(x.dtype)


def fused_rmsnorm_bwd_plain(x, scale, g, plan: EpiloguePlan, tables, eps: float):
    """Plain version of the backward kernel on (M, D) rows, the JAX kernel's
    formula op for op: ``(dx (M, D), ds (D,))``, both f32."""
    xf = x.to(torch.float32)
    d = xf.shape[-1]
    r = torch.rsqrt(xf.square().sum(dim=-1, keepdim=True) / d + eps)
    xh = xf * r
    w = 1.0 + scale.to(torch.float32)
    slope = plan.apply_value_and_slope(xh * w, *tables)[1]
    dy = g.to(torch.float32) * slope
    du = dy * w
    c = (du * xh).sum(dim=-1, keepdim=True) / d
    return r * (du - xh * c), (dy * xh).sum(dim=0)


def _check_operands(x, scale):
    """x (M, D) f32 or bf16 on a CUDA device, scale (D,) there, as the
    kernels read them: contiguous, scale in f32."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the fused_rmsnorm kernel takes float32 or bfloat16, got {x.dtype}")
    if scale.shape != (x.shape[1],) or scale.device != x.device:
        raise ValueError(f"scale must be ({x.shape[1]},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    return x.contiguous(), scale.to(torch.float32).contiguous()


def _launch(x, scale, plan, tables, eps):
    """The forward kernel on (M, D) x.  The caller counts the launch."""
    from repro_torch.kernels import _build

    check_kernel_operands("fused_rmsnorm", plan, tables)
    x, scale = _check_operands(x, scale)
    M, D = x.shape
    out = torch.empty_like(x)
    if M == 0 or D == 0:
        return out
    mq = search_prefix_ptr(plan, tables)
    lib = _build.load("norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_forward(x.data_ptr(), scale.data_ptr(), *kernel_epilogue(plan, tables),
                                  mq, out.data_ptr(), M, D, float(eps), _KERNEL_DTYPES[x.dtype],
                                  *_row_plan(D), stream)
    _build.check(err, "rmsnorm_forward")
    return out


def _launch_bwd(x, scale, g, plan, tables, eps):
    """The backward kernel, then ``torch.sum`` of its ds partials: ``(dx,
    ds)`` f32.  g is read in x's dtype.  The caller counts the launch."""
    from repro_torch.kernels import _build

    check_kernel_operands("fused_rmsnorm backward", plan, tables)
    x, scale = _check_operands(x, scale)
    M, D = x.shape
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} on {x.device}, got {tuple(g.shape)} on "
                         f"{g.device}")
    g = g.to(x.dtype).contiguous()
    dx = torch.empty((M, D), dtype=torch.float32, device=x.device)
    if M == 0 or D == 0:
        return dx, torch.zeros((D,), dtype=torch.float32, device=x.device)
    mq = search_prefix_ptr(plan, tables)
    lib = _build.load("norm", _SIGNATURES)
    tile = lib.rmsnorm_tile_rows()
    ds_part = torch.empty((-(-M // tile), D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_backward(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                                   *kernel_epilogue(plan, tables), mq, dx.data_ptr(),
                                   ds_part.data_ptr(), M, D, float(eps),
                                   _KERNEL_DTYPES[x.dtype], *_row_plan(D, backward=True),
                                   stream)
    _build.check(err, "rmsnorm_backward")
    return dx, ds_part.sum(dim=0)


def fused_rmsnorm_bwd(x, scale, g, plan: EpiloguePlan, tables, eps: float = 1e-6):
    """``(dx, ds)`` of the fused RMSNorm on (M, D) x, f32: the backward
    kernel on CUDA tensors, counted on ``fused_rmsnorm.bwd_launches``, its
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        refuse_unsorted(plan, tables)
        return fused_rmsnorm_bwd_plain(x, scale, g, plan, tables, eps)
    out = _launch_bwd(x, scale, g, plan, tables, eps)
    fused_rmsnorm.bwd_launches += 1
    return out


class _RMSNormOp(torch.autograd.Function):
    """The fused RMSNorm with the JAX package's VJP
    (``norm.py:_rmsnorm_op_bwd``); the tables get no gradient."""

    @staticmethod
    def forward(ctx, x, scale, plan, tables, eps, impl_bwd):
        if x.device.type == "cpu":
            refuse_unsorted(plan, tables)
            y = fused_rmsnorm_plain(x, scale, plan, tables, eps)
        else:  # the kernel, or its refusals (another device among them)
            y = _launch(x, scale, plan, tables, eps)
            fused_rmsnorm.launches += 1
        ctx.save_for_backward(x, scale)
        ctx.plan, ctx.tables, ctx.eps, ctx.impl_bwd = plan, tables, eps, impl_bwd
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        plan, tables, eps = ctx.plan, ctx.tables, ctx.eps
        if ctx.impl_bwd == "fused":
            dx, ds = fused_rmsnorm_bwd(x, scale, g, plan, tables, eps)
            dx, ds = dx.to(x.dtype), ds.to(scale.dtype)
        else:
            with torch.enable_grad():
                xs = [t.detach().requires_grad_(True) for t in (x, scale)]
                dx, ds = torch.autograd.grad(
                    fused_rmsnorm_plain(*xs, plan, tables, eps), xs, g)
        return dx, ds, None, None, None, None


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                  table: PWLTable | None = None, act: str | None = None,
                  block_rows: int = DEFAULT_BLOCK_ROWS,
                  impl_bwd: str | None = None) -> torch.Tensor:
    """RMSNorm, optionally followed by an activation, in one kernel pass.

    x: (..., D); scale: (D,), applied as ``(1 + scale)`` as the models'
    ``rms_norm`` applies it.  table -> PWL epilogue, act -> exact epilogue,
    neither -> identity; on a CUDA tensor each runs the hand-written kernels
    (forward, and backward under ``impl_bwd="fused"``).  ``block_rows`` is
    the JAX signature's TPU row tile: the port's results do not depend on
    it (the CUDA kernels take one to four warps a row, and sum ds in 16-row
    tiles).  Returns x's shape and dtype; differentiable in x and scale."""
    plan, tables = device_operands(table, act, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _RMSNormOp.apply(x2, scale, plan, tables, eps, resolve_impl_bwd(impl_bwd))
    return y.reshape(*lead, x.shape[-1])


fused_rmsnorm.launches = 0
fused_rmsnorm.bwd_launches = 0
