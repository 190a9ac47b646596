"""Fused PWL-exp softmax over the last axis (paper Sec. V-B).

Replaces ``repro/kernels/fused/softmax.py:_softmax_kernel`` (forward) and
``_softmax_bwd_kernel`` (backward).  The
score rows are masked, shifted by their max, put through the non-uniform PWL
exp, clamped at 0, masked again and renormalised in one pass over a resident
row, instead of three elementwise passes.  Masked scores are filled with
``-1e30`` before the max, shifted scores are clamped at ``-1e4`` so the
table's linear left tail cannot overflow, and the row sum is clamped at
``1e-30``, so a row with no valid entry gives zeros.

The CUDA kernel is ``csrc/softmax.cu``.  What bounds it on an H100: bytes
at the least.  It reads x where the mask keeps a score and writes every
output, at most 8 bytes per score (12 with a mask; about 6 under a causal
mask).  A table is decoded by the breakpoint search of
``csrc/pwl_decode.cuh`` (about 6 shared loads for a warp's 32 scores, from
the prefix table :func:`.epilogue.search_prefix`); with the IEEE division
by the row sum a kept score still costs ~50 instructions, and that issue,
not bandwidth, holds the measured kernel at ~1.7x the bytes' time.  A
masked score is neither read nor decoded.  Rows up to
1024 wide take a warp each and live in registers, summed in the order of the
shared-memory design before it (lane l owns columns l, l + 32, ...), so
their outputs keep its bits.  Wider rows split over a thread-block cluster
of up to 8 blocks (:func:`_split_plan`), each holding its slice in
registers; the blocks exchange their partial max and sum through
distributed shared memory.

The backward (same source) recomputes a row's forward and applies the
softmax VJP in the same pass.  It reads x and g where the mask keeps a score,
once each, and writes dx in full (about 8 bytes per causal score), with one
search decode of value and slope per kept score, so it is bound by bytes as
well.  The row max is differentiated,
as in the JAX package: for a PWL exp the shift term does not cancel, and its
gradient is split equally across argmax ties.

A CPU tensor takes the plain versions below; a CUDA tensor launches the
kernels or raises.  ``impl_bwd="recompute"`` keeps the forward kernel and
takes the backward by autograd through the plain forward, whose clamps are
``torch.maximum`` (gradient 0.5 at a tie, as jnp's) and whose row max is
``amax`` (split across ties).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.functions import tie_max
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

NEG_FILL = -1e30     # masked-score fill, as the JAX package's
SHIFT_CLAMP = -1e4   # lower clamp on the shifted scores
MAX_WIDTH = 32768    # widest row the kernel takes

_SIGNATURES = {
    "pwl_softmax_forward": [ctypes.c_void_p] * 2 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "pwl_softmax_backward": [ctypes.c_void_p] * 3 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}

# The kernels' split of a row (csrc/softmax.cu, which checks the same rule)
SMS = 132                 # streaming multiprocessors of an H100 SXM
THREADS = 256             # threads a block
NARROW_WIDTH = 1024       # rows up to this wide take one warp each
MAX_CLUSTER = 8           # blocks a wide row splits over, at most (the portable cluster size)
NARROW_PER_LANE = 32      # a narrow row's columns a lane holds, at most
WIDE_PER_THREAD = 16      # a wide row's columns a thread holds, at most
SLICE_ALIGN = 32          # a block's slice of a wide row starts on a warp's columns


class SplitPlan(NamedTuple):
    """How the kernels lay one row over threads: ``cluster`` blocks a row
    (1 for a narrow row, which a warp holds), each owning ``slice``
    consecutive columns, and ``per_thread``, the register bucket (a power of
    two) of columns a thread holds: ``ceil(N / 32)`` a lane for a narrow
    row, ``ceil(slice / THREADS)`` for a wide one."""

    cluster: int
    slice: int
    per_thread: int


def _bucket(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _split_plan(R: int, N: int) -> SplitPlan:
    """The split the kernels run (R, N) rows with.  A narrow row is one
    warp's.  A wide row takes the fewest blocks that hold it at
    :data:`WIDE_PER_THREAD` columns a thread, then twice as many while the
    rows' blocks do not fill the SMs (R · cluster < :data:`SMS`), the
    cluster stays within :data:`MAX_CLUSTER` and each block keeps at least
    a column a thread: 48 rows of 32768 or of 1500 split, 24,576 rows of
    2048 do not."""
    if N <= NARROW_WIDTH:
        return SplitPlan(1, N, _bucket(-(-N // 32)))
    cs = 1
    while -(-N // cs) > THREADS * WIDE_PER_THREAD:
        cs *= 2
    while cs < MAX_CLUSTER and R * cs < SMS and N // (2 * cs) >= THREADS:
        cs *= 2
    width = -(-(-(-N // cs)) // SLICE_ALIGN) * SLICE_ALIGN
    return SplitPlan(cs, width, _bucket(-(-width // THREADS)))


def static_mask(R: int, N: int, seq_len: int, causal: bool, window, device=None):
    """The (R, N) {0, 1} f32 mask that causal/window synthesize: rows
    flatten (..., seq_len), so row r is query position ``r % seq_len``."""
    qpos = torch.arange(R, device=device) % seq_len
    col = torch.arange(N, device=device)
    keep = torch.ones((R, N), dtype=torch.bool, device=device)
    if causal:
        keep &= col[None, :] <= qpos[:, None]
    if window is not None:
        keep &= (qpos[:, None] - col[None, :]) < window
    return keep.to(torch.float32)


def pwl_exp(x, plan: EpiloguePlan, tables):
    """The exp of the softmax chains: the epilogue on ``x`` clamped at
    ``-1e4``, clamped at 0 after the decode."""
    return tie_max(plan.apply(tie_max(x, SHIFT_CLAMP), *tables), 0.0)


def fused_pwl_softmax_plain(x2, mask2, plan: EpiloguePlan, tables):
    """Plain PyTorch version on (R, N) rows, in f32: the math of the JAX
    package's ``pwl_softmax_reference``; ``mask2`` is a {0, 1} f32 mask or
    None (no masking)."""
    xf = x2.to(torch.float32)
    xm = xf if mask2 is None else torch.where(mask2 > 0, xf, NEG_FILL)
    p = pwl_exp(xm - xm.amax(dim=-1, keepdim=True), plan, tables)
    if mask2 is not None:
        p = p * mask2
    l = p.sum(dim=-1, keepdim=True)
    return p / tie_max(l, 1e-30)


def fused_pwl_softmax_bwd_plain(x2, mask2, g2, plan: EpiloguePlan, tables):
    """Plain version of the backward kernel on (R, N) rows, in f32: the
    JAX package's VJP formula op for op (``softmax.py:_softmax_bwd_kernel``).
    With u = max(pwl(t), 0)·mask, t = xm - rowmax, L = max(Σu, 1e-30):

        du = g/L - gl·Σ(g·u)/L²
        dt = du·mask·gate_p·slope·gate_t
        dx = (dt + dm·eq/ntie)·mask,   dm = -Σdt

    where each gate is 1 above its clamp's threshold, 0.5 at it and 0 below
    (jnp's convention) and eq marks the argmax ties.  ``mask2`` is a {0, 1}
    f32 mask or None."""
    xf = x2.to(torch.float32)
    mask = torch.ones_like(xf) if mask2 is None else mask2
    xm = torch.where(mask > 0, xf, NEG_FILL)
    m = xm.amax(dim=-1, keepdim=True)
    t = xm - m
    s = tie_max(t, SHIFT_CLAMP)
    p_raw, slope = plan.apply_value_and_slope(s, *tables)
    u = tie_max(p_raw, 0.0) * mask
    l = u.sum(dim=-1, keepdim=True)
    L = tie_max(l, 1e-30)
    gf = g2.to(torch.float32)
    gl = (l > 1e-30).to(torch.float32) + 0.5 * (l == 1e-30).to(torch.float32)
    du = gf / L - gl * (gf * u).sum(dim=-1, keepdim=True) / (L * L)
    gate_p = (p_raw > 0.0).to(torch.float32) + 0.5 * (p_raw == 0.0).to(torch.float32)
    gate_t = ((t > SHIFT_CLAMP).to(torch.float32)
              + 0.5 * (t == SHIFT_CLAMP).to(torch.float32))
    dt = du * mask * gate_p * slope * gate_t
    dm = -dt.sum(dim=-1, keepdim=True)
    eq = (xm == m).to(torch.float32)
    ntie = eq.sum(dim=-1, keepdim=True)
    return (dt + dm * eq / ntie) * mask


def _check_rows(x2, mask2):
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"fused_pwl_softmax runs on cpu or cuda tensors, got {dev}")
    N = x2.shape[1]
    if N > MAX_WIDTH:
        raise ValueError(f"fused_pwl_softmax kernel takes rows up to {MAX_WIDTH} wide, "
                         f"got {N}; wider rows take fused_flash_attention")
    return x2.contiguous(), None if mask2 is None else mask2.contiguous()


def _launch(x2, mask2, plan, tables, seq_len, causal, window):
    from repro_torch.kernels import _build

    check_kernel_operands("softmax", plan, tables)
    x2, mask2 = _check_rows(x2, mask2)
    R, N = x2.shape
    dev = x2.device
    out = torch.empty((R, N), dtype=torch.float32, device=dev)
    if R == 0 or N == 0:
        return out
    mq = search_prefix_ptr(plan, tables)
    lib = _build.load("softmax", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pwl_softmax_forward(
            x2.data_ptr(), None if mask2 is None else mask2.data_ptr(),
            *kernel_epilogue(plan, tables), mq, out.data_ptr(), R, N, seq_len, int(causal),
            int(window is not None), 0 if window is None else int(window),
            _split_plan(R, N).cluster, stream)
    _build.check(err, "pwl_softmax_forward")
    fused_pwl_softmax.launches += 1
    return out


def _launch_bwd(x2, mask2, g2, plan, tables, seq_len, causal, window):
    from repro_torch.kernels import _build

    check_kernel_operands("softmax backward", plan, tables)
    x2, mask2 = _check_rows(x2, mask2)
    R, N = x2.shape
    dev = x2.device
    if g2.shape != (R, N) or g2.device != dev:
        raise ValueError(f"g must be ({R}, {N}) on {dev}, got {tuple(g2.shape)} on "
                         f"{g2.device}")
    g2 = g2.to(torch.float32).contiguous()
    dx = torch.empty((R, N), dtype=torch.float32, device=dev)
    if R == 0 or N == 0:
        return dx
    mq = search_prefix_ptr(plan, tables)
    lib = _build.load("softmax", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pwl_softmax_backward(
            x2.data_ptr(), None if mask2 is None else mask2.data_ptr(), g2.data_ptr(),
            *kernel_epilogue(plan, tables), mq, dx.data_ptr(), R, N, seq_len,
            int(causal), int(window is not None), 0 if window is None else int(window),
            _split_plan(R, N).cluster, stream)
    _build.check(err, "pwl_softmax_backward")
    fused_pwl_softmax.bwd_launches += 1
    return dx


def _plain_mask(x2, mask2, seq_len, causal, window):
    """The mask the plain versions take: ``mask2``, or the static one that
    causal/window synthesize in the kernels."""
    if mask2 is None and (causal or window is not None):
        return static_mask(x2.shape[0], x2.shape[1], seq_len, causal, window,
                           device=x2.device)
    return mask2


def fused_pwl_softmax_bwd(x2, mask2, g2, plan: EpiloguePlan, tables, seq_len: int = 1,
                          causal: bool = False, window: int | None = None):
    """dx of the fused PWL softmax on (R, N) f32 rows: the backward kernel
    on CUDA tensors, its plain version on CPU tensors.  ``mask2`` /
    ``causal`` / ``window`` / ``seq_len`` as the forward took them."""
    if x2.device.type == "cpu":
        refuse_unsorted(plan, tables)
        return fused_pwl_softmax_bwd_plain(
            x2, _plain_mask(x2, mask2, seq_len, causal, window), g2, plan, tables)
    return _launch_bwd(x2, mask2, g2, plan, tables, seq_len, causal, window)


class _SoftmaxOp(torch.autograd.Function):
    """The fused PWL softmax on (R, N) f32 rows with the JAX package's VJP
    (``softmax.py:_softmax_op_bwd``)."""

    @staticmethod
    def forward(ctx, x2, mask2, plan, tables, seq_len, causal, window, impl_bwd):
        if x2.device.type == "cpu":
            refuse_unsorted(plan, tables)
            y = fused_pwl_softmax_plain(
                x2, _plain_mask(x2, mask2, seq_len, causal, window), plan, tables)
        else:
            y = _launch(x2, mask2, plan, tables, seq_len, causal, window)
        ctx.save_for_backward(x2, mask2)
        ctx.args = (plan, tables, seq_len, causal, window, impl_bwd)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, mask2 = ctx.saved_tensors
        plan, tables, seq_len, causal, window, impl_bwd = ctx.args
        if impl_bwd == "fused":
            dx = fused_pwl_softmax_bwd(x2, mask2, g, plan, tables, seq_len, causal, window)
        else:
            m = _plain_mask(x2, mask2, seq_len, causal, window)
            with torch.enable_grad():
                xr = x2.detach().requires_grad_(True)
                (dx,) = torch.autograd.grad(
                    fused_pwl_softmax_plain(xr, m, plan, tables), xr, g)
        return dx, None, None, None, None, None, None, None


def fused_pwl_softmax(x: torch.Tensor, *, table: PWLTable | None = None,
                      act: str | None = None, mask: torch.Tensor | None = None,
                      causal: bool = False, window: int | None = None,
                      impl_bwd: str | None = None) -> torch.Tensor:
    """Softmax over the last axis with a PWL-approximated exponential.

    x: (..., N) scores.  ``table`` is the exp table of the
    ``attn.softmax:exp`` site; ``act="exp"`` (the default when neither is
    given) runs the exact exponential in the same reduction, on the card too.
    ``mask`` (broadcastable to x, nonzero = keep) is dynamic validity;
    ``causal``/``window`` are position-static masks made from the query
    position (second-to-last axis) and the key position (last axis), and
    exclude ``mask``.  Returns x's shape and dtype.  Differentiable in x;
    ``impl_bwd`` picks the backward (:mod:`.backward`)."""
    if table is None and act is None:
        act = "exp"
    if mask is not None and (causal or window is not None):
        raise ValueError("pass either mask= (dynamic) or causal=/window= "
                         "(static, synthesized in-kernel), not both")
    plan, tables = device_operands(table, act, x.device)
    lead, N = x.shape[:-1], x.shape[-1]
    seq_len = x.shape[-2] if (causal or window is not None) else 1
    x2 = x.reshape(-1, N).to(torch.float32)
    mask2 = None
    if mask is not None:
        # a {0, 1} indicator: a raw float mask selects, it does not weight;
        # formed before the broadcast, so one pass writes the (R, N) mask
        mask2 = torch.broadcast_to((mask != 0).to(torch.float32), x.shape).reshape(-1, N)
    y = _SoftmaxOp.apply(x2, mask2, plan, tables, seq_len, causal, window,
                         resolve_impl_bwd(impl_bwd))
    return y.reshape(*lead, N).to(x.dtype)


fused_pwl_softmax.launches = 0
fused_pwl_softmax.bwd_launches = 0
