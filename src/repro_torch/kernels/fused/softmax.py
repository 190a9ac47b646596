"""Fused PWL-exp softmax over the last axis (paper Sec. V-B).

Replaces ``repro/kernels/fused/softmax.py:_softmax_kernel`` (forward) and
``_softmax_bwd_kernel`` (backward).  The
score rows are masked, shifted by their max, put through the non-uniform PWL
exp, clamped at 0, masked again and renormalised in one pass over a resident
row, instead of three elementwise passes.  Masked scores are filled with
``-1e30`` before the max, shifted scores are clamped at ``-1e4`` so the
table's linear left tail cannot overflow, and the row sum is clamped at
``1e-30``, so a row with no valid entry gives zeros.

The CUDA kernel is ``csrc/softmax.cu``.  What bounds it on an H100: it reads
x where the mask keeps a score and writes every output, at most 8 bytes per
score (12 with a mask; 6 under a causal mask), but decodes each score through about
3·n_bp f32 operations (the delta-accumulation decode of
``csrc/pwl_decode.cuh``, 96 at 32 breakpoints), so it is bound by CUDA-core
operations.  A row stays in shared memory (128 KB of f32 at the 32768-wide
limit :data:`MAX_WIDTH` that the model dispatch keeps), so each score is read
once, decoded once and written once; narrow rows take a warp each.

The backward (same source) recomputes a row's forward and applies the
softmax VJP in the same pass.  The VJP needs x and g where the mask keeps a
score and writes dx in full: 8 bytes per score under a causal mask, 12
without one (the kernel reads all of g, 10 bytes per causal score), against
one decode of value and slope, so at the training rows (8·12·512 rows of
512) it is bound by bytes.  The row max is differentiated,
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
)

NEG_FILL = -1e30     # masked-score fill, as the JAX package's
SHIFT_CLAMP = -1e4   # lower clamp on the shifted scores
MAX_WIDTH = 32768    # widest row the kernel holds in shared memory

_SIGNATURES = {
    "pwl_softmax_forward": [ctypes.c_void_p] * 2 + EPILOGUE_ARGTYPES + [ctypes.c_void_p]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "pwl_softmax_backward": [ctypes.c_void_p] * 3 + EPILOGUE_ARGTYPES + [ctypes.c_void_p]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}


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
    lib = _build.load("softmax", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pwl_softmax_forward(
            x2.data_ptr(), None if mask2 is None else mask2.data_ptr(),
            *kernel_epilogue(plan, tables), out.data_ptr(), R, N, seq_len, int(causal),
            int(window is not None), 0 if window is None else int(window), stream)
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
    lib = _build.load("softmax", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pwl_softmax_backward(
            x2.data_ptr(), None if mask2 is None else mask2.data_ptr(), g2.data_ptr(),
            *kernel_epilogue(plan, tables), dx.data_ptr(), R, N, seq_len,
            int(causal), int(window is not None), 0 if window is None else int(window),
            stream)
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
        return fused_pwl_softmax_bwd_plain(
            x2, _plain_mask(x2, mask2, seq_len, causal, window), g2, plan, tables)
    return _launch_bwd(x2, mask2, g2, plan, tables, seq_len, causal, window)


class _SoftmaxOp(torch.autograd.Function):
    """The fused PWL softmax on (R, N) f32 rows with the JAX package's VJP
    (``softmax.py:_softmax_op_bwd``)."""

    @staticmethod
    def forward(ctx, x2, mask2, plan, tables, seq_len, causal, window, impl_bwd):
        if x2.device.type == "cpu":
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
        # a {0, 1} indicator: a raw float mask selects, it does not weight
        mask2 = (torch.broadcast_to(mask, x.shape).reshape(-1, N) != 0).to(torch.float32)
    y = _SoftmaxOp.apply(x2, mask2, plan, tables, seq_len, causal, window,
                         resolve_impl_bwd(impl_bwd))
    return y.reshape(*lead, N).to(x.dtype)


fused_pwl_softmax.launches = 0
fused_pwl_softmax.bwd_launches = 0
