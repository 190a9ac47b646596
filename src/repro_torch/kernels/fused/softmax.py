"""Fused PWL-exp softmax over the last axis (paper Sec. V-B).

Replaces ``repro/kernels/fused/softmax.py:_softmax_kernel`` (forward).  The
score rows are masked, shifted by their max, put through the non-uniform PWL
exp, clamped at 0, masked again and renormalised in one pass over a resident
row, instead of three elementwise passes.  Masked scores are filled with
``-1e30`` before the max, shifted scores are clamped at ``-1e4`` so the
table's linear left tail cannot overflow, and the row sum is clamped at
``1e-30``, so a row with no valid entry gives zeros.

The CUDA kernel is ``csrc/softmax.cu``.  What bounds it on an H100: it moves
8 bytes per score (12 with a mask) but decodes each score through about
3·n_bp f32 operations (the delta-accumulation decode of
``csrc/pwl_decode.cuh``, 96 at 32 breakpoints), so it is bound by CUDA-core
operations.  A row stays in shared memory (128 KB of f32 at the 32768-wide
limit :data:`MAX_WIDTH` that the model dispatch keeps), so each score is read
once, decoded once and written once; narrow rows take a warp each.

A CPU tensor takes the plain version below; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pwl import PWLTable

from .epilogue import EpiloguePlan, check_kernel_operands, device_operands

NEG_FILL = -1e30     # masked-score fill, as the JAX package's
SHIFT_CLAMP = -1e4   # lower clamp on the shifted scores
MAX_WIDTH = 32768    # widest row the kernel holds in shared memory

_SIGNATURES = {
    "pwl_softmax_forward": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
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
    return torch.clamp(plan.apply(torch.clamp(x, min=SHIFT_CLAMP), *tables), min=0.0)


def fused_pwl_softmax_plain(x2, mask2, plan: EpiloguePlan, tables):
    """Plain PyTorch version on (R, N) rows, in f32: the math of the JAX
    package's ``pwl_softmax_reference``; ``mask2`` is a {0, 1} f32 mask or
    None (no masking)."""
    xf = x2.to(torch.float32)
    xm = xf if mask2 is None else torch.where(mask2 > 0, xf, NEG_FILL)
    p = pwl_exp(xm - xm.amax(dim=-1, keepdim=True), plan, tables)
    if mask2 is not None:
        p = p * mask2
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def _launch(x2, mask2, plan, tables, seq_len, causal, window):
    from repro_torch.kernels import _build

    check_kernel_operands("softmax", plan, tables, x2)
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"fused_pwl_softmax runs on cpu or cuda tensors, got {dev}")
    R, N = x2.shape
    if N > MAX_WIDTH:
        raise ValueError(f"fused_pwl_softmax kernel takes rows up to {MAX_WIDTH} wide, "
                         f"got {N}; wider rows take fused_flash_attention")
    x2 = x2.contiguous()
    if mask2 is not None:
        mask2 = mask2.contiguous()
    out = torch.empty((R, N), dtype=torch.float32, device=dev)
    if R == 0 or N == 0:
        return out
    bp, dmq = tables
    lib = _build.load("softmax", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pwl_softmax_forward(
            x2.data_ptr(), None if mask2 is None else mask2.data_ptr(), bp.data_ptr(),
            dmq.data_ptr(), plan.n_bp, out.data_ptr(), R, N, seq_len, int(causal),
            int(window is not None), 0 if window is None else int(window), stream)
    _build.check(err, "pwl_softmax_forward")
    fused_pwl_softmax.launches += 1
    return out


def fused_pwl_softmax(x: torch.Tensor, *, table: PWLTable | None = None,
                      act: str | None = None, mask: torch.Tensor | None = None,
                      causal: bool = False, window: int | None = None) -> torch.Tensor:
    """Softmax over the last axis with a PWL-approximated exponential.

    x: (..., N) scores.  ``table`` is the exp table of the
    ``attn.softmax:exp`` site; ``act="exp"`` (the default when neither is
    given) runs the exact exponential in the same reduction (CPU only).
    ``mask`` (broadcastable to x, nonzero = keep) is dynamic validity;
    ``causal``/``window`` are position-static masks made from the query
    position (second-to-last axis) and the key position (last axis), and
    exclude ``mask``.  Returns x's shape and dtype."""
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
    if x.device.type == "cpu":
        if mask2 is None and (causal or window is not None):
            mask2 = static_mask(x2.shape[0], N, seq_len, causal, window)
        y = fused_pwl_softmax_plain(x2, mask2, plan, tables)
    else:
        y = _launch(x2, mask2, plan, tables, seq_len, causal, window)
    return y.reshape(*lead, N).to(x.dtype)


fused_pwl_softmax.launches = 0
