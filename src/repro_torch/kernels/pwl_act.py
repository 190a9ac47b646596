"""The standalone PWL activation: plain versions and CUDA launchers of the
non-uniform kernel (the plan's ``impl="kernel"``) and of the uniform
baseline.

Replaces ``repro/kernels/pwl_act.py:_pwl_nonuniform_kernel`` and
``_pwl_uniform_kernel``.  The CUDA kernels are in ``csrc/pwl_act.cu``: one
elementwise pass over the flat tensor (no 8x128 tiles, no padding) in
16-byte vectors, with the table in shared memory.  The non-uniform kernel
finds each element's segment by the breakpoint search from the host-built
prefix table (:func:`.fused.epilogue.prefix_for`), so its breakpoints must
ascend (refused otherwise, on the CPU too); the uniform kernel builds every
segment's (m, q) once a block by the delta accumulation below.  Each
element's value is ``m·x + q`` with the product and the sum rounded apart,
as the plain versions below compute it, so each kernel is bitwise its plain
version.  What bounds them on an H100: each element is read and written
once (15.0 us at 4096 x 3072 bf16), against ~9 operations an element for
the search.  A table past 64 breakpoints (65 segments, uniform) takes the
kernels' wide instantiation (:func:`.fused.epilogue.is_wide`): the search
reads the padded breakpoints from device memory, and the uniform kernel
fetches each element's segment from a table that one small kernel
accumulates first on the card, by the same delta loop, with the same bits.

The public wrappers, which take the plain version for a CPU tensor and
launch for a CUDA one, are :func:`repro_torch.kernels.ops.pwl_activation`
and :func:`~repro_torch.kernels.ops.pwl_activation_uniform`; they count the
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused.epilogue import is_wide, prefix_for, pwl_value_and_slope

_SIGNATURES = {
    # x, the breakpoints, the search's operand, n_bp, wide
    "pwl_nonuniform_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_void_p, ctypes.c_longlong,
                                                       ctypes.c_int, ctypes.c_void_p],
    # x, the segments' (m, q), n_seg, wide, the wide kernel's segment scratch, lo, inv_h
    "pwl_uniform_forward": [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                                    ctypes.c_float, ctypes.c_float,
                                                    ctypes.c_void_p, ctypes.c_longlong,
                                                    ctypes.c_int, ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def uniform_constants(lo: float, hi: float, n_seg: int) -> tuple[float, float]:
    """``(lo, inv_h)`` of the uniform decode as the kernel's f32 constants:
    ``inv_h = n_inner / (hi - lo)`` in f64, then both rounded to f32, as the
    JAX kernel bakes its Python floats in."""
    n_inner = n_seg - 2
    return float(np.float32(lo)), float(np.float32(n_inner / (hi - lo)))


def pwl_nonuniform_plain(x, bp, dmq):
    """Plain version of the non-uniform kernel: the delta decode of
    :func:`~repro_torch.kernels.fused.epilogue.pwl_value_and_slope` (either
    operand layout), then ``m·x + q`` in f32, cast to x's dtype."""
    return pwl_value_and_slope(x, bp, dmq, int(bp.shape[0]))[0].to(x.dtype)


def _int32_index(t):
    """``int32(t) + 1`` as XLA computes it on the CPU: the conversion
    saturates (NaN to 0) and the +1 wraps, so t >= 2^31 gives -2^31 (int64
    holding int32 values)."""
    ti = torch.nan_to_num(t.to(torch.float64), nan=0.0).clamp(-2.0**31, 2.0**31 - 1)
    ti = ti.to(torch.int64) + 1
    return torch.where(ti > 2**31 - 1, ti - 2**32, ti)


def pwl_uniform_plain(x, mq, lo: float, hi: float):
    """Plain version of the uniform kernel: ``idx = clip(int32(floor((x -
    lo)·inv_h)) + 1, 0, n_seg - 1)``, the int32 step as JAX's
    (:func:`_int32_index`: past 2^31 segment widths the index wraps to
    segment 0, NaN lands in segment 1), the segment's (m, q) by delta
    accumulation over the ``n_seg - 1`` segment edges (the deltas formed in
    f32 in that order), then ``m·x + q``, cast to x's dtype.  ``mq``:
    (n_seg, 2) f32."""
    xf = x.to(torch.float32)
    mq = mq.to(device=xf.device, dtype=torch.float32)
    n_seg = int(mq.shape[0])
    # filled on x's device (no host copy, so a CUDA graph can capture it)
    lo32, inv_h32 = (torch.full((), c, dtype=torch.float32, device=xf.device)
                     for c in uniform_constants(lo, hi, n_seg))
    idx = torch.clamp(_int32_index(torch.floor((xf - lo32) * inv_h32)), 0, n_seg - 1)
    m, q = uniform_segment_mq(mq, idx)
    return (m * xf + q).to(x.dtype)


def uniform_segment_mq(mq, idx):
    """The (m, q) of segment ``idx`` (an int tensor) by the delta
    accumulation of the TPU kernel: from (m_0, q_0), add ``(idx > i)·(m_{i+1}
    - m_i, q_{i+1} - q_i)`` for i = 0..n_seg-2 in that order, each delta and
    each add in f32."""
    n_seg = int(mq.shape[0])
    m = mq[0, 0].expand(idx.shape).clone()
    q = mq[0, 1].expand(idx.shape).clone()
    for i in range(n_seg - 1):
        c = (idx > i).to(torch.float32)
        m = m + c * (mq[i + 1, 0] - mq[i, 0])
        q = q + c * (mq[i + 1, 1] - mq[i, 1])
    return m, q


def _flat(what: str, x):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the {what} kernel takes float32, bfloat16 or float16, got {x.dtype}")
    return x.contiguous()


def _out_like(xc):
    """An output for ``xc`` at the same address modulo 16 bytes, so that the
    kernel's 16-byte vectors of x and of the output line up (a view of x
    that starts past an element of its storage starts off the boundary)."""
    skip = (xc.data_ptr() % 16) // xc.element_size()
    buf = torch.empty(xc.numel() + skip, dtype=xc.dtype, device=xc.device)
    return buf[skip:].view(xc.shape)


def launch_nonuniform(x, bp, dmq):
    """The non-uniform kernel on a CUDA tensor of any shape, with f32 delta
    operands on its device: it reads the breakpoints and their prefix table
    (:func:`~.fused.epilogue.prefix_for`, built once per operand tensor,
    which refuses breakpoints that do not ascend before any build).  The
    caller counts the launch."""
    from repro_torch.kernels import _build

    xc = _flat("pwl_activation", x)
    if bp.dtype != torch.float32 or dmq.dtype != torch.float32:
        raise TypeError("the pwl_activation kernel reads f32 delta-layout table operands")
    mq = prefix_for(bp, dmq)
    out = _out_like(xc)
    if xc.numel() == 0:
        return out
    lib = _build.load("pwl_act", _SIGNATURES)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        n_bp = int(bp.shape[0])
        err = lib.pwl_nonuniform_forward(xc.data_ptr(), bp.data_ptr(), mq.data_ptr(), n_bp,
                                         int(is_wide(n_bp)), out.data_ptr(), xc.numel(),
                                         _KERNEL_DTYPES[xc.dtype], stream)
    _build.check(err, "pwl_activation")
    return out


def launch_uniform(x, mq, lo: float, hi: float):
    """The uniform kernel on a CUDA tensor of any shape, with ``mq`` (n_seg,
    2) f32 on its device; past 64 breakpoints (:func:`.fused.epilogue.is_wide`)
    the wide kernel first accumulates every segment into a scratch table on
    the card.  The caller counts the launch."""
    from repro_torch.kernels import _build

    xc = _flat("pwl_activation_uniform", x)
    mq = mq.to(device=xc.device, dtype=torch.float32).contiguous()
    out = _out_like(xc)
    if xc.numel() == 0:
        return out
    n_seg = int(mq.shape[0])
    lo32, inv_h32 = uniform_constants(lo, hi, n_seg)
    wide = is_wide(n_seg - 1)
    seg = torch.empty((n_seg, 2), dtype=torch.float32, device=xc.device) if wide else None
    lib = _build.load("pwl_act", _SIGNATURES)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.pwl_uniform_forward(xc.data_ptr(), mq.data_ptr(), n_seg, int(wide),
                                      None if seg is None else seg.data_ptr(), lo32, inv_h32,
                                      out.data_ptr(), xc.numel(), _KERNEL_DTYPES[xc.dtype],
                                      stream)
    _build.check(err, "pwl_activation_uniform")
    return out
