"""The standalone PWL activation: plain versions and CUDA launchers of the
non-uniform kernel (the plan's ``impl="kernel"``) and of the uniform
baseline.

Replaces ``repro/kernels/pwl_act.py:_pwl_nonuniform_kernel`` and
``_pwl_uniform_kernel``.  The CUDA kernels are in ``csrc/pwl_act.cu``: one
elementwise pass over the flat tensor (no 8x128 tiles, no padding) with the
table in shared memory.  Each element's value is ``m·x + q`` with the
product and the sum rounded apart, as the plain versions below compute it,
so each kernel is bitwise its plain version.  What bounds them on an H100:
each element is read and written once, against ~3 f32 operations per
breakpoint for the decode, the larger term at 32 breakpoints.

The public wrappers, which take the plain version for a CPU tensor and
launch for a CUDA one, are :func:`repro_torch.kernels.ops.pwl_activation`
and :func:`~repro_torch.kernels.ops.pwl_activation_uniform`; they count the
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused.epilogue import pwl_value_and_slope

_SIGNATURES = {
    "pwl_nonuniform_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                                       ctypes.c_longlong, ctypes.c_int,
                                                       ctypes.c_void_p],
    "pwl_uniform_forward": [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float,
                                                    ctypes.c_float, ctypes.c_void_p,
                                                    ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_void_p],
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
    m = mq[0, 0].expand(xf.shape).clone()
    q = mq[0, 1].expand(xf.shape).clone()
    for i in range(n_seg - 1):
        c = (idx > i).to(torch.float32)
        m = m + c * (mq[i + 1, 0] - mq[i, 0])
        q = q + c * (mq[i + 1, 1] - mq[i, 1])
    return (m * xf + q).to(x.dtype)


def _flat(what: str, x):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the {what} kernel takes float32, bfloat16 or float16, got {x.dtype}")
    return x.contiguous()


def launch_nonuniform(x, bp, dmq):
    """The non-uniform kernel on a CUDA tensor of any shape, with f32 delta
    operands on its device.  The caller counts the launch."""
    from repro_torch.kernels import _build

    xc = _flat("pwl_activation", x)
    if bp.dtype != torch.float32 or dmq.dtype != torch.float32:
        raise TypeError("the pwl_activation kernel reads f32 delta-layout table operands")
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    lib = _build.load("pwl_act", _SIGNATURES)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.pwl_nonuniform_forward(xc.data_ptr(), bp.data_ptr(), dmq.data_ptr(),
                                         int(bp.shape[0]), out.data_ptr(), xc.numel(),
                                         _KERNEL_DTYPES[xc.dtype], stream)
    _build.check(err, "pwl_activation")
    return out


def launch_uniform(x, mq, lo: float, hi: float):
    """The uniform kernel on a CUDA tensor of any shape, with ``mq`` (n_seg,
    2) f32 on its device.  The caller counts the launch."""
    from repro_torch.kernels import _build

    xc = _flat("pwl_activation_uniform", x)
    mq = mq.to(device=xc.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    n_seg = int(mq.shape[0])
    lo32, inv_h32 = uniform_constants(lo, hi, n_seg)
    lib = _build.load("pwl_act", _SIGNATURES)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.pwl_uniform_forward(xc.data_ptr(), mq.data_ptr(), n_seg, lo32, inv_h32,
                                      out.data_ptr(), xc.numel(), _KERNEL_DTYPES[xc.dtype],
                                      stream)
    _build.check(err, "pwl_activation_uniform")
    return out
