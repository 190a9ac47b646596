"""Public wrappers of the standalone PWL activation kernels (the JAX
package's ``kernels/ops.py``): any shape and dtype goes in, the table is
packed here.

On a CPU tensor each wrapper runs its kernel's plain version; on a CUDA
tensor it launches the kernel (``csrc/pwl_act.cu``) and counts the launch on
``.launches`` (an empty tensor launches nothing and counts nothing), or
raises.  Neither has a backward, as the JAX kernel has no
VJP: an input that requires grad is refused on any device.  The non-uniform
kernel decodes by the breakpoint search, so a table whose breakpoints do
not ascend is refused on any device too.
"""
from __future__ import annotations

import torch

from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import _build

from . import pwl_act
from .fused import meta
from .fused.epilogue import check_ascending, device_operands, pack_for, pack_table


def pack_nonuniform(table: PWLTable, dtype: str | None = None):
    """(bp (n, 1), dmq (n+1, 2)) of :func:`~.fused.epilogue.pack_table`;
    ``dtype`` quantizes the table first ("bf16" | "f16" | "int8")."""
    return pack_table(table, dtype)


def pack_uniform(m, q) -> torch.Tensor:
    """Per-segment (m, q) rows, (n_seg, 2) f32."""
    return torch.stack([torch.as_tensor(m, dtype=torch.float32),
                        torch.as_tensor(q, dtype=torch.float32)], dim=-1)


def _refuse_grad(what: str, x) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{what} has no backward (the JAX kernel has no VJP either): plan the site "
            "impl='fused' or 'jnp' to train through it")


def pwl_activation(x: torch.Tensor, table: PWLTable, *,
                   table_dtype: str | None = None) -> torch.Tensor:
    """Non-uniform PWL activation of ``x`` (any shape), in x's dtype.
    ``table_dtype`` stores the table in another format first ("f32" | "bf16"
    | "f16" | "int8"); a table the store already quantized needs none."""
    _build.refuse_dtensor("pwl_activation", x)
    _refuse_grad("pwl_activation", x)
    if table_dtype is None:
        _, (bp, dmq) = device_operands(table, None, x.device)
    else:
        bp, dmq = pack_for(table, x.device, table_dtype)
    if meta.is_meta(x):  # shapes only (fused/meta.py)
        return meta.pwl(x)
    if x.device.type == "cpu":
        check_ascending(bp)  # as the kernel refuses them
        return pwl_act.pwl_nonuniform_plain(x, bp, dmq)
    y = pwl_act.launch_nonuniform(x, bp, dmq)
    if y.numel():  # an empty tensor launches nothing
        pwl_activation.launches += 1
    return y


def pwl_activation_uniform(x: torch.Tensor, m, q, lo: float, hi: float) -> torch.Tensor:
    """Uniform-address PWL baseline of ``x`` (any shape), in x's dtype: m and
    q hold n_seg = n_inner + 2 segments, the inner ones of width
    ``(hi - lo) / n_inner``."""
    _build.refuse_dtensor("pwl_activation_uniform", x)
    _refuse_grad("pwl_activation_uniform", x)
    mq = pack_uniform(m, q)
    if meta.is_meta(x):  # shapes only (fused/meta.py)
        return meta.pwl(x)
    if x.device.type == "cpu":
        return pwl_act.pwl_uniform_plain(x, mq, lo, hi)
    y = pwl_act.launch_uniform(x, mq, lo, hi)
    if y.numel():  # an empty tensor launches nothing
        pwl_activation_uniform.launches += 1
    return y


pwl_activation.launches = 0
pwl_activation_uniform.launches = 0
