"""PWL epilogues: table packing and the plain value-and-slope decode.

The paper puts activation evaluation inside the datapath that produced the
pre-activation.  On the card that means the kernel epilogue: the PWL decode
runs on the accumulator in registers before the one store.  This module is
the host half: :func:`pack_table` lays a table out as the operands a kernel
reads, :class:`EpiloguePlan` names the epilogue, :func:`kernel_epilogue`
passes it to a kernel (``csrc/epilogue.cuh`` selects identity, an exact
function or the table), and :func:`pwl_value_and_slope` is the plain version
of the device decode in ``csrc/pwl_decode.cuh``, accumulating the deltas in
the same order.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import functions as F
from repro_torch.core.pwl import PWLTable


def pwl_value_and_slope(x, bp, dmq, n_bp: int):
    """Delta-accumulation PWL decode: ``(f̂(x), m(x))`` in f32.

    Two operand layouts, told apart by the operand dtype:

    * **f32 (delta layout)** — ``bp``: (n_bp, 1); ``dmq``: (n_bp+1, 2) with
      row 0 = (m_0, q_0) and row i+1 = (dm_i, dq_i).
    * **bf16/f16 (native layout)** — ``bp``: (n_bp, 1) narrow breakpoints;
      ``dmq``: (n_bp+1, 2) raw (m_i, q_i) rows; deltas are formed in f32
      inside the loop (bit-identical to the f32 delta layout).

    Starts from (m_0, q_0) and adds ``(x > bp_i)·(dm_i, dq_i)`` for
    i = 0..n_bp-1 in that order.  The compare is strict, so the left segment
    owns a breakpoint, for the value and the slope alike.
    """
    xf = x.to(torch.float32)
    bp = bp.to(xf.device)
    dmq = dmq.to(xf.device)
    if dmq.dtype != torch.float32:
        raw = dmq.to(torch.float32)
        bpf = bp.to(torch.float32)
        m = torch.zeros_like(xf) + raw[0, 0]
        q = torch.zeros_like(xf) + raw[0, 1]
        for i in range(n_bp):
            c = (xf > bpf[i, 0]).to(torch.float32)
            m = m + c * (raw[i + 1, 0] - raw[i, 0])
            q = q + c * (raw[i + 1, 1] - raw[i, 1])
        return m * xf + q, m
    m = dmq[0, 0].expand(xf.shape).clone()
    q = dmq[0, 1].expand(xf.shape).clone()
    for i in range(n_bp):
        c = (xf > bp[i, 0]).to(torch.float32)
        m = m + c * dmq[i + 1, 0]
        q = q + c * dmq[i + 1, 1]
    return m * xf + q, m


def table_dtype_name(table: PWLTable) -> str:
    """Storage-format tag ("f32" | "bf16" | "f16" | "int8") of a table."""
    storage = getattr(table, "storage", "f32")
    if storage != "f32":
        return storage
    return {torch.bfloat16: "bf16", torch.float16: "f16"}.get(table.m.dtype, "f32")


def pack_table(table: PWLTable, dtype: str | None = None, native: bool | None = None):
    """Pack (bp, m, q) into the operand layout the decode consumes.

    ``dtype`` quantizes the table first.  bf16/f16 tables ship natively by
    default (narrow breakpoints + raw (m_i, q_i) rows); ``native=False``
    forces the f32 delta layout, which f32 and int8 tables always use.
    Returns CPU tensors ``(bp (n_bp, 1), dmq (n_bp+1, 2))``.
    """
    if dtype is not None and dtype != "f32":
        from repro_torch.sfu import quantize_table

        table = quantize_table(table, dtype)
    storage = table_dtype_name(table)
    if native is None:
        native = storage in ("bf16", "f16")
    if native and storage in ("bf16", "f16"):
        bp = table.bp.reshape(-1, 1).clone()
        mq = torch.stack([table.m, table.q], dim=1).to(table.m.dtype)
        return bp, mq
    m = table.m.to(torch.float32)
    q = table.q.to(torch.float32)
    dmq = torch.empty((m.shape[0], 2), dtype=torch.float32)
    dmq[0, 0], dmq[0, 1] = m[0], q[0]
    dmq[1:, 0] = m[1:] - m[:-1]
    dmq[1:, 1] = q[1:] - q[:-1]
    bp = table.bp.to(torch.float32).reshape(-1, 1).clone()
    return bp, dmq


@dataclasses.dataclass(frozen=True)
class EpiloguePlan:
    """Hashable epilogue spec.

    kind: "identity" | "exact:<fn-name>" | "pwl"
    n_bp: breakpoint count (pwl only).
    table_dtype: storage format of the table operands.
    """

    kind: str = "identity"
    n_bp: int = 0
    table_dtype: str = "f32"

    def apply(self, x, *tables):
        """Evaluate the epilogue on an accumulator.  Returns f32."""
        if self.kind == "identity":
            return x.to(torch.float32)
        if self.kind == "pwl":
            bp, dmq = tables
            return pwl_value_and_slope(x, bp, dmq, self.n_bp)[0]
        if self.kind.startswith("exact:"):
            fn = F.get(self.kind.split(":", 1)[1]).fn
            return fn(x.to(torch.float32))
        raise ValueError(f"unknown epilogue kind '{self.kind}'")

    def apply_value_and_slope(self, x, *tables):
        """``(act(x), act'(x))`` in f32, the epilogue of the backward: for a
        PWL table the decoded per-segment slope (the left segment owns a
        breakpoint), for an exact epilogue the derivative by autograd."""
        xf = x.to(torch.float32)
        if self.kind == "identity":
            return xf, torch.ones_like(xf)
        if self.kind == "pwl":
            bp, dmq = tables
            return pwl_value_and_slope(xf, bp, dmq, self.n_bp)
        if self.kind.startswith("exact:"):
            fn = F.get(self.kind.split(":", 1)[1]).fn
            with torch.enable_grad():
                xg = xf.detach().requires_grad_(True)
                a = fn(xg)
                (slope,) = torch.autograd.grad(a, xg, torch.ones_like(a))
            return a.detach(), slope
        raise ValueError(f"unknown epilogue kind '{self.kind}'")


IDENTITY = EpiloguePlan("identity")


def exact_plan(name: str) -> EpiloguePlan:
    F.get(name)  # validate early
    return EpiloguePlan(f"exact:{name}")


def plan_and_operands(table: PWLTable | None, act: str | None = None):
    """Resolve (plan, operands) from (table, act): table -> PWL epilogue,
    act -> exact epilogue, neither -> identity."""
    if table is not None and act is not None:
        raise ValueError("pass either table= (PWL epilogue) or act= (exact), not both")
    if table is not None:
        bp, dmq = pack_table(table)
        return EpiloguePlan("pwl", int(bp.shape[0]), table_dtype_name(table)), (bp, dmq)
    if act is not None:
        return exact_plan(act), ()
    return IDENTITY, ()


def pack_for(table: PWLTable, device, dtype: str | None = None):
    """:func:`pack_table` for a decode on ``device``: off the CPU a bf16/f16
    table is packed into the f32 delta layout, the one layout the CUDA
    kernels read.  Its deltas are formed from the exactly upcast narrow
    values, so it decodes bitwise as the native layout does (the plain
    decode forms the same f32 deltas inside its loop).  On the CPU the
    native layout stays, as the JAX package ships it.  Returns the operands
    on ``device``, contiguous."""
    dev = torch.device(device)
    bp, dmq = pack_table(table, dtype, native=None if dev.type == "cpu" else False)
    return bp.to(dev).contiguous(), dmq.to(dev).contiguous()


# (table, plan, operands) per (table, device), kept with the table they came
# from: packing and the host-to-device copy happen once per table and device
_PACKED: dict[tuple[int, str], tuple] = {}


def device_operands(table: PWLTable | None, act: str | None, device):
    """:func:`plan_and_operands` with the operands packed for ``device``
    (:func:`pack_for`; the plan keeps the table's storage tag) and copied
    there once per (table, device), so a kernel call does neither."""
    if table is None:
        return plan_and_operands(None, act)
    if act is not None:
        raise ValueError("pass either table= (PWL epilogue) or act= (exact), not both")
    key = (id(table), str(torch.device(device)))
    hit = _PACKED.get(key)
    if hit is None or hit[0] is not table:
        tables = pack_for(table, device)
        plan = EpiloguePlan("pwl", int(tables[0].shape[0]), table_dtype_name(table))
        hit = (table, plan, tables)
        _PACKED[key] = hit
    return hit[1], hit[2]


# The kernels' epilogue codes (csrc/epilogue.cuh): the kind, and the id of an
# exact function in the order of repro_torch.core.functions.REGISTRY
KIND_IDS = {"identity": 0, "exact": 1, "pwl": 2}
EXACT_IDS = {name: i for i, name in enumerate(F.REGISTRY)}
EPILOGUE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3


def kernel_epilogue(plan: EpiloguePlan, tables) -> tuple:
    """The epilogue as every CUDA kernel's C interface takes it, ``(bp, dmq,
    n_bp, kind, fn)`` (:data:`EPILOGUE_ARGTYPES`): the table operands'
    pointers and breakpoint count for a PWL plan (null and 0 otherwise), the
    kind, and the exact function's id."""
    if plan.kind == "pwl":
        bp, dmq = tables
        return bp.data_ptr(), dmq.data_ptr(), plan.n_bp, KIND_IDS["pwl"], 0
    if plan.kind == "identity":
        return None, None, 0, KIND_IDS["identity"], 0
    return None, None, 0, KIND_IDS["exact"], EXACT_IDS[plan.kind.split(":", 1)[1]]


def check_kernel_operands(what: str, plan: EpiloguePlan, tables, *forward_only) -> None:
    """Refuse what the CUDA kernels do not take, before any launch: table
    operands other than the f32 delta layout, and, for a kernel with no
    backward (the paged decode, which serves only; the flash attention has
    had its backward kernels since ROADMAP slice 3b), an input in
    ``forward_only`` that requires grad.  Every epilogue kind runs on the
    card (identity, exact ``act=``, PWL); every table format reaches the
    kernels in the f32 delta layout (:func:`device_operands`)."""
    if plan.kind == "pwl" and (tables[0].dtype != torch.float32
                               or tables[1].dtype != torch.float32):
        raise TypeError(f"the CUDA {what} kernel reads f32 delta-layout table operands "
                        "(device_operands packs every format so)")
    if any(t.requires_grad for t in forward_only):
        raise NotImplementedError(
            f"the CUDA {what} kernel is forward only: an input requires grad "
            "(it serves only; training attention takes the row softmax, or the flash "
            "kernels, which have a backward since ROADMAP slice 3b)")
