"""Fused flash attention with a PWL-exp online softmax (Sec. V-B), forward
and backward.

Replaces ``repro/kernels/fused/attention.py:_flash_kernel`` (forward) and
its four backward passes, ``_flash_bwd_stats_kernel``,
``_flash_bwd_dm_kernel``, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``.  The online softmax runs entirely through the
non-uniform PWL decode: per KV block, in f32::

    s      = (q @ k^T) * scale           (masked to -1e30)
    m_new  = max(m_prev, rowmax(s))
    p      = max(PWL_exp(max(s - m_new, -1e4)), 0) * mask
    corr   = max(PWL_exp(max(m_prev - m_new, -1e4)), 0)
    l_new  = l_prev * corr + rowsum(p)
    acc    = acc * corr + p @ v

``PWL_exp(0)`` is not 1, so the chain's steps are part of the function: the
KV blocks are the JAX kernel's, ``min(512, round_up(T, 128))`` keys, and the
row max is taken over a whole block.  Masks: causal and sliding window from
positions (queries start at ``q_offset``), and a ragged valid prefix per
batch row (``kv_valid_len``, compared as f32).  GQA folds the query heads as
(Hkv major, G minor).  A row with no valid key gives zeros.

The gradient is the JAX package's: that of the dense oracle
(:func:`flash_reference_attention`, one PWL softmax over each whole row) at
the forward's final row max m, which is bitwise the dense row max (max
telescopes) and the only residual beyond q, k and v.  Under
``impl_bwd="fused"`` (the default) it is computed blockwise by
:func:`fused_flash_attention_bwd`, which never holds an (S, T) tensor;
under ``"recompute"`` by autograd through the dense oracle.

The CUDA kernels are ``csrc/attention.cu`` (forward) and
``csrc/attention_bwd.cu`` (backward).  What bounds them on an H100: at
S = T = 4096 causal, 12 heads, dh 64, the forward moves 25 MB but does ~26
GFLOP of products and decodes ~1e8 scores, and the backward does the five
products of the gradient (~64 GFLOP) and decodes every score three times,
so both are bound by operations, most of them the PWL decode on CUDA cores
(the work the paper's SFU does in hardware).  The C dispatch picks the
design by dtype.  bf16, the model paths' dtype, runs the products on tensor
cores (``mma.sync`` bf16 into f32; a product whose left operand is a decoded
f32 value, p, u / L or ds, as two bf16 products of its hi and lo halves)
and decodes by a binary search over the breakpoints with a prefix table
(:func:`.epilogue.search_prefix`, built once per packed table; the
breakpoints must ascend, as ``PWLTable`` promises, and the wrappers refuse
a table whose breakpoints do not).  Each score is summed in the same order in all four
kernels, so the backward re-finds the forward's row max bitwise.  f32 keeps
the first design, f32 FMAs on CUDA cores and the linear decode.

A CPU tensor takes the plain versions below (the same 512-key chain
forward); a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.functions import tie_max
from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import _build

from . import meta
from .backward import resolve_impl_bwd
from .epilogue import (
    EPILOGUE_ARGTYPES,
    EpiloguePlan,
    check_ascending,
    check_kernel_operands,
    device_operands,
    kernel_epilogue,
    refuse_unsorted,
    search_prefix_ptr,
)
from .softmax import NEG_FILL, SHIFT_CLAMP, fused_pwl_softmax_plain, pwl_exp

DEFAULT_BLOCK_KV = 512  # keys per chain step, as the JAX kernel's KV blocks
MAX_HEAD_DIM = 256      # the JAX kernels' VMEM budget

_SIGNATURES = {
    "flash_pwl_forward": [ctypes.c_void_p] * 4 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 11 + [ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "flash_pwl_backward": [ctypes.c_void_p] * 6 + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 11 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_kv(T: int) -> int:
    """Keys per chain step for a T-key cache: ``min(512, round_up(T, 128))``."""
    return min(DEFAULT_BLOCK_KV, -(-T // 128) * 128)


def _fold(q, k, v):
    """f32 operands in the folded layout: q (B, Hkv, G, S, dh), k/v
    (B, Hkv, T, dh)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    qf = q.to(torch.float32).reshape(B, S, Hkv, H // Hkv, dh).permute(0, 2, 3, 1, 4)
    return qf, k.to(torch.float32).permute(0, 2, 1, 3), v.to(torch.float32).permute(0, 2, 1, 3)


def _unfold(x):
    """(B, Hkv, G, S, dh) -> (B, S, H, dh)."""
    B, Hkv, G, S, dh = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G, dh)


def _keep(S, j0, j1, causal, window, q_offset, kv_valid_len, device):
    """The mask of keys ``j0:j1`` for every query, broadcastable to
    (B, Hkv, G, S, j1 - j0): causal and window by position, the valid
    prefix compared as f32."""
    qpos = q_offset + torch.arange(S, device=device)
    kpos = torch.arange(j0, j1, device=device)
    keep = torch.ones((S, j1 - j0), dtype=torch.bool, device=device)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        keep &= (qpos[:, None] - kpos[None, :]) < window
    keep = keep[None, None, None]
    if kv_valid_len is not None:
        vl = kv_valid_len.to(device=device, dtype=torch.float32)[:, None, None, None, None]
        keep = keep & (kpos.to(torch.float32) < vl)
    return keep


def fused_flash_attention_plain(q, k, v, plan: EpiloguePlan, tables, *, causal: bool,
                                window, q_offset: int, kv_valid_len):
    """Plain PyTorch version of the forward kernel: the chain over KV blocks
    of :func:`block_kv` keys, every block for every row (a block masked for
    a whole row scales that row's l and acc alike).  Returns ``(out
    (B, S, H, dh) in q's dtype, m (B, H, S) f32)``, m each row's final
    running max, the residual of the backward."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf = _fold(q, k, v)
    m = torch.full((*qf.shape[:4], 1), NEG_FILL, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    bkv = block_kv(T)
    for j0 in range(0, T, bkv):
        j1 = min(j0 + bkv, T)
        keep = _keep(S, j0, j1, causal, window, q_offset, kv_valid_len, dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, j0:j1]) * scale
        s = torch.where(keep, s, NEG_FILL)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = pwl_exp(s - m_new, plan, tables) * keep.to(torch.float32)
        corr = pwl_exp(m - m_new, plan, tables)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, j0:j1])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return _unfold(out).to(q.dtype), m.reshape(B, H, S)


def flash_reference_attention(q, k, v, plan: EpiloguePlan, tables, *, causal: bool, window,
                              q_offset: int, kv_valid_len):
    """The dense oracle whose gradient the backward computes (the JAX
    package's ``_reference_attention``): einsum scores in f32, a
    materialised mask, one PWL softmax over each whole row
    (:func:`fused_pwl_softmax_plain`), an einsum with V.  Returns
    (B, S, H, dh) f32.  Holds B*H*S*T scores: the recompute backward's
    oracle, not a path for long rows."""
    S, dh = q.shape[1], q.shape[3]
    T = k.shape[1]
    qf, kf, vf = _fold(q, k, v)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * (1.0 / math.sqrt(dh))
    keep = _keep(S, 0, T, causal, window, q_offset, kv_valid_len, q.device)
    mask = torch.broadcast_to(keep, s.shape).to(torch.float32)
    p = fused_pwl_softmax_plain(s.reshape(-1, T), mask.reshape(-1, T), plan, tables)
    return _unfold(torch.einsum("bhgqk,bhkd->bhgqd", p.reshape(s.shape), vf))


def _gate(x, c: float):
    """jnp's gradient of ``maximum(x, c)`` in x: 1 above c, 0.5 at it, 0 below."""
    return (x > c).to(torch.float32) + 0.5 * (x == c).to(torch.float32)


def fused_flash_attention_bwd_plain(q, k, v, dout, m, plan: EpiloguePlan, tables, *,
                                    causal: bool, window, q_offset: int, kv_valid_len):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` in the
    inputs' dtypes, the gradient of :func:`flash_reference_attention` at the
    saved row max ``m`` (B, H, S), following the JAX package's blocked passes
    op for op (``attention.py:_bwd_keep_terms`` / ``_bwd_du`` and the four
    kernels).  Per row i and key j, with s masked to -1e30 and t = s - m:

        u  = max(pwl(max(t, -1e4)), 0)·keep     l = Σu,  L = max(l, 1e-30)
        δ  = dout·(Σ u·v) / L                   dp = dout·v
        du = (dp - gl·δ) / L                    dt = du·gate
        dm = -Σ dt                              ds = (dt + dm·eq/ntie)·keep·scale
        dq = Σ ds·k,   dk = Σ ds·q,   dv = Σ (u/L)·dout

    where gate is keep times the two clamps' gates (1 above, 0.5 at, 0 below
    the threshold) times the PWL slope, gl is the gate of ``max(l, 1e-30)``,
    eq marks the ties with the row max and ntie counts them (at least 1).
    It walks the KV blocks of :func:`block_kv` keys, each for all rows, so
    the scores are bitwise the plain forward's and no (S, T) tensor is held;
    dk and dv sum the G query heads of each KV head."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf = _fold(q, k, v)
    dof = dout.to(torch.float32).reshape(B, S, Hkv, G, dh).permute(0, 2, 3, 1, 4)
    mv = m.to(device=dev, dtype=torch.float32).reshape(B, Hkv, G, S, 1)
    bkv = block_kv(T)
    tiles = [(j0, min(j0 + bkv, T)) for j0 in range(0, T, bkv)]

    def terms(j0, j1):
        keepf = _keep(S, j0, j1, causal, window, q_offset, kv_valid_len, dev).to(torch.float32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, j0:j1]) * scale
        s = torch.where(keepf > 0, s, NEG_FILL)
        eq = (s == mv).to(torch.float32)
        t = s - mv
        p_raw, slope = plan.apply_value_and_slope(tie_max(t, SHIFT_CLAMP), *tables)
        u = tie_max(p_raw, 0.0) * keepf
        gate = keepf * _gate(p_raw, 0.0) * slope * _gate(t, SHIFT_CLAMP)
        return u, gate, eq, keepf

    def dp_of(j0, j1):
        return torch.einsum("bhgqd,bhkd->bhgqk", dof, vf[:, :, j0:j1])

    # pass A: l, delta and the tie count per row
    l = torch.zeros_like(mv)
    acc_o = torch.zeros_like(qf)
    ntie = torch.zeros_like(mv)
    for j0, j1 in tiles:
        u, _, eq, _ = terms(j0, j1)
        l = l + u.sum(dim=-1, keepdim=True)
        acc_o = acc_o + torch.einsum("bhgqk,bhkd->bhgqd", u, vf[:, :, j0:j1])
        ntie = ntie + eq.sum(dim=-1, keepdim=True)
    L = tie_max(l, 1e-30)
    delta = (dof * acc_o).sum(dim=-1, keepdim=True) / L
    ntie = tie_max(ntie, 1.0)
    gl = _gate(l, 1e-30)

    # pass B: the row max's gradient
    dm = torch.zeros_like(mv)
    for j0, j1 in tiles:
        _, gate, _, _ = terms(j0, j1)
        du = (dp_of(j0, j1) - gl * delta) / L
        dm = dm - (du * gate).sum(dim=-1, keepdim=True)

    # passes C and D: dq over the key blocks; dk and dv of each block
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for j0, j1 in tiles:
        u, gate, eq, keepf = terms(j0, j1)
        du = (dp_of(j0, j1) - gl * delta) / L
        ds = (du * gate + dm * eq / ntie) * keepf * scale
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kf[:, :, j0:j1])
        dk[:, :, j0:j1] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
        dv[:, :, j0:j1] = torch.einsum("bhgqk,bhgqd->bhkd", u / L, dof)
    return (_unfold(dq).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _check_operands(q, k, v, what: str):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes q, k and v all float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    dh = q.shape[3]
    if dh % 16 or dh > MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel takes head_dim a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    return tuple(_aligned(t.contiguous()) for t in (q, k, v))


def _aligned(t):
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    bf16 kernels copy tiles 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _valid_len(kv_valid_len, dev):
    if kv_valid_len is None:
        return None
    return kv_valid_len.to(device=dev, dtype=torch.float32).contiguous()


def _launch(q, k, v, plan, tables, causal, window, q_offset, kv_valid_len, want_max):
    """The forward kernel: ``(out, m)``, m (B, H, S) f32 when ``want_max``
    (else None, and the kernel writes no row max)."""
    from repro_torch.kernels import _build

    check_kernel_operands("flash attention", plan, tables)
    qc, kc, vc = _check_operands(q, k, v, "fused_flash_attention")
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    vl = _valid_len(kv_valid_len, dev)
    out = torch.empty_like(qc)
    m = torch.empty((B, H, S), dtype=torch.float32, device=dev) if want_max else None
    lib = _build.load("attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_pwl_forward(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), None if vl is None else vl.data_ptr(),
            *kernel_epilogue(plan, tables), search_prefix_ptr(plan, tables), out.data_ptr(),
            None if m is None else m.data_ptr(), B, S, T, H, Hkv, dh,
            int(causal), int(window is not None), 0 if window is None else int(window),
            int(q_offset), _KERNEL_DTYPES[q.dtype], stream)
    _build.check(err, "flash_pwl_forward")
    fused_flash_attention.launches += 1
    return out, m


def _launch_bwd(q, k, v, dout, m, plan, tables, causal, window, q_offset, kv_valid_len,
                stats=None):
    """The backward kernels: ``(dq, dk, dv)``.  ``stats`` is the (4, B, H, S)
    f32 scratch of the row statistics (l, delta, the raw tie count, dm),
    allocated here unless the caller passes one to read it back."""
    from repro_torch.kernels import _build

    check_kernel_operands("flash attention backward", plan, tables)
    qc, kc, vc = _check_operands(q, k, v, "fused_flash_attention_bwd")
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != dev:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} on {dev}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    if m.shape != (B, H, S) or m.dtype != torch.float32 or m.device != dev:
        raise ValueError(f"m must be ({B}, {H}, {S}) float32 on {dev}, got "
                         f"{tuple(m.shape)} {m.dtype} on {m.device}")
    doc, mc = _aligned(dout.contiguous()), m.contiguous()
    vl = _valid_len(kv_valid_len, dev)
    dq, dk, dv = torch.empty_like(qc), torch.empty_like(kc), torch.empty_like(vc)
    if stats is None:
        stats = torch.empty((4, B, H, S), dtype=torch.float32, device=dev)
    elif stats.shape != (4, B, H, S) or stats.dtype != torch.float32 or stats.device != dev \
            or not stats.is_contiguous():
        raise ValueError(f"stats must be contiguous (4, {B}, {H}, {S}) float32 on {dev}")
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_pwl_backward(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), doc.data_ptr(),
            None if vl is None else vl.data_ptr(), mc.data_ptr(),
            *kernel_epilogue(plan, tables), search_prefix_ptr(plan, tables), stats.data_ptr(),
            dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, T, H, Hkv, dh, int(causal), int(window is not None),
            0 if window is None else int(window), int(q_offset), _KERNEL_DTYPES[q.dtype],
            stream)
    _build.check(err, "flash_pwl_backward")
    fused_flash_attention.bwd_launches += 1
    return dq, dk, dv


def fused_flash_attention_bwd(q, k, v, dout, m, plan: EpiloguePlan, tables, *, causal: bool,
                              window, q_offset: int, kv_valid_len):
    """``(dq, dk, dv)`` of the fused flash attention at the saved row max
    ``m`` (B, H, S) f32, in the inputs' dtypes: the backward kernels on CUDA
    tensors, their plain version on CPU tensors."""
    _build.refuse_dtensor("fused_flash_attention_bwd", q, k, v, dout, m)
    if meta.is_meta(q):  # shapes only (meta.py)
        return meta.flash_bwd(q, k, v, dout, causal, window, int(q_offset))
    kw = dict(causal=causal, window=window, q_offset=int(q_offset), kv_valid_len=kv_valid_len)
    if q.device.type == "cpu":
        refuse_unsorted(plan, tables)
        return fused_flash_attention_bwd_plain(q, k, v, dout, m, plan, tables, **kw)
    return _launch_bwd(q, k, v, dout, m, plan, tables, causal, window, int(q_offset),
                       kv_valid_len)


class _FlashOp(torch.autograd.Function):
    """The fused flash attention with the JAX package's VJP
    (``attention.py:_attn_op_bwd``): the gradient of the dense oracle at the
    saved row max, in the inputs' dtypes; the tables and ``kv_valid_len``
    get none."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid_len, plan, tables, causal, window, q_offset, impl_bwd,
                need_grad):
        if q.device.type == "cpu":
            out, m = fused_flash_attention_plain(q, k, v, plan, tables, causal=causal,
                                                 window=window, q_offset=q_offset,
                                                 kv_valid_len=kv_valid_len)
        elif meta.is_meta(q):  # shapes only (meta.py)
            out, m = meta.flash(q, k, v, causal, window, q_offset)
        else:
            out, m = _launch(q, k, v, plan, tables, causal, window, q_offset, kv_valid_len,
                             need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, kv_valid_len, m)
        ctx.args = (plan, tables, causal, window, q_offset, impl_bwd)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid_len, m = ctx.saved_tensors
        plan, tables, causal, window, q_offset, impl_bwd = ctx.args
        kw = dict(causal=causal, window=window, q_offset=q_offset, kv_valid_len=kv_valid_len)
        if impl_bwd == "fused":
            dq, dk, dv = fused_flash_attention_bwd(q, k, v, dout, m, plan, tables, **kw)
        else:
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = flash_reference_attention(*qkv, plan, tables, **kw)
                grads = torch.autograd.grad(out, qkv, dout.to(torch.float32))
            dq, dk, dv = (g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None, None, None, None, None, None


def fused_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          table: PWLTable | None = None, act: str | None = None,
                          causal: bool = True, window: int | None = None, q_offset: int = 0,
                          kv_valid_len: torch.Tensor | None = None,
                          impl_bwd: str | None = None) -> torch.Tensor:
    """Flash attention with the online-softmax exp through the PWL decode.

    q: (B, S, H, dh); k/v: (B, T, Hkv, dh) with H a multiple of Hkv.
    ``table`` is the exp table of the ``attn.softmax:exp`` site; ``act="exp"``
    (the default when neither is given) runs the exact exponential in the
    same chain, on the card too; head_dim a multiple of 16 up to 256 there.
    ``causal``/``window`` mask by position (queries start at ``q_offset``);
    ``kv_valid_len`` (B,) is each row's valid key prefix.  Returns (B, S, H, dh) in q's dtype.  Differentiable in q, k
    and v; ``impl_bwd`` picks the backward (:mod:`.backward`)."""
    _build.refuse_dtensor("fused_flash_attention", q, k, v)
    if table is None and act is None:
        act = "exp"
    if table is not None and q.device.type == "cpu":
        check_ascending(table.bp)  # on the card the kernels' prefix table checks it
    plan, tables = device_operands(table, act, q.device)
    B, S, H, dh = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"k/v must be ({B}, T, Hkv, {dh}), got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} KV heads")
    need_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FlashOp.apply(q, k, v, kv_valid_len, plan, tables, causal, window, int(q_offset),
                          resolve_impl_bwd(impl_bwd), need_grad)


fused_flash_attention.launches = 0
fused_flash_attention.bwd_launches = 0
