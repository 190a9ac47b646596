"""Fused flash attention forward with a PWL-exp online softmax (Sec. V-B).

Replaces ``repro/kernels/fused/attention.py:_flash_kernel`` (forward).  The
online softmax runs entirely through the non-uniform PWL decode: per KV
block, in f32::

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

The CUDA kernel is ``csrc/attention.cu``.  What bounds it on an H100: at the
serving shape (S = T = 4096 causal, 12 heads, dh 64) it moves 25 MB but does
~13 GFLOP of products and decodes ~100 M scores, so it is bound by
operations; this first version runs the products as f32 FMAs on CUDA cores.
A block owns 64 query rows of one head and keeps each 64 x 512 score tile in
shared memory, so the block max is known before any PWL exp of the block.

A CPU tensor takes the plain version below (the same 512-key chain); a CUDA
tensor launches the kernel or raises.  Forward only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.pwl import PWLTable

from .epilogue import EpiloguePlan, check_kernel_operands, device_operands
from .softmax import NEG_FILL, pwl_exp

DEFAULT_BLOCK_KV = 512  # keys per chain step, as the JAX kernel's KV blocks
MAX_HEAD_DIM = 128      # the kernel's Q and K/V tiles fit shared memory up to here

_SIGNATURES = {
    "flash_pwl_forward": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 11 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_kv(T: int) -> int:
    """Keys per chain step for a T-key cache: ``min(512, round_up(T, 128))``."""
    return min(DEFAULT_BLOCK_KV, -(-T // 128) * 128)


def fused_flash_attention_plain(q, k, v, plan: EpiloguePlan, tables, *, causal: bool,
                                window, q_offset: int, kv_valid_len):
    """Plain PyTorch version: the kernel's chain over KV blocks of
    :func:`block_kv` keys, every block for every row (a block masked for a
    whole row scales that row's l and acc alike)."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    qf = q.to(torch.float32).reshape(B, S, Hkv, G, dh).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)  # (B, Hkv, T, dh)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    qpos = q_offset + torch.arange(S, device=dev)
    vl = None
    if kv_valid_len is not None:
        vl = kv_valid_len.to(device=dev, dtype=torch.float32)[:, None, None, None, None]
    m = torch.full((B, Hkv, G, S, 1), NEG_FILL, device=dev)
    l = torch.zeros((B, Hkv, G, S, 1), device=dev)
    acc = torch.zeros((B, Hkv, G, S, dh), device=dev)
    bkv = block_kv(T)
    for j0 in range(0, T, bkv):
        kpos = torch.arange(j0, min(j0 + bkv, T), device=dev)
        keep = torch.ones((S, kpos.numel()), dtype=torch.bool, device=dev)
        if causal:
            keep &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            keep &= (qpos[:, None] - kpos[None, :]) < window
        keep = keep[None, None, None]
        if vl is not None:
            keep = keep & (kpos.to(torch.float32) < vl)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, j0:j0 + bkv]) * scale
        s = torch.where(keep, s, NEG_FILL)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = pwl_exp(s - m_new, plan, tables) * keep.to(torch.float32)
        corr = pwl_exp(m - m_new, plan, tables)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, j0:j0 + bkv])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(q.dtype)


def _launch(q, k, v, plan, tables, causal, window, q_offset, kv_valid_len):
    from repro_torch.kernels import _build

    check_kernel_operands("flash attention", plan, tables, q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"fused_flash_attention runs on cpu or cuda tensors, got {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_flash_attention kernel takes q, k and v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if dh % 16 or dh > MAX_HEAD_DIM:
        raise ValueError(f"fused_flash_attention kernel takes head_dim a multiple of 16 "
                         f"up to {MAX_HEAD_DIM}, got {dh}")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    vl = None
    if kv_valid_len is not None:
        vl = kv_valid_len.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(qc)
    bp, dmq = tables
    lib = _build.load("attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_pwl_forward(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), None if vl is None else vl.data_ptr(),
            bp.data_ptr(), dmq.data_ptr(), plan.n_bp, out.data_ptr(), B, S, T, H, Hkv, dh,
            int(causal), int(window is not None), 0 if window is None else int(window),
            int(q_offset), _KERNEL_DTYPES[q.dtype], stream)
    _build.check(err, "flash_pwl_forward")
    fused_flash_attention.launches += 1
    return out


def fused_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          table: PWLTable | None = None, act: str | None = None,
                          causal: bool = True, window: int | None = None, q_offset: int = 0,
                          kv_valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Flash attention with the online-softmax exp through the PWL decode.

    q: (B, S, H, dh); k/v: (B, T, Hkv, dh) with H a multiple of Hkv.
    ``table`` is the exp table of the ``attn.softmax:exp`` site; ``act="exp"``
    (the default when neither is given) runs the exact exponential in the
    same chain (CPU only).  ``causal``/``window`` mask by position (queries
    start at ``q_offset``); ``kv_valid_len`` (B,) is each row's valid key
    prefix.  Returns (B, S, H, dh) in q's dtype."""
    if table is None and act is None:
        act = "exp"
    plan, tables = device_operands(table, act, q.device)
    B, S, H, dh = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"k/v must be ({B}, T, Hkv, {dh}), got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} KV heads")
    if q.device.type == "cpu":
        return fused_flash_attention_plain(q, k, v, plan, tables, causal=causal,
                                           window=window, q_offset=int(q_offset),
                                           kv_valid_len=kv_valid_len)
    return _launch(q, k, v, plan, tables, causal, window, int(q_offset), kv_valid_len)


fused_flash_attention.launches = 0
