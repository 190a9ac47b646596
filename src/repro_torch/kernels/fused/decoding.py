"""Split-KV flash decoding through a page table, PWL-exp online softmax.

Replaces ``repro/kernels/fused/decoding.py:_decode_kernel`` and the merge of
its splits (``merge_split_partials``, ``decoding.py:133``).  One decode query
per request attends straight over the paged pools ``(Hkv, P, page_size,
dh)`` through the page table ``(B, n_cols)``: no dense cache is gathered.
The KV axis is cut into splits of ``pages_per_split`` pages (2048 keys by
default); each split runs the online softmax one page per chain step, in
page order, with the PWL exp on the shifted scores and on the correction
factor, and emits ``(m, l, acc)`` partials; the merge rescales them by
``PWL_exp(m_s - max_s m_s)``::

    out = sum_s(acc_s e_s) / max(sum_s(l_s e_s), 1e-30)

``PWL_exp(0)`` is not 1, so the page boundaries are part of the function.
Pages at or past a request's ``kv_len`` are skipped, empty splits vanish
from both sums, and a request with ``kv_len == 0`` gives exact zeros.

The CUDA kernels are ``csrc/decoding.cu`` (split, then merge, from one
call).  What bounds them on an H100: each live page is read once (bytes),
with a few FMAs per element, so at the serving shapes (4 requests of ~40
keys) launch latency is the cost.  They read the bf16 pools in place and
widen in shared memory (no f32 copy of the pool), and read ``kv_len`` and
the page table on the device (no host sync).

A CPU tensor takes the plain version below (the same page chain as a
Python loop); a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.pwl import PWLTable

from .epilogue import (
    EPILOGUE_ARGTYPES,
    EpiloguePlan,
    check_kernel_operands,
    device_operands,
    kernel_epilogue,
)
from .softmax import NEG_FILL, pwl_exp

DEFAULT_SPLIT_KEYS = 2048  # key positions per KV split

_SIGNATURES = {
    "paged_decode_forward": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    + EPILOGUE_ARGTYPES + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def merge_split_partials(m_p, l_p, acc_p, plan: EpiloguePlan, tables):
    """Reduce per-split (m, l, acc) partials.  m_p/l_p: (..., n_splits, G);
    acc_p: (..., n_splits, G, dh).  The rescale exp runs through the same
    epilogue as the in-split online softmax."""
    m_max = m_p.amax(dim=-2, keepdim=True)
    e = pwl_exp(m_p - m_max, plan, tables)
    l = (l_p * e).sum(dim=-2)
    acc = (acc_p * e[..., None]).sum(dim=-3)
    return acc / torch.clamp(l[..., None], min=1e-30)


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, kv_len, plan: EpiloguePlan,
                             tables, pps: int):
    """Plain PyTorch version: the kernels' page chain, one page of every
    split per step of a Python loop, then :func:`merge_split_partials`."""
    B, _, H, dh = q.shape
    Hkv, _, ps, _ = k_pages.shape
    G = H // Hkv
    dev = q.device
    n_cols = page_table.shape[1]
    ns = -(-n_cols // pps)
    pt = torch.zeros((B, ns * pps), dtype=torch.long, device=dev)
    pt[:, :n_cols] = page_table.long()  # padding columns read sentinel page 0
    pt = pt.reshape(B, ns, pps)
    kvl = kv_len.to(device=dev, dtype=torch.long)
    qf = q.to(torch.float32).reshape(B, Hkv, G, dh)
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((B, Hkv, ns, G), NEG_FILL, device=dev)
    l = torch.zeros((B, Hkv, ns, G), device=dev)
    acc = torch.zeros((B, Hkv, ns, G, dh), device=dev)
    split0 = torch.arange(ns, device=dev) * pps
    for p in range(pps):
        page0 = (split0 + p) * ps                                    # (ns,)
        live = (page0[None, :] < kvl[:, None])[:, None, :, None]    # (B, 1, ns, 1)
        kpos = page0[:, None] + torch.arange(ps, device=dev)        # (ns, ps)
        keep = (kpos[None] < kvl[:, None, None])[:, None, :, None, :]  # (B, 1, ns, 1, ps)
        kb = k_pages[:, pt[:, :, p]].to(torch.float32)  # (Hkv, B, ns, ps, dh)
        vb = v_pages[:, pt[:, :, p]].to(torch.float32)
        sc = torch.einsum("bhgd,hbskd->bhsgk", qf, kb) * scale
        sc = torch.where(keep, sc, NEG_FILL)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        pr = pwl_exp(sc - m_new[..., None], plan, tables) * keep.to(torch.float32)
        corr = pwl_exp(m - m_new, plan, tables)
        l_new = l * corr + pr.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhsgk,hbskd->bhsgd", pr, vb)
        # a page at or past kv_len is skipped: the chain does not step
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    out = merge_split_partials(m, l, acc, plan, tables)  # (B, Hkv, G, dh)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def _launch(q, k_pages, v_pages, page_table, kv_len, plan, tables, pps):
    from repro_torch.kernels import _build

    check_kernel_operands("paged decode", plan, tables, q, k_pages, v_pages)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on cpu or cuda tensors, got {dev}")
    for t in (k_pages, v_pages, page_table, kv_len):
        if t.device != dev:
            raise ValueError("q, the pools, page_table and kv_len must be on one device")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("k_pages and v_pages must have one dtype")
    if q.dtype not in _KERNEL_DTYPES or k_pages.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged_flash_decode kernel takes float32 or bfloat16, got q "
                        f"{q.dtype}, pools {k_pages.dtype}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("pools must be contiguous (they are read in place)")
    B, _, H, dh = q.shape
    Hkv, P, ps, _ = k_pages.shape
    G = H // Hkv
    n_cols = page_table.shape[1]
    ns = -(-n_cols // pps)
    qc = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    m_p = torch.empty((B * Hkv, ns, G), dtype=torch.float32, device=dev)
    l_p = torch.empty_like(m_p)
    acc_p = torch.empty((B * Hkv, ns, G, dh), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, H, dh), dtype=q.dtype, device=dev)
    lib = _build.load("decoding", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_decode_forward(
            qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), pt.data_ptr(), n_cols,
            kvl.data_ptr(), *kernel_epilogue(plan, tables), m_p.data_ptr(),
            l_p.data_ptr(), acc_p.data_ptr(), out.data_ptr(), B, Hkv, P, ps, dh, G, pps, ns,
            _KERNEL_DTYPES[q.dtype], _KERNEL_DTYPES[k_pages.dtype], stream)
    _build.check(err, "paged_decode_forward")
    paged_flash_decode.launches += 1
    return out


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                       page_table: torch.Tensor, kv_len: torch.Tensor, *,
                       table: PWLTable | None = None, act: str | None = None,
                       pages_per_split: int | None = None) -> torch.Tensor:
    """Split-KV flash decoding through a page table (see the module doc).

    q: (B, 1, H, dh); k_pages/v_pages: (Hkv, P, page_size, dh);
    page_table: (B, n_cols) int (0 = sentinel); kv_len: (B,) valid prefix
    (0 = inactive slot).  ``table`` is the exp table; ``act="exp"`` (the
    default when neither is given) runs the exact exponential through the
    same chain, on the card too.  Returns (B, 1, H, dh) in q's dtype."""
    if table is None and act is None:
        act = "exp"
    plan, tables = device_operands(table, act, q.device)
    B, S, H, dh = q.shape
    if S != 1:
        raise ValueError(f"paged_flash_decode takes single-token queries, got S={S}")
    Hkv, _, ps, dh_kv = k_pages.shape
    if H % Hkv or dh_kv != dh or v_pages.shape != k_pages.shape:
        raise ValueError(f"q (.., {H}, {dh}) does not fit pools {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or page_table.shape[1] < 1:
        raise ValueError(f"page_table must be ({B}, n_cols >= 1), got {tuple(page_table.shape)}")
    pps = pages_per_split or max(1, DEFAULT_SPLIT_KEYS // ps)
    pps = min(pps, page_table.shape[1])
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, page_table, kv_len, plan,
                                        tables, pps)
    return _launch(q, k_pages, v_pages, page_table, kv_len, plan, tables, pps)


paged_flash_decode.launches = 0
