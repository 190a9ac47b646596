"""Paged KV cache: a fixed pool of page-sized KV blocks per layer plus a
per-request page table.

Every layer owns ``k_pages, v_pages : (Hkv, num_pages, page_size, head_dim)``
and a request maps logical position ``t`` to the physical slot
``(page_table[r, t // page_size], t % page_size)``.  The page table is
host-owned (:class:`PageAllocator`) and enters each step as an int32
tensor.  **Page 0 is the sentinel**: unallocated table entries are 0, so
inactive batch slots and prompt pad positions write into a page that is
never handed out and never read as valid.

The two writes update the pools **in place** (the JAX package aliases its
outputs to its inputs with ``input_output_aliases``; here the tensors passed
in are modified and nothing is returned):

* :func:`write_prompt_pages_` — prefill: (B, S, Hkv, dh) K/V into the pages
  the table names.  Replaces ``repro/serving/kv_cache.py:_prompt_write_kernel``.
* :func:`append_kv_` — decode: one token per request into row
  ``kv_len % ps`` of page ``page_table[b, kv_len // ps]``.  Replaces
  ``repro/serving/kv_cache.py:_append_kernel``.

Both CUDA kernels (``csrc/kv_cache.cu``) are bound by launch latency on an
H100 (a 32-token prefill moves ~98 KB per layer, a decode step ~12 KB per
layer), so each is one launch for K and V together that reads the page index
on the device.  A CPU tensor takes the plain version (index assignment); a
CUDA tensor launches the kernel or raises.

A write target outside the pools (a page id outside ``[0, P)``, or an
append past the table's last column) is refused by :func:`check_targets`
on host arrays: the CPU wrappers check their tensors, and the engine checks
its host mirrors before every step, so a bad table raises on either device.
The kernels read the table on the device and cannot raise; they skip such a
write rather than write out of bounds.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .resilience import PagePoolExhausted

SENTINEL_PAGE = 0

_SIGNATURES = {
    "kv_write_prompt": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "kv_append": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}


@dataclasses.dataclass
class PageAllocator:
    """LIFO free-list page allocator (host side).  Freed pages are reused
    first, so real admit/evict traffic gives fragmented page tables."""

    num_pages: int

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, SENTINEL_PAGE, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n == 0:
            return []
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted: asked {n}, {len(self._free)} free of "
                f"{self.num_pages} (admission control should prevent this)")
        pages = self._free[-n:][::-1]
        self._free = self._free[:-n]
        return pages

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p == SENTINEL_PAGE:
                raise ValueError("attempt to free the sentinel page")
            self._free.append(p)


def check_targets(page_table, num_pages: int, page_size: int, kv_len=None) -> None:
    """Raise ValueError unless every page id of ``page_table`` (B, n_cols)
    lies in ``[0, num_pages)`` and, given ``kv_len`` (B,), every append
    target ``kv_len // page_size`` is a column of the table.  Takes host
    arrays (numpy or CPU tensors)."""
    pt = np.asarray(page_table)
    if pt.size and (pt.min() < 0 or pt.max() >= num_pages):
        raise ValueError(f"page table holds page ids outside [0, {num_pages})")
    if kv_len is not None:
        lens, limit = np.asarray(kv_len), pt.shape[1] * page_size
        if lens.size and (lens.min() < 0 or lens.max() >= limit):
            raise ValueError(f"kv_len outside [0, {limit}): the append target lies "
                             "past the page table")


def _check_pools(k_pages, v_pages, k_new, v_new, page_table):
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    if k_new.shape != v_new.shape:
        raise ValueError("k_new and v_new must have one shape")
    Hkv, P, ps, dh = k_pages.shape
    if k_new.dim() != 4 or k_new.shape[2:] != (Hkv, dh):
        raise ValueError(f"new K/V must be (B, S, {Hkv}, {dh}), got {tuple(k_new.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != k_new.shape[0]:
        raise ValueError("page_table must be (B, n_pages)")
    return Hkv, P, ps, dh


def _kernel_args(k_pages, v_pages, k_new, v_new, page_table):
    dev = k_pages.device
    for t in (v_pages, k_new, v_new, page_table):
        if t.device != dev:
            raise ValueError("all tensors must be on the pools' device")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("pools must be contiguous (they are written in place)")
    if k_pages.element_size() not in (2, 4):
        raise TypeError(f"pool dtype {k_pages.dtype} is not 2 or 4 bytes wide")
    kn = k_new.to(k_pages.dtype).contiguous()
    vn = v_new.to(v_pages.dtype).contiguous()
    pt = page_table.to(torch.int32).contiguous()
    return kn, vn, pt


# ---------------------------------------------------------------------------
# prompt write


def write_prompt_pages_plain(k_pages, v_pages, k_new, v_new, page_table) -> None:
    Hkv, P, ps, dh = k_pages.shape
    B, S = k_new.shape[:2]
    npg = S // ps
    pt = page_table[:, :npg].long()
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        # (B, S, Hkv, dh) -> (Hkv, B, npg, ps, dh), indexed by the table
        pool[:, pt] = new.to(pool.dtype).reshape(B, npg, ps, Hkv, dh).permute(3, 0, 1, 2, 4)


def write_prompt_pages_(k_pages, v_pages, k_new, v_new, page_table) -> None:
    """Write a fresh prompt's K/V into the table's pages, **in place**.

    k_new/v_new: (B, S, Hkv, dh) with ``S % page_size == 0``; token ``s`` of
    request ``b`` lands in page ``page_table[b, s // page_size]`` slot
    ``s % page_size``.  Pools: (Hkv, P, page_size, dh), modified in place."""
    Hkv, P, ps, dh = _check_pools(k_pages, v_pages, k_new, v_new, page_table)
    B, S = k_new.shape[:2]
    if S % ps:
        raise ValueError(f"prompt length {S} not a multiple of page_size {ps}")
    if page_table.shape[1] < S // ps:
        raise ValueError("page table too narrow for this prompt")
    if k_pages.device.type == "cpu":
        check_targets(page_table[:, :S // ps], P, ps)
        write_prompt_pages_plain(k_pages, v_pages, k_new, v_new, page_table)
        return
    if k_pages.device.type != "cuda":
        raise ValueError(f"pools must be on cpu or cuda, got {k_pages.device}")
    from repro_torch.kernels import _build

    kn, vn, pt = _kernel_args(k_pages, v_pages, k_new, v_new, page_table)
    lib = _build.load("kv_cache", _SIGNATURES)
    dev = k_pages.device
    with torch.cuda.device(dev):
        err = lib.kv_write_prompt(
            kn.data_ptr(), vn.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pt.data_ptr(), pt.shape[1], B, S, Hkv, dh, P, ps, k_pages.element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "kv_write_prompt")
    write_prompt_pages_.launches += 1


write_prompt_pages_.launches = 0


# ---------------------------------------------------------------------------
# decode append


def append_kv_plain(k_pages, v_pages, k_new, v_new, page_table, kv_len) -> None:
    ps = k_pages.shape[2]
    kv_len = kv_len.long()
    pidx = torch.gather(page_table.long(), 1, (kv_len // ps)[:, None])[:, 0]
    slot = kv_len % ps
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        # (B, 1, Hkv, dh) -> (Hkv, B, dh) rows at (page, slot) per request
        pool[:, pidx, slot] = new[:, 0].to(pool.dtype).permute(1, 0, 2)


def append_kv_(k_pages, v_pages, k_new, v_new, page_table, kv_len) -> None:
    """Append one decode token's K/V per request, **in place**.

    k_new/v_new: (B, 1, Hkv, dh); ``kv_len``: (B,) int current valid length,
    so the token lands at page ``page_table[b, kv_len // ps]`` slot
    ``kv_len % ps``.  Inactive slots (all-sentinel rows) write into page 0."""
    Hkv, P, ps, dh = _check_pools(k_pages, v_pages, k_new, v_new, page_table)
    B = k_new.shape[0]
    if k_new.shape[1] != 1 or kv_len.shape != (B,):
        raise ValueError("append_kv_ takes one token per request and (B,) kv_len")
    if k_pages.device.type == "cpu":
        check_targets(page_table, P, ps, kv_len)
        append_kv_plain(k_pages, v_pages, k_new, v_new, page_table, kv_len)
        return
    if k_pages.device.type != "cuda":
        raise ValueError(f"pools must be on cpu or cuda, got {k_pages.device}")
    from repro_torch.kernels import _build

    kn, vn, pt = _kernel_args(k_pages, v_pages, k_new, v_new, page_table)
    if kv_len.device != k_pages.device:
        raise ValueError("kv_len must be on the pools' device")
    lens = kv_len.to(torch.int32).contiguous()
    lib = _build.load("kv_cache", _SIGNATURES)
    dev = k_pages.device
    with torch.cuda.device(dev):
        err = lib.kv_append(
            kn.data_ptr(), vn.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pt.data_ptr(), pt.shape[1], lens.data_ptr(), B, Hkv, dh, P, ps,
            k_pages.element_size(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "kv_append")
    append_kv_.launches += 1


append_kv_.launches = 0


# ---------------------------------------------------------------------------
# dense view


def gather_pages(pages, page_table):
    """The dense per-request cache a page table describes.

    pages: (Hkv, P, ps, dh); page_table: (B, n_pages).  Returns
    (B, n_pages * ps, Hkv, dh) in logical position order."""
    Hkv, P, ps, dh = pages.shape
    B, npg = page_table.shape
    g = pages[:, page_table.long()]  # (Hkv, B, npg, ps, dh)
    return g.permute(1, 2, 3, 0, 4).reshape(B, npg * ps, Hkv, dh)
