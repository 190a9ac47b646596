"""Paged KV cache: a fixed pool of page-sized KV blocks per layer plus a
per-request page table.

Every layer owns ``k_pages, v_pages : (Hkv, num_pages, page_size, head_dim)``
and a request maps logical position ``t`` to the physical slot
``(page_table[r, t // page_size], t % page_size)``.  The page table is
host-owned (:class:`PageAllocator`) and enters each step as an int32
tensor.  **Page 0 is the sentinel**: unallocated table entries are 0, so
inactive batch slots and prompt pad positions write into a page that is
never handed out and never read as valid.

The writes update the pools **in place** (the JAX package aliases its
outputs to its inputs with ``input_output_aliases``; here the tensors passed
in are modified):

* :func:`write_prompt_pages_` — prefill: (B, S, Hkv, dh) K/V into the pages
  the table names.  Replaces ``repro/serving/kv_cache.py:_prompt_write_kernel``.
* :func:`append_kv_` — decode: one token per request into row
  ``kv_len % ps`` of page ``page_table[b, kv_len // ps]``.  Replaces
  ``repro/serving/kv_cache.py:_append_kernel``.
* :func:`rope_write_prompt_pages_` and :func:`rope_append_kv_` — the same
  writes of the rotated K and the plain V, which also rotate q (and return
  it, with the prefill's rotated K): the paged model calls' path, one launch
  a layer where the rotation was 32 launches before the write.  Each is
  ``models/layers.py apply_rope`` on the ``rope_tables`` the model call
  computed once, then the write.

All of them launch one CUDA kernel (``csrc/kv_cache.cu``, one template) that
reads the page index on the device.  A decode step's or a short prefill's
write is bound by launch latency on an H100 (~38 KB a layer at a
repro-100m decode step with the rotation), a 2 x 4096 prefill by bytes
(~90 MB), so the kernel moves 16-byte vectors.  A CPU tensor takes the plain version (index assignment); a
CUDA tensor launches the kernel or raises.

Under rules with a mesh (``distributed.sharding.active_mesh_rules``) the
rotating writes run per shard in a ``local_map`` body on each rank's pools:
the pools shard over their KV heads ("cache_kv"), q over the matching head
groups, and the batch stays replicated, so every data rank applies every
request's write and the pool replicas never diverge (the JAX package's
``kv_cache.py:147-170, 233-255``).  The pools must already hold that
placement: the body writes into their own storage.  :func:`check_targets`
runs on the whole host table, outside the body.

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

from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed.sharding import active_mesh_rules, placements, unruled
from repro_torch.kernels import _build

from .resilience import PagePoolExhausted

SENTINEL_PAGE = 0

_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "kv_write_prompt": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "kv_append": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "kv_rope_write_prompt": [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [_STRIDES] + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "kv_rope_append": [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [_STRIDES] + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}
_ROPE_FMT = {torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}


@dataclasses.dataclass
class PageAllocator:
    """LIFO free-list page allocator (host side).  Freed pages are reused
    first, so real admit/evict traffic gives fragmented page tables.
    ``faults`` (a :class:`~repro_torch.serving.faults.FaultInjector`) can
    make an allocation of a given ``scope`` ("admit" or "grow") raise
    :class:`PagePoolExhausted` as a dry pool would."""

    num_pages: int
    faults: object = None

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, SENTINEL_PAGE, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int, scope: str = "") -> list[int]:
        if n == 0:
            return []
        if self.faults is not None and self.faults.alloc_should_fail(scope):
            raise PagePoolExhausted(
                f"page pool exhausted (injected fault, scope={scope or 'any'}): "
                f"asked {n}, {len(self._free)} free of {self.num_pages}")
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


def _vec(elem_size: int, span: int, tensors, strides) -> int:
    """Elements a kernel work item moves: 16 bytes of them when every piece
    of ``span`` elements' rows starts 16 bytes aligned (the tensors' data and
    their row ``strides``, in elements), else 1."""
    w = 16 // elem_size
    if span % w or any(t.data_ptr() % 16 for t in tensors) or any(st % w for st in strides):
        return 1
    return w


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
    _build.refuse_dtensor("write_prompt_pages_", k_pages, v_pages, k_new, v_new, page_table)
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
    kn, vn, pt = _kernel_args(k_pages, v_pages, k_new, v_new, page_table)
    lib = _build.load("kv_cache", _SIGNATURES)
    dev = k_pages.device
    vec = _vec(k_pages.element_size(), dh, [kn, vn, k_pages, v_pages], [])
    with torch.cuda.device(dev):
        err = lib.kv_write_prompt(
            kn.data_ptr(), vn.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pt.data_ptr(), pt.shape[1], B, S, Hkv, dh, P, ps, k_pages.element_size(), vec,
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
    _build.refuse_dtensor("append_kv_", k_pages, v_pages, k_new, v_new, page_table, kv_len)
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
    kn, vn, pt = _kernel_args(k_pages, v_pages, k_new, v_new, page_table)
    if kv_len.device != k_pages.device:
        raise ValueError("kv_len must be on the pools' device")
    lens = kv_len.to(torch.int32).contiguous()
    lib = _build.load("kv_cache", _SIGNATURES)
    dev = k_pages.device
    vec = _vec(k_pages.element_size(), dh, [kn, vn, k_pages, v_pages], [])
    with torch.cuda.device(dev):
        err = lib.kv_append(
            kn.data_ptr(), vn.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pt.data_ptr(), pt.shape[1], lens.data_ptr(), B, Hkv, dh, P, ps,
            k_pages.element_size(), vec, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "kv_append")
    append_kv_.launches += 1


append_kv_.launches = 0


# ---------------------------------------------------------------------------
# the writes with the rotation of q and k


def _check_rope(q, k, v, k_pages, v_pages, page_table, cos, sin):
    """Shapes and types of a rotating write; returns (B, S, H, Hkv, P, ps, dh)."""
    Hkv, P, ps, dh = _check_pools(k_pages, v_pages, k, v, page_table)
    B, S = k.shape[:2]
    if q.dim() != 4 or q.shape[:2] != (B, S) or q.shape[3] != dh:
        raise ValueError(f"q must be (B, S, H, dh) = ({B}, {S}, H, {dh}), got {tuple(q.shape)}")
    if dh % 2:
        raise ValueError(f"the rotation needs an even head dim, got {dh}")
    if cos.shape != (B, S, dh // 2) or sin.shape != cos.shape:
        raise ValueError(f"cos and sin must be ({B}, {S}, {dh // 2}), got "
                         f"{tuple(cos.shape)} and {tuple(sin.shape)}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError("cos and sin must be float32 (rope_tables)")
    if not (q.dtype == k.dtype == v.dtype == k_pages.dtype) or k_pages.dtype not in _ROPE_FMT:
        raise TypeError(f"q, k, v and the pools must share one of {list(_ROPE_FMT)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {k_pages.dtype}")
    dev = k_pages.device
    if any(t.device != dev for t in (v_pages, q, k, v, page_table, cos, sin)):
        raise ValueError("all tensors must be on the pools' device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pools must be on cpu or cuda, got {dev}")
    return B, S, q.shape[2], Hkv, P, ps, dh


def _rope_launch(fn: str, q, k, v, k_pages, v_pages, page_table, cos, sin, outs, kv_len=None):
    """Launch ``kv_rope_write_prompt`` or ``kv_rope_append``: q, k, v at
    their own strides (the projections' outputs, read in place), the tables
    at theirs, ``outs`` allocated by the caller."""
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("pools must be contiguous (they are written in place)")
    if any(t.stride(-1) != 1 for t in (q, k, v, cos, sin)) or cos.stride() != sin.stride():
        raise ValueError("q, k, v, cos and sin need a contiguous last dim, cos and sin one "
                         "stride")
    B, S, H, dh = q.shape
    Hkv, P, ps, _ = k_pages.shape
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *cos.stride()[:2]]
    vec = _vec(q.element_size(), dh // 2, [q, k, v, k_pages, v_pages, *outs], strides[:9])
    if _vec(4, dh // 2, [cos, sin], strides[9:]) == 1:  # the tables' f32 pieces
        vec = 1
    pt = page_table.to(torch.int32).contiguous()
    lib = _build.load("kv_cache", _SIGNATURES)
    dev = k_pages.device
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    ptrs = [t.data_ptr() for t in (q, k, v, *outs, k_pages, v_pages, pt)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kv_len is None:
            err = lib.kv_rope_write_prompt(
                *ptrs, pt.shape[1], cos.data_ptr(), sin.data_ptr(), c_strides, B, S, H, Hkv,
                dh, P, ps, _ROPE_FMT[q.dtype], vec, stream)
        else:
            err = lib.kv_rope_append(
                *ptrs, pt.shape[1], kv_len.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                c_strides, B, H, Hkv, dh, P, ps, _ROPE_FMT[q.dtype], vec, stream)
    _build.check(err, fn)


def pool_spec(rules, H: int, Hkv: int):
    """The spec of a layer's (Hkv, P, ps, dh) pool under ``rules``: KV heads
    over "cache_kv" when q's heads split with them in whole groups."""
    return shf.P(shf.gqa_shard_entries(rules, "act_heads", H, "cache_kv", Hkv)[1],
                 None, None, None)


def place_pools(cfg, cache, rules):
    """A paged cache's stacked (n_periods, Hkv, P, ps, dh) pools placed by
    :func:`pool_spec` (each rank keeps its own heads)."""
    spec = shf.P(None, *pool_spec(rules, cfg.n_heads, cfg.n_kv_heads))
    return [{k: shf.place(t, rules.mesh, spec) for k, t in layer.items()} for layer in cache]


def _sharded_rope_write(rules, body, q, k, v, k_pages, v_pages, page_table, extra, cos, sin,
                        n_out: int):
    """A rotating write per shard (the module docstring): ``body`` on each
    rank's q / k / v head slices and pools, the whole batch."""
    H, Hkv = q.shape[2], k_pages.shape[0]
    pool = pool_spec(rules, H, Hkv)
    h = hk = pool[0]
    want = placements(rules.mesh, pool)
    for t in (k_pages, v_pages):
        if list(t.placements) != want:
            raise ValueError(f"pools placed {list(t.placements)}, the write needs {want}: "
                             "allocate them with kv_cache.pool_spec")
    if page_table.device.type == "cpu":  # the engine checks its host mirrors
        ps = k_pages.shape[2]
        cols = q.shape[1] // ps if extra is None else page_table.shape[1]
        check_targets(page_table[:, :cols], k_pages.shape[1], ps,
                      None if extra is None else extra)
    qs, kvs = shf.P(None, None, h, None), shf.P(None, None, hk, None)
    ops = (q, k, v, k_pages, v_pages, page_table) + (() if extra is None else (extra,)) \
        + (cos, sin)
    specs = (qs, kvs, kvs, pool, pool, shf.P(None, None)) \
        + (() if extra is None else (shf.P(None),)) + (shf.P(None, None, None),) * 2
    return shf.run_sharded(rules, body, ops, specs, (qs, kvs)[:n_out] if n_out > 1 else qs)


def rope_write_prompt_pages_plain(q, k, v, k_pages, v_pages, page_table, cos, sin):
    from repro_torch.models.layers import apply_rope

    q_rot, k_rot = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    write_prompt_pages_plain(k_pages, v_pages, k_rot, v, page_table)
    return q_rot, k_rot


def rope_write_prompt_pages_(q, k, v, k_pages, v_pages, page_table, cos, sin):
    """Rotate a prompt's q and k and write its K/V into the table's pages,
    **in place**: :func:`write_prompt_pages_` of ``apply_rope(k, cos, sin)``
    and ``v``.  q: (B, S, H, dh); k, v: (B, S, Hkv, dh); cos, sin: f32
    (B, S, dh // 2) from ``rope_tables``; one dtype for q, k, v and the
    pools.  Returns (rotated q, rotated k), which the in-flight attention
    reads.  Under a mesh, per shard (the module docstring)."""
    rules = active_mesh_rules()
    if rules is not None:
        return _sharded_rope_write(rules, unruled(rope_write_prompt_pages_), q, k, v, k_pages,
                                   v_pages, page_table, None, cos, sin, 2)
    B, S, H, Hkv, P, ps, dh = _check_rope(q, k, v, k_pages, v_pages, page_table, cos, sin)
    if S % ps:
        raise ValueError(f"prompt length {S} not a multiple of page_size {ps}")
    if page_table.shape[1] < S // ps:
        raise ValueError("page table too narrow for this prompt")
    if k_pages.device.type == "cpu":
        check_targets(page_table[:, :S // ps], P, ps)
        return rope_write_prompt_pages_plain(q, k, v, k_pages, v_pages, page_table, cos, sin)
    q_rot = torch.empty_like(q, memory_format=torch.contiguous_format)
    k_rot = torch.empty_like(k, memory_format=torch.contiguous_format)
    _rope_launch("kv_rope_write_prompt", q, k, v, k_pages, v_pages, page_table, cos, sin,
                 (q_rot, k_rot))
    rope_write_prompt_pages_.launches += 1
    return q_rot, k_rot


rope_write_prompt_pages_.launches = 0


def rope_append_kv_plain(q, k, v, k_pages, v_pages, page_table, kv_len, cos, sin):
    from repro_torch.models.layers import apply_rope

    q_rot, k_rot = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    append_kv_plain(k_pages, v_pages, k_rot, v, page_table, kv_len)
    return q_rot


def rope_append_kv_(q, k, v, k_pages, v_pages, page_table, kv_len, cos, sin):
    """Rotate one decode token's q and k per request and append its K/V,
    **in place**: :func:`append_kv_` of ``apply_rope(k, cos, sin)`` and
    ``v``.  q: (B, 1, H, dh); k, v: (B, 1, Hkv, dh); ``kv_len`` (B,), the
    token's position; cos, sin: f32 (B, 1, dh // 2) from ``rope_tables`` at
    ``kv_len``.  Returns the rotated q.  Under a mesh, per shard (the
    module docstring)."""
    rules = active_mesh_rules()
    if rules is not None:
        return _sharded_rope_write(rules, unruled(rope_append_kv_), q, k, v, k_pages, v_pages,
                                   page_table, kv_len, cos, sin, 1)
    B, S, H, Hkv, P, ps, dh = _check_rope(q, k, v, k_pages, v_pages, page_table, cos, sin)
    if S != 1 or kv_len.shape != (B,):
        raise ValueError("rope_append_kv_ takes one token per request and (B,) kv_len")
    if kv_len.device != k_pages.device:
        raise ValueError("kv_len must be on the pools' device")
    if k_pages.device.type == "cpu":
        check_targets(page_table, P, ps, kv_len)
        return rope_append_kv_plain(q, k, v, k_pages, v_pages, page_table, kv_len, cos, sin)
    q_rot = torch.empty_like(q, memory_format=torch.contiguous_format)
    _rope_launch("kv_rope_append", q, k, v, k_pages, v_pages, page_table, cos, sin, (q_rot,),
                 kv_len=kv_len.to(torch.int32).contiguous())
    rope_append_kv_.launches += 1
    return q_rot


rope_append_kv_.launches = 0


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
