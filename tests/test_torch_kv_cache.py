"""Port parity: the in-place page writes of ``repro_torch.serving.kv_cache``
against the JAX package's Pallas writes (interpret mode).

Page tables are fragmented by LIFO recycling, one append crosses a page
boundary, and inactive rows point at the sentinel page 0.  The pools must
be bitwise equal on every page except the sentinel, which several writers
may race on and which is never read as valid.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.serving import PageAllocator as JPageAllocator
from repro.serving import append_kv, gather_pages, write_prompt_pages
from repro_torch.serving import kv_cache as tkv

HKV, DH = 3, 8


def _fragmented_rows(alloc, n_requests, pages_each):
    """Interleave allocations across requests, free every other request and
    reallocate, so page ids are non-contiguous and non-monotone per row."""
    rows = [[] for _ in range(n_requests)]
    for _ in range(pages_each):
        for r in rows:
            r.extend(alloc.alloc(1))
    for r in rows[::2]:
        alloc.free(r[::-1])
        r.clear()
    for _ in range(pages_each):
        for r in rows[::2]:
            r.extend(alloc.alloc(1))
    return rows


def test_allocator_is_lifo_and_matches_jax():
    ja, ta = JPageAllocator(12), tkv.PageAllocator(12)
    jr, tr = _fragmented_rows(ja, 3, 3), _fragmented_rows(ta, 3, 3)
    assert jr == tr
    assert ja.num_free == ta.num_free
    assert all(tkv.SENTINEL_PAGE not in r for r in tr)
    with pytest.raises(ValueError):
        ta.free([tkv.SENTINEL_PAGE])
    with pytest.raises(RuntimeError, match="exhausted"):
        ta.alloc(ta.num_free + 1)


def _pools(P, ps, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((HKV, P, ps, DH)).astype(np.float32)
    v = rng.standard_normal((HKV, P, ps, DH)).astype(np.float32)
    return k, v


def _assert_pools_equal_but_sentinel(t_pool, j_pool):
    t = t_pool.numpy()
    j = np.asarray(j_pool)
    np.testing.assert_array_equal(t[:, 1:].view(np.uint32), j[:, 1:].view(np.uint32))


@pytest.mark.parametrize("ps", [4, 16])
def test_write_prompt_pages_matches_jax(ps):
    B, npg, P = 3, 3, 16
    rows = _fragmented_rows(tkv.PageAllocator(P), B, npg)
    table = np.zeros((B, npg + 1), np.int32)  # one spare sentinel column
    for b, r in enumerate(rows):
        table[b, :len(r)] = r
    table[1, 2] = tkv.SENTINEL_PAGE  # a pad page of a shorter prompt
    S = npg * ps
    rng = np.random.default_rng(1)
    kn = rng.standard_normal((B, S, HKV, DH)).astype(np.float32)
    vn = rng.standard_normal((B, S, HKV, DH)).astype(np.float32)
    k, v = _pools(P, ps, 2)
    jk, jv = write_prompt_pages(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn),
                                jnp.asarray(vn), jnp.asarray(table))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out = tkv.write_prompt_pages_(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                                  torch.from_numpy(table))
    assert out is None  # in place
    _assert_pools_equal_but_sentinel(tk, jk)
    _assert_pools_equal_but_sentinel(tv, jv)
    # the written prompt reads back through the table
    dense = tkv.gather_pages(tk, torch.from_numpy(table[:, :npg]))
    np.testing.assert_array_equal(dense[0].numpy(), kn[0])


def test_write_prompt_pages_checks_shapes():
    k = torch.zeros((HKV, 4, 4, DH))
    with pytest.raises(ValueError, match="multiple of page_size"):
        tkv.write_prompt_pages_(k, k.clone(), torch.zeros(1, 6, HKV, DH),
                                torch.zeros(1, 6, HKV, DH), torch.zeros(1, 2, dtype=torch.int32))


@pytest.mark.parametrize("ps", [4, 16])
def test_append_kv_matches_jax(ps):
    B, P = 4, 20
    rows = _fragmented_rows(tkv.PageAllocator(P), 3, 3)
    table = np.zeros((B, 4), np.int32)  # row 3 stays all-sentinel (inactive)
    for b, r in enumerate(rows):
        table[b, :len(r)] = r
    # row 0 appends mid-page, row 1 at a page boundary (first slot of its
    # second page), row 2 at the last slot of a page, row 3 is inactive
    kv_len = np.array([ps + 1, ps, 2 * ps - 1, 0], np.int32)
    rng = np.random.default_rng(3)
    kn = rng.standard_normal((B, 1, HKV, DH)).astype(np.float32)
    vn = rng.standard_normal((B, 1, HKV, DH)).astype(np.float32)
    k, v = _pools(P, ps, 4)
    jk, jv = append_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
                       jnp.asarray(table), jnp.asarray(kv_len))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tkv.append_kv_(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                   torch.from_numpy(table), torch.from_numpy(kv_len))
    _assert_pools_equal_but_sentinel(tk, jk)
    _assert_pools_equal_but_sentinel(tv, jv)
    # exactly one row per active request changed
    changed = (tk.numpy() != k).any(axis=(0, 3))
    assert changed[1:].sum() == 3


def test_append_then_gather_matches_jax_gather():
    ps, P = 4, 10
    rows = _fragmented_rows(tkv.PageAllocator(P), 2, 2)
    table = np.asarray(rows, np.int32)
    k, _ = _pools(P, ps, 5)
    np.testing.assert_array_equal(
        tkv.gather_pages(torch.from_numpy(k), torch.from_numpy(table)).numpy(),
        np.asarray(gather_pages(jnp.asarray(k), jnp.asarray(table))))


def test_bf16_pools_take_new_kv_in_pool_dtype():
    ps, P = 4, 6
    table = torch.tensor([[3, 1]], dtype=torch.int32)
    k = torch.zeros((HKV, P, ps, DH), dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    kn = torch.randn(1, 2 * ps, HKV, DH)
    tkv.write_prompt_pages_(k, v, kn, kn, table)
    back = tkv.gather_pages(k, table)[0]
    torch.testing.assert_close(back, kn[0].to(torch.bfloat16), rtol=0, atol=0)


def test_writes_refuse_other_devices():
    k = torch.empty((HKV, 4, 4, DH), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tkv.append_kv_(k, k, torch.empty((1, 1, HKV, DH), device="meta"),
                       torch.empty((1, 1, HKV, DH), device="meta"),
                       torch.empty((1, 1), dtype=torch.int32, device="meta"),
                       torch.empty((1,), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("case", ["past_the_table", "page_out_of_pool", "negative_len"])
def test_append_outside_the_pools_raises(case):
    ps, P = 4, 6
    table = torch.tensor([[3, 1], [2, 0]], dtype=torch.int32)
    kv_len = torch.tensor([5, 0], dtype=torch.int32)
    if case == "past_the_table":
        kv_len[0] = 2 * ps  # column 2 of a 2-column table
    elif case == "page_out_of_pool":
        table[1, 1] = P
    else:
        kv_len[1] = -1
    k = torch.zeros((HKV, P, ps, DH))
    v = torch.zeros_like(k)
    kn = torch.randn(2, 1, HKV, DH)
    with pytest.raises(ValueError, match="outside"):
        tkv.append_kv_(k, v, kn, kn, table, kv_len)
    assert not k.any() and not v.any()


def test_prompt_write_to_a_page_outside_the_pool_raises():
    ps, P = 4, 6
    k = torch.zeros((HKV, P, ps, DH))
    kn = torch.randn(1, 2 * ps, HKV, DH)
    with pytest.raises(ValueError, match="outside"):
        tkv.write_prompt_pages_(k, k.clone(), kn, kn, torch.tensor([[3, -2]], dtype=torch.int32))
    assert not k.any()
