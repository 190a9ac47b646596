"""Port parity: split-KV flash decoding through a page table
(``repro_torch.kernels.fused.paged_flash_decode``) against the JAX package's
Pallas kernel.

On the CPU the wrapper takes its plain version (the kernels' page chain in
a Python loop); the JAX side runs its Pallas kernel in interpret mode.
Page tables are fragmented by ``PageAllocator``'s LIFO reuse.  Tolerance
1e-5 abs/rel in f32 (the JAX suite's bound for this kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro.kernels.fused import decoding as jdec
from repro.kernels.fused import epilogue as jepi
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import epilogue as tepi
from repro_torch.serving import PageAllocator

TOL = dict(atol=1e-5, rtol=1e-5)


def _tables(n_bp=32, fmt="f32"):
    return (sfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt),
            tsfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt))


def _fragmented_table(kv_len, ps, num_pages, n_cols):
    """One row of pages per request, handed out by a LIFO allocator after
    half of an earlier allocation was freed, so pages are out of order and
    rows interleave."""
    alloc = PageAllocator(num_pages)
    warm = [alloc.alloc(2) for _ in range(3)]
    for w in warm[::2]:
        alloc.free(w[::-1])
    pt = np.zeros((len(kv_len), n_cols), np.int32)
    for b, n in enumerate(kv_len):
        pages = alloc.alloc(-(-int(n) // ps))
        pt[b, :len(pages)] = pages
    return pt


def _case(seed, kv_len, G, ps=4, Hkv=2, dh=16, num_pages=48, n_cols=None):
    rng = np.random.default_rng(seed)
    kv_len = np.asarray(kv_len, np.int32)
    n_cols = n_cols or max(1, -(-int(kv_len.max()) // ps))
    pt = _fragmented_table(kv_len, ps, num_pages, n_cols)
    q = rng.standard_normal((len(kv_len), 1, Hkv * G, dh)).astype(np.float32)
    kp = rng.standard_normal((Hkv, num_pages, ps, dh)).astype(np.float32)
    vp = rng.standard_normal((Hkv, num_pages, ps, dh)).astype(np.float32)
    return q, kp, vp, pt, kv_len


def _both(args, jt, tt, **kw):
    want = np.asarray(jfused.paged_flash_decode(*(jnp.asarray(a) for a in args), table=jt, **kw))
    got = tfused.paged_flash_decode(*(torch.from_numpy(a) for a in args), table=tt, **kw)
    return got, want


# kv_len per request: ragged, page-aligned, inactive (0), one page
LENS = [19, 32, 0, 4]


@pytest.mark.parametrize("pps", [None, 2, 3])
@pytest.mark.parametrize("G", [1, 2])
def test_paged_decode_plain_matches_jax_kernel(G, pps):
    jt, tt = _tables()
    args = _case(G * 10 + (pps or 0), LENS, G)
    got, want = _both(args, jt, tt, pages_per_split=pps)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any()  # kv_len == 0 gives exact zeros


@pytest.mark.parametrize("fmt", ["f32", "int8"])
@pytest.mark.parametrize("n_bp", [16, 64])
def test_paged_decode_table_formats(n_bp, fmt):
    jt, tt = _tables(n_bp, fmt)
    args = _case(n_bp, [13, 28, 8], 2)
    got, want = _both(args, jt, tt, pages_per_split=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_decode_wide_table_and_bf16_pools():
    """Table columns past the live pages (sentinel padding of the engine's
    pow2 buckets) and bf16 pools, which both sides widen to f32."""
    jt, tt = _tables()
    q, kp, vp, pt, kv_len = _case(7, [21, 9], 2, n_cols=8)
    kp16 = torch.from_numpy(kp).to(torch.bfloat16)
    vp16 = torch.from_numpy(vp).to(torch.bfloat16)
    want = np.asarray(jfused.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(vp16.float().numpy()).astype(jnp.bfloat16), jnp.asarray(pt),
        jnp.asarray(kv_len), table=jt, pages_per_split=3))
    got = tfused.paged_flash_decode(torch.from_numpy(q), kp16, vp16, torch.from_numpy(pt),
                                    torch.from_numpy(kv_len), table=tt, pages_per_split=3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_decode_exact_exp():
    args = _case(8, LENS, 2)
    want = np.asarray(jfused.paged_flash_decode(*(jnp.asarray(a) for a in args),
                                                pages_per_split=2))
    got = tfused.paged_flash_decode(*(torch.from_numpy(a) for a in args), pages_per_split=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_merge_split_partials_matches_jax():
    jt, tt = _tables()
    rng = np.random.default_rng(9)
    m = (rng.standard_normal((3, 4, 2)) * 4).astype(np.float32)
    m[0, 1] = -1e30  # an empty split
    l_ = rng.random((3, 4, 2)).astype(np.float32)
    l_[0, 1] = 0.0
    acc = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    acc[0, 1] = 0.0
    jplan, jtab = jepi.plan_and_operands(jt)
    tplan, ttab = tepi.plan_and_operands(tt)
    want = np.asarray(jdec.merge_split_partials(jnp.asarray(m), jnp.asarray(l_),
                                                jnp.asarray(acc), jplan, jtab))
    got = tfused.merge_split_partials(torch.from_numpy(m), torch.from_numpy(l_),
                                      torch.from_numpy(acc), tplan, ttab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_decode_refuses_a_prompt():
    _, tt = _tables()
    q = torch.zeros(1, 2, 2, 16)
    pools = torch.zeros(2, 4, 4, 16)
    with pytest.raises(ValueError, match="single-token"):
        tfused.paged_flash_decode(q, pools, pools, torch.zeros(1, 1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32), table=tt)
