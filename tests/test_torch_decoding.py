"""Port parity: split-KV flash decoding through a page table
(``repro_torch.kernels.fused.paged_flash_decode``) against the JAX package's
Pallas kernel.

On the CPU the wrapper takes its plain version (the kernels' page chain in
a Python loop); the JAX side runs its Pallas kernel in interpret mode.
Page tables are fragmented by ``PageAllocator``'s LIFO reuse.  Tolerance
1e-5 abs/rel in f32 (the JAX suite's bound for this kernel).

The split chain as the CUDA kernel computes it (page maxima, a prefix max,
every page's p, corr, sum and p . v, then the serial recurrence) is held
bitwise against the plain page chain on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro.kernels.fused import decoding as jdec
from repro.kernels.fused import epilogue as jepi
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import epilogue as tepi
from repro_torch.kernels.fused.decoding import merge_split_partials, paged_flash_decode_plain
from repro_torch.kernels.fused.softmax import NEG_FILL, pwl_exp
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


def _split_chain_by_stages(q, k_pages, v_pages, page_table, kv_len, plan, tables, pps):
    """The plain page chain decomposed as ``csrc/decoding.cu``'s split kernel
    computes it: (1) every page's scores and maximum; (2) the running
    maximum after each page as a prefix max over the split's live pages from
    -1e30; (3) every page's p = exp(s - m_page), corr = exp(m_before -
    m_page), sum(p) and p . v; (4) only then the serial recurrence l = l *
    corr + sum(p), acc = acc * corr + p . v, a page past kv_len taking no
    step.  Each page's tensors have the plain chain's shapes, so its
    reductions are the same operations."""
    B, _, H, dh = q.shape
    Hkv, _, ps, _ = k_pages.shape
    G = H // Hkv
    n_cols = page_table.shape[1]
    ns = -(-n_cols // pps)
    pt = torch.zeros((B, ns * pps), dtype=torch.long)
    pt[:, :n_cols] = page_table.long()
    pt = pt.reshape(B, ns, pps)
    kvl = kv_len.long()
    qf = q.float().reshape(B, Hkv, G, dh)
    scale = 1.0 / np.sqrt(dh)
    page0 = (torch.arange(ns)[:, None] * pps + torch.arange(pps)[None, :]) * ps  # (ns, pps)
    live = page0[None] < kvl[:, None, None]                                   # (B, ns, pps)
    kpos = page0[..., None] + torch.arange(ps)                                # (ns, pps, ps)
    keep = (kpos[None] < kvl[:, None, None, None])[:, None, :, :, None, :]    # (B,1,ns,pps,1,ps)
    # 1. scores and page maxima
    sc = torch.stack([torch.einsum("bhgd,hbskd->bhsgk", qf, k_pages[:, pt[:, :, p]].float())
                      * scale for p in range(pps)], dim=3)                     # (B,Hkv,ns,pps,G,ps)
    sc = torch.where(keep, sc, NEG_FILL)
    mx = torch.where(live[:, None, :, :, None], sc.amax(dim=-1), -torch.inf)
    # 2. the running maximum, a prefix max
    m = torch.clamp(torch.cummax(mx, dim=3).values, min=NEG_FILL)             # (B,Hkv,ns,pps,G)
    m_before = torch.cat([torch.full_like(m[:, :, :, :1], NEG_FILL), m[:, :, :, :-1]], dim=3)
    # 3. every page's p, corr, sum(p) and p . v
    pr = pwl_exp(sc - m[..., None], plan, tables) * keep.float()
    corr = pwl_exp(m_before - m, plan, tables)
    sums = [pr[:, :, :, p].contiguous().sum(dim=-1) for p in range(pps)]
    pvs = [torch.einsum("bhsgk,hbskd->bhsgd", pr[:, :, :, p].contiguous(),
                        v_pages[:, pt[:, :, p]].float()) for p in range(pps)]
    # 4. the recurrence
    l = torch.zeros((B, Hkv, ns, G))
    acc = torch.zeros((B, Hkv, ns, G, dh))
    for p in range(pps):
        step = live[:, None, :, p, None]
        c = corr[:, :, :, p]
        l = torch.where(step, l * c + sums[p], l)
        acc = torch.where(step[..., None], acc * c[..., None] + pvs[p], acc)
    out = merge_split_partials(m[:, :, :, -1], l, acc, plan, tables)
    return out.reshape(B, 1, H, dh)


@st.composite
def _decode_case(draw):
    G = draw(st.sampled_from([1, 2, 4]))
    dh = draw(st.sampled_from([64, 256]))
    Hkv = draw(st.integers(1, 2))
    ps = draw(st.sampled_from([2, 4, 8]))
    n_cols = draw(st.integers(1, 7))
    kv_len = draw(st.lists(st.integers(0, n_cols * ps), min_size=1, max_size=3))
    kv_len[draw(st.integers(0, len(kv_len) - 1))] = draw(st.sampled_from([0, n_cols * ps]))
    pps = draw(st.integers(1, n_cols + 1))
    num_pages = len(kv_len) * n_cols + 1
    order = draw(st.permutations(range(1, num_pages)))  # fragmented: any page order
    pt = np.asarray(order, np.int32).reshape(len(kv_len), n_cols)
    return G, dh, Hkv, ps, pt, np.asarray(kv_len, np.int32), num_pages, pps, draw(
        st.integers(0, 2**31 - 1)), draw(st.sampled_from(["table", "exact"]))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(_decode_case())
def test_split_chain_by_stages_is_bitwise_the_page_chain(case):
    """What the split kernel's design rests on: computing all of a chunk's
    scores, page maxima, running maxima, p, corr, sums and p . v before the
    serial recurrence keeps every f32 operation of the page chain, so the
    output is bitwise the plain chain's (f32; hypothesis-drawn fragmented
    page tables, kv_len 0 and full, G 1/2/4, dh 64/256, pages_per_split)."""
    G, dh, Hkv, ps, pt, kv_len, num_pages, pps, seed, kind = case
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((len(kv_len), 1, Hkv * G, dh), dtype=np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((Hkv, num_pages, ps, dh), dtype=np.float32))
              for _ in range(2))
    if kind == "table":
        plan, tables = tepi.plan_and_operands(_tables()[1])
    else:
        plan, tables = tepi.plan_and_operands(None, act="exp")
    args = (q, kp, vp, torch.from_numpy(pt), torch.from_numpy(kv_len), plan, tables, pps)
    want = paged_flash_decode_plain(*args)
    got = _split_chain_by_stages(*args)
    assert torch.equal(got, want)
    assert not got[torch.from_numpy(kv_len == 0)].any()  # kv_len 0: exact zeros
