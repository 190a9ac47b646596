"""The kernels' search decodes against the linear delta chain, on the CPU.

The bf16 flash kernels (``csrc/attention.cu``, ``csrc/attention_bwd.cu``)
find a score's segment by a branch-free binary search over the breakpoints,
padded with +inf to 128 (``csrc/pwl_decode.cuh:pwl_search_value_and_slope``:
two steps on pivots held in registers, five in shared memory), and read its
(m, q) from a prefix table the host builds
(``kernels/fused/epilogue.py:prefix_table``).  ``_search`` below mirrors
those steps in plain PyTorch; every case holds it bitwise, value and slope,
to the linear chain the other kernels run (``EpiloguePlan.apply_value_and_slope``
on the same f32 delta-layout operands), over every table the port ships in
each storage format (bf16, f16 and int8 tables reach the kernels packed into
the f32 delta layout), on every breakpoint, its neighbours either way, ±0,
±inf, NaN, the chain's -1e4 clamp and the -1e30 mask fill.  Both sides form
the value as ``m * x + q`` rounded apart (on the card both fuse it into one
fmaf), so equal (m, q) give equal values.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import sfu
from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import attention as tattn
from repro_torch.kernels.fused import softmax as tsoftmax
from repro_torch.kernels.fused.epilogue import (
    EpiloguePlan,
    pack_table,
    plan_and_operands,
    prefix_table,
    search_prefix,
)
from repro_torch.kernels.fused.glu import fused_glu_bwd, fused_glu_bwd_plain, fused_glu_plain
from repro_torch.kernels.fused.linear import (
    fused_linear_bwd,
    fused_linear_bwd_plain,
    fused_linear_plain,
)
from repro_torch.kernels.fused.norm import (
    fused_rmsnorm_bwd,
    fused_rmsnorm_bwd_plain,
    fused_rmsnorm_plain,
)

PAD = 128  # PWL_SEARCH_PAD: the padded breakpoints
TABLE_DIR = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/core/tables"
SHIPPED = sorted(p.stem.rsplit("_", 1) for p in TABLE_DIR.glob("*.npz"))
FORMATS = ("f32", "bf16", "f16", "int8")


def _search(x, bp, prefix):
    """The kernel's search: k = #{i : x > bp_i} in seven steps over the
    breakpoints padded with +inf (the first two against bp[63], then bp[31]
    or bp[95]), then (m, q) = prefix[k]."""
    padded = torch.full((PAD,), float("inf"), dtype=torch.float32)
    padded[:bp.numel()] = bp.reshape(-1)
    k = torch.where(x > padded[63], 64, 0)
    k = k + torch.where(x > torch.where(k > 0, padded[95], padded[31]), 32, 0)
    for h in (16, 8, 4, 2, 1):
        k = k + torch.where(x > padded[k + h - 1], h, 0)
    m, q = prefix[k, 0], prefix[k, 1]
    return m * x + q, m


def _edge_inputs(bp):
    """Every breakpoint, nextafter of each both ways, and the special values."""
    b = bp.reshape(-1).to(torch.float32)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), -1e4, -1e30,
                            1e30, 1e4], dtype=torch.float32)
    return torch.cat([b, torch.nextafter(b, torch.full_like(b, float("inf"))),
                      torch.nextafter(b, torch.full_like(b, float("-inf"))), special,
                      torch.linspace(float(b.min()) - 4, float(b.max()) + 4, 2001)])


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bitwise(got, want, what):
    for g, w, name in zip(got, want, ("value", "slope")):
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan), f"{what}: {name} NaN pattern differs"
        bad = (_bits(g) != _bits(w)) & ~nan
        assert not bool(bad.any()), (
            f"{what}: {name} differs on {int(bad.sum())} inputs, first got "
            f"{g[bad][:3].tolist()} want {w[bad][:3].tolist()}")


def _chain(x, bp, dmq):
    return EpiloguePlan("pwl", int(bp.shape[0])).apply_value_and_slope(x, bp, dmq)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("fn,n", SHIPPED, ids=["_".join(s) for s in SHIPPED])
def test_search_matches_linear_chain_on_shipped_tables(fn, n, fmt):
    table = sfu.get_store().get(fn=fn, n_breakpoints=int(n.removesuffix("bp")), dtype=fmt)
    bp, dmq = pack_table(table, native=False)  # the layout the kernels read
    assert bp.dtype == dmq.dtype == torch.float32
    x = _edge_inputs(bp)
    _assert_bitwise(_search(x, bp, prefix_table(dmq)), _chain(x, bp, dmq), f"{fn} {n} {fmt}")


def _delta_table(m, q, bp):
    """f32 delta-layout operands straight from (m_i, q_i) rows and breakpoints."""
    m = torch.tensor(m, dtype=torch.float32)
    q = torch.tensor(q, dtype=torch.float32)
    dmq = torch.empty((m.numel(), 2), dtype=torch.float32)
    dmq[0, 0], dmq[0, 1] = m[0], q[0]
    dmq[1:, 0], dmq[1:, 1] = m[1:] - m[:-1], q[1:] - q[:-1]
    return torch.tensor(bp, dtype=torch.float32).reshape(-1, 1), dmq


@pytest.mark.parametrize("dmq_rows", [
    # (m_0, q_0), then deltas: a -0 start followed by a -0 delta and a
    # positive one, so the chain's 0 * delta adds turn -0 into +0
    [(-0.0, -0.0), (-0.0, -0.0), (1.0, 0.5)],
    [(-0.0, 0.0), (0.0, -0.0), (-0.0, 1.0), (2.0, -0.0)],
    [(0.0, -0.0), (-0.0, -0.0), (-0.0, -0.0)],
    [(-0.0, -0.0), (-0.0, -0.0), (-0.0, -0.0)],
], ids=["neg-zero-then-positive", "mixed-zeros", "pos-zero-neg-deltas", "all-neg-zero"])
def test_search_keeps_the_sign_of_zero(dmq_rows):
    dmq = torch.tensor(dmq_rows, dtype=torch.float32)
    bp = torch.arange(dmq.shape[0] - 1, dtype=torch.float32).reshape(-1, 1) - 0.5
    x = torch.cat([_edge_inputs(bp), torch.tensor([-0.0, 0.0])])
    _assert_bitwise(_search(x, bp, prefix_table(dmq)), _chain(x, bp, dmq), "signed zeros")


def test_plain_partial_sums_alone_would_lose_the_zero_sign():
    """The 0 * delta adds of prefix_table are needed: the partial sums alone
    give -0 where the chain gives +0."""
    dmq = torch.tensor([(-0.0, -0.0), (-0.0, -0.0), (1.0, 0.5)], dtype=torch.float32)
    bp = torch.tensor([[-0.5], [0.5]])
    naive = dmq.clone()  # the partial sums without those adds
    for i in range(1, naive.shape[0]):
        naive[i] = naive[i - 1] + dmq[i]
    x = torch.tensor([-1.0])
    _, slope_chain = _chain(x, bp, dmq)
    assert _bits(slope_chain).item() == 0  # +0
    assert _bits(naive[0:1, 0]).item() != 0  # -0
    _, slope = _search(x, bp, prefix_table(dmq))
    assert torch.equal(_bits(slope), _bits(slope_chain))


@pytest.mark.parametrize("seed", range(4))
def test_search_matches_linear_chain_on_random_tables(seed):
    """Random ascending tables of 1..64 breakpoints, ties between breakpoints
    included, on random inputs around them."""
    rng = np.random.default_rng(seed)
    for n in (1, 2, 7, 31, 32, 33, 63, 64):
        bp = np.sort(rng.normal(size=n).astype(np.float32))
        if n > 2:
            bp[n // 2] = bp[n // 2 - 1]  # a repeated breakpoint
        bpt, dmq = _delta_table(rng.normal(size=n + 1), rng.normal(size=n + 1), bp)
        x = torch.cat([_edge_inputs(bpt),
                       torch.from_numpy(rng.normal(size=500).astype(np.float32))])
        _assert_bitwise(_search(x, bpt, prefix_table(dmq)), _chain(x, bpt, dmq),
                        f"seed {seed} n {n}")


def test_prefix_rows_are_the_chain_at_each_segment():
    table = sfu.get_store().get(fn="exp", n_breakpoints=32)
    bp, dmq = pack_table(table, native=False)
    pre = prefix_table(dmq)
    assert pre.shape == dmq.shape and pre.dtype == torch.float32
    # just above breakpoint k-1 and at (not above) breakpoint k: segment k
    b = bp.reshape(-1)
    xs = torch.cat([b[:1] - 1, torch.nextafter(b, torch.full_like(b, float("inf")))])
    _, slope = _chain(xs, bp, dmq)
    assert torch.equal(_bits(slope), _bits(pre[:, 0]))


def _descending():
    t = sfu.get_store().get(fn="exp", n_breakpoints=8)
    return PWLTable(bp=t.bp.flip(0), m=t.m, q=t.q, name="exp descending")


@pytest.mark.parametrize("bad", ["descending", "nan"])
def test_search_prefix_refuses_unsorted_breakpoints(bad):
    t = sfu.get_store().get(fn="exp", n_breakpoints=8)
    bp, dmq = pack_table(t, native=False)
    bp = bp.flip(0).contiguous() if bad == "descending" else bp.clone()
    if bad == "nan":
        bp[3, 0] = float("nan")
    with pytest.raises(ValueError, match="ascending"):
        search_prefix(EpiloguePlan("pwl", int(bp.shape[0])), (bp, dmq.clone()))


def test_flash_wrappers_refuse_descending_breakpoints():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
               for _ in range(3))
    table = _descending()
    with pytest.raises(ValueError, match="ascending"):
        tattn.fused_flash_attention(q, k, v, table=table)
    bp, dmq = pack_table(table)
    plan = EpiloguePlan("pwl", int(bp.shape[0]))
    m = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="ascending"):
        tattn.fused_flash_attention_bwd(q, k, v, q, m, plan, (bp, dmq), causal=True, window=None,
                                        q_offset=0, kv_valid_len=None)


def test_flash_wrappers_take_sorted_tables():
    """The check passes the shipped (ascending) table: the CPU forward runs."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
               for _ in range(3))
    out = tattn.fused_flash_attention(q, k, v, table=sfu.get_store().get(fn="exp",
                                                                          n_breakpoints=8))
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


# The GLU family's bf16 kernel (csrc/glu.cu), the row softmax forward and
# backward (csrc/softmax.cu) and the fused RMSNorm forward and backward
# (csrc/norm.cu) decode by the same search, so their wrappers refuse unsorted
# breakpoints too, on the CPU as on the card.  "fused_rmsnorm" is the op
# under autograd with impl_bwd="fused" (its output and both gradients),
# "fused_rmsnorm_bwd" the backward wrapper alone.
GLU_FAMILY = ("fused_glu", "fused_glu_bwd", "fused_moe_glu", "fused_linear", "fused_linear_bwd",
              "fused_pwl_softmax", "fused_pwl_softmax_bwd", "fused_rmsnorm", "fused_rmsnorm_bwd")


def _glu_family(wrapper, table):
    """``wrapper`` on small CPU operands (two experts for the MoE GLU; 5
    causal rows of 16 scores for the row softmax; 5 rows of 16 for the
    RMSNorm) with ``table``, and its plain version on the table's packed
    operands."""
    rng = np.random.default_rng(3)
    x, wg, wu = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((2, 5, 16), (2, 16, 8), (2, 16, 8)))
    g = torch.from_numpy(rng.normal(size=(2, 5, 8)).astype(np.float32))
    b = wu[0, 0]
    plan, tabs = plan_and_operands(table)
    causal = tsoftmax.static_mask(5, 16, 5, True, None)
    if wrapper == "fused_pwl_softmax":
        return (tfused.fused_pwl_softmax(x[0], table=table, causal=True),
                tsoftmax.fused_pwl_softmax_plain(x[0], causal, plan, tabs))
    if wrapper == "fused_pwl_softmax_bwd":
        return (tsoftmax.fused_pwl_softmax_bwd(x[0], None, x[1], plan, tabs, 5, True),
                tsoftmax.fused_pwl_softmax_bwd_plain(x[0], causal, x[1], plan, tabs))
    if wrapper.startswith("fused_rmsnorm"):
        s, g = x[1, 0] * 0.3, x[1]
        dx, ds = fused_rmsnorm_bwd_plain(x[0], s, g, plan, tabs, 1e-6)
        if wrapper == "fused_rmsnorm_bwd":
            got = fused_rmsnorm_bwd(x[0], s, g, plan, tabs)
            return torch.cat([got[0].ravel(), got[1]]), torch.cat([dx.ravel(), ds])
        xr, sr = x[0].clone().requires_grad_(True), s.clone().requires_grad_(True)
        y = tfused.fused_rmsnorm(xr, sr, table=table, impl_bwd="fused")
        y.backward(g)
        return (torch.cat([y.detach().ravel(), xr.grad.ravel(), sr.grad]),
                torch.cat([fused_rmsnorm_plain(x[0], s, plan, tabs, 1e-6).ravel(), dx.ravel(),
                           ds]))
    if wrapper == "fused_glu":
        return (tfused.fused_glu(x[0], wg[0], wu[0], table=table),
                fused_glu_plain(x[0], wg[0], wu[0], plan, tabs))
    if wrapper == "fused_moe_glu":
        return (tfused.fused_moe_glu(x, wg, wu, table=table),
                fused_glu_plain(x, wg, wu, plan, tabs))
    if wrapper == "fused_glu_bwd":
        return (torch.cat(fused_glu_bwd(x[0], wg[0], wu[0], g[0], plan, tabs)),
                torch.cat(fused_glu_bwd_plain(x[0], wg[0], wu[0], g[0], plan, tabs)))
    if wrapper == "fused_linear":
        return (tfused.fused_linear(x[0], wg[0], b, table=table),
                fused_linear_plain(x[0], wg[0], b, plan, tabs))
    return (fused_linear_bwd(x[0], wg[0], b, g[0], plan, tabs),
            fused_linear_bwd_plain(x[0], wg[0], b, g[0], plan, tabs))


@pytest.mark.parametrize("bad", ["descending", "nan"])
@pytest.mark.parametrize("wrapper", GLU_FAMILY)
def test_glu_family_wrappers_refuse_unsorted_breakpoints(wrapper, bad):
    t = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=8)
    bp = t.bp.flip(0) if bad == "descending" else t.bp.clone()
    if bad == "nan":
        bp[3] = float("nan")
    table = PWLTable(bp=bp, m=t.m, q=t.q, name=f"gelu_tanh {bad}")
    with pytest.raises(ValueError, match="ascending"):
        _glu_family(wrapper, table)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("wrapper", GLU_FAMILY)
def test_glu_family_wrappers_take_shipped_tables(wrapper, fmt):
    """The check passes the shipped (ascending) tables of every format: each
    wrapper runs on the CPU and gives its plain version's output (silu's
    table; exp's for the row softmax, whose rows silu would zero)."""
    fn = "exp" if "softmax" in wrapper else "silu"
    got, want = _glu_family(wrapper, sfu.get_store().get(fn=fn, n_breakpoints=32, dtype=fmt))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
