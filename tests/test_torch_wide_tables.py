"""Tables past the CUDA kernels' shared-memory instantiation (more than 64
breakpoints): the host half of the wide instantiation and the plain
versions against the JAX package, which has no cap.

* the search operand (``epilogue.search_operand``): the prefix table, then
  the breakpoints padded with +inf to P - 1 (P the power of two above
  n_bp), and a plain mirror of the wide search (``csrc/pwl_decode.cuh``,
  PwlSearchWide: log2(P) halvings) bitwise the linear chain at every
  breakpoint and its neighbours;
* ``epilogue.kernel_epilogue`` sends a table past 64 breakpoints, and
  nothing else, to the kernels' wide instantiation (kind ``pwl_wide``);
* the plain versions of the GLU, the row softmax, the split-KV decode and
  the standalone kernels against JAX's Pallas kernels (interpret mode) at
  65 and 128 breakpoints, on JAX's uniform tables handed to both.

``test_torch_engine_wide.py`` serves a reduced model under a 129-segment
plan against JAX's tokens.

The CUDA kernels themselves are held against these plain versions on the
card (``chip_smoke.py:wide_table_phase``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sfu as jsfu
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro_torch import sfu
from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels.fused import epilogue as tepi

TOL = dict(atol=1e-5, rtol=1e-5)


def _tables(fn, n_bp):
    """JAX's uniform table of ``fn`` and the same arrays as a port table."""
    jt = jsfu.get_store().get(fn=fn, n_breakpoints=n_bp, fit="uniform")
    tt = PWLTable(*(torch.from_numpy(np.array(a, np.float32)) for a in (jt.bp, jt.m, jt.q)),
                  name=fn)
    return jt, tt


def _wide_search(x, operand, n_bp):
    """Plain mirror of the wide build's search: k = #{i : x > bp_i} by
    log2(P) halvings over the padded breakpoints.  Returns k and row k of
    the prefix table, the chain's (m, q)."""
    mq = operand[: 2 * (n_bp + 1)].reshape(-1, 2)
    bp = operand[2 * (n_bp + 1):]
    k = torch.zeros(x.shape, dtype=torch.long)
    h = tepi.search_pad(n_bp) // 2
    while h:
        k = torch.where(x > bp[k + h - 1], k + h, k)
        h //= 2
    return k, mq[k]


@pytest.mark.parametrize("n_bp", [64, 65, 128, 1024])
def test_search_operand_layout_and_wide_search(n_bp):
    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=n_bp, fit="uniform")
    bp, dmq = tepi.pack_table(table)
    op = tepi.search_operand(bp, dmq)
    P = tepi.search_pad(n_bp)
    assert P & (P - 1) == 0 and P > n_bp >= P // 2
    assert math.ceil(math.log2(n_bp + 1)) == int(math.log2(P))
    assert op.dtype == torch.float32 and op.shape == (2 * (n_bp + 1) + P - 1,)
    assert torch.equal(op[: 2 * (n_bp + 1)], tepi.prefix_table(dmq).reshape(-1))
    pad = op[2 * (n_bp + 1):]
    assert torch.equal(pad[:n_bp], bp[:, 0]) and bool(torch.isposinf(pad[n_bp:]).all())
    assert torch.equal(tepi.prefix_for(bp, dmq).cpu(), op)
    b = bp[:, 0]
    x = torch.cat([b, torch.nextafter(b, torch.full_like(b, math.inf)),
                   torch.nextafter(b, torch.full_like(b, -math.inf)),
                   torch.tensor([-1e30, -1e4, -0.0, 0.0, 1e4, math.inf, -math.inf, math.nan]),
                   torch.linspace(-12, 12, 997)])
    k, mq = _wide_search(x, op, n_bp)
    assert torch.equal(k, (x[:, None] > b[None, :]).sum(dim=1))
    _, want_m = tepi.pwl_value_and_slope(x, bp, dmq, n_bp)
    assert torch.equal(mq[:, 0].view(torch.int32), want_m.view(torch.int32))


@pytest.mark.parametrize("n_bp,wide", [(1, False), (32, False), (64, False), (65, True),
                                       (128, True), (1024, True)])
def test_kernel_epilogue_sends_only_wide_tables_to_the_wide_instantiation(n_bp, wide):
    bp = torch.linspace(-4.0, 4.0, n_bp) if n_bp > 1 else torch.zeros(1)
    dmq = torch.ones(2 * (n_bp + 1))
    plan = tepi.EpiloguePlan(kind="pwl", n_bp=n_bp)
    *_, got_n, kind, fn = tepi.kernel_epilogue(plan, (bp, dmq))
    assert (got_n, fn) == (n_bp, 0) and tepi.is_wide(n_bp) == wide
    assert kind == tepi.KIND_IDS["pwl_wide" if wide else "pwl"]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("n_bp", [65, 128])
def test_glu_plain_matches_jax_kernel(n_bp):
    x, wg, wu = _rand(0, (37, 65), 2.0), _rand(1, (65, 130), 0.3), _rand(2, (65, 130), 0.3)
    jt, tt = _tables("gelu_tanh", n_bp)
    want = np.asarray(jfused.fused_glu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                                       table=jt, block=(16, 128, 64)))
    got = tfused.fused_glu(torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
                           table=tt).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_bp", [65, 128])
@pytest.mark.parametrize("kw", [{}, {"causal": True}], ids=["maskless", "causal"])
def test_softmax_plain_matches_jax_kernel(n_bp, kw):
    jt, tt = _tables("exp", n_bp)
    x = _rand(n_bp, (2, 3, 24, 40), 3.0)
    want = np.asarray(jfused.fused_pwl_softmax(jnp.asarray(x), table=jt, **kw))
    got = tfused.fused_pwl_softmax(torch.from_numpy(x), table=tt, **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_bp", [65, 128])
def test_paged_decode_plain_matches_jax_kernel(n_bp):
    jt, tt = _tables("exp", n_bp)
    rng = np.random.default_rng(n_bp)
    kv_len = np.array([13, 16, 0, 4], np.int32)
    pt = rng.permutation(np.arange(1, 17)).astype(np.int32).reshape(4, 4)
    q = rng.standard_normal((4, 1, 4, 16)).astype(np.float32)
    kp = rng.standard_normal((2, 17, 4, 16)).astype(np.float32)
    vp = rng.standard_normal((2, 17, 4, 16)).astype(np.float32)
    args = (q, kp, vp, pt, kv_len)
    want = np.asarray(jfused.paged_flash_decode(*(jnp.asarray(a) for a in args), table=jt,
                                                pages_per_split=2))
    got = tfused.paged_flash_decode(*(torch.from_numpy(a) for a in args), table=tt,
                                    pages_per_split=2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_bp", [65, 128])
def test_standalone_kernels_plain_match_jax(n_bp):
    jt, tt = _tables("silu", n_bp)
    x = _rand(3, (8, 130), 6.0)
    want = np.asarray(jops.pwl_activation(jnp.asarray(x), jt))
    got = tops.pwl_activation(torch.from_numpy(x), tt).numpy()
    np.testing.assert_allclose(got, want, **TOL)  # XLA contracts m * x + q, the port rounds twice
    lo, hi = float(jt.bp[0]), float(jt.bp[-1])
    want = np.asarray(jops.pwl_activation_uniform(jnp.asarray(x), jt.m, jt.q, lo, hi))
    got = tops.pwl_activation_uniform(torch.from_numpy(x), tt.m, tt.q, lo, hi).numpy()
    np.testing.assert_allclose(got, want, **TOL)
