"""Port parity: the fused GLU's backward (``repro_torch.kernels.fused.glu``)
against the JAX package.

* ``fused_glu_bwd_plain`` (the plain version of the CUDA backward kernel)
  against the JAX backward kernel ``_glu_dz_2d`` in interpret mode, on the
  integer grids and small blocks of ``tests/test_fused_backward.py``: every
  f32 partial sum is exact there, so both sides decode the same
  pre-activation.  Tolerance 1e-6 of each output's max (the JAX suite's
  bound for this op; the value ``m·x + q`` may round differently).
* The port's autograd ``(dx, dWg, dWu)`` against ``jax.grad`` of
  ``fused_glu(impl_bwd="fused")`` with the JAX suite's cos-sum loss, at
  rel 1e-6 of each gradient's max, for the four table formats.
* ``impl_bwd`` selection, and the slope of a pre-activation that lies
  exactly on a breakpoint (the left segment's), bitwise.
* The order band of ``chip_smoke.py``'s backward checks: the plain
  backward in four summation orders of the pre-activation (sequential K,
  reversed K, 16-wide chunks as the tensor cores sum them, and
  ``torch.matmul``), on hypothesis-drawn inputs aimed at the breakpoints.
  Wherever two orders decode different slopes, the ``torch.matmul``
  pre-activation lies within ``ORDER_BAND_C·(K+1)·2⁻²⁴·(|x|@|w| + |b|)`` of
  a breakpoint, so the band the card holds the kernels to is wide enough.
"""
import itertools

import jax
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
from repro.kernels.fused import epilogue as jepi
from repro.kernels.fused.glu import _glu_dz_2d
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import backward as tbackward
from repro_torch.kernels.fused.epilogue import plan_and_operands
from repro_torch.kernels.fused.glu import fused_glu_bwd_plain

BLK = (16, 32, 16)  # the JAX suite's blocks: every grid axis takes several steps
TABLE_DTYPES = ["f32", "bf16", "f16", "int8"]


def _igrid(seed, shape, span=16, step=0.125):
    """Integer-grid reals (exact under blocked f32 sums), from numpy."""
    ints = np.random.default_rng(seed).integers(-span, span + 1, size=shape)
    return (ints * step).astype(np.float32)


def _tables(fn, n_bp, fmt):
    return (sfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt),
            tsfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt))


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=rel,
                               err_msg=what)


@pytest.mark.parametrize("fmt", ["f32", "int8"])
@pytest.mark.parametrize("shape", [(37, 33, 24), (19, 65, 130)])
def test_bwd_plain_matches_jax_backward_kernel(shape, fmt):
    M, K, N = shape
    jt, tt = _tables("gelu_tanh", 32, fmt)
    x, wg, wu = _igrid(0, (M, K)), _igrid(1, (K, N), span=4), _igrid(2, (K, N), span=4)
    g = _igrid(3, (M, N), span=8)
    jplan, jtabs = jepi.plan_and_operands(jt)
    want = _glu_dz_2d(*(jnp.asarray(a) for a in (x, wg, wu, g)), jtabs, plan=jplan,
                      block=BLK, interpret=True)
    plan, tabs = plan_and_operands(tt)
    got = fused_glu_bwd_plain(*(torch.from_numpy(a) for a in (x, wg, wu, g)), plan, tabs)
    for name, a, b in zip(("dzg", "dzu"), got, want):
        assert a.dtype == torch.float32 and a.shape == (M, N)
        _close(a.numpy(), b, 1e-6, name)


def _jax_grads(table, x, wg, wu):
    def loss(x, wg, wu):
        y = jfused.fused_glu(x, wg, wu, table=table, block=BLK, impl_bwd="fused")
        return jnp.sum(jnp.cos(y.astype(jnp.float32)))

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, wg, wu)))


def _torch_grads(table, x, wg, wu, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, wg, wu)]
    torch.cos(tfused.fused_glu(*ts, table=table, **kw).float()).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("fmt", TABLE_DTYPES)
@pytest.mark.parametrize("fn", ["silu", "gelu_tanh"])
def test_autograd_matches_jax_grad(fn, fmt):
    jt, tt = _tables(fn, 32, fmt)
    x = _igrid(0, (2, 19, 33))  # leading dims
    wg, wu = _igrid(1, (33, 24), span=4), _igrid(2, (33, 24), span=4)
    want = _jax_grads(jt, x, wg, wu)
    got = _torch_grads(tt, x, wg, wu)
    for name, a, b in zip(("dx", "dWg", "dWu"), got, want):
        assert a.shape == b.shape
        _close(a.numpy(), b, 1e-6, name)


def test_fused_and_recompute_backwards_agree():
    """On the CPU both modes take the plain math; the selector must reach
    the op per call and through the scoped default alike."""
    _, tt = _tables("gelu_tanh", 32, "f32")
    x, wg, wu = _igrid(4, (21, 40)), _igrid(5, (40, 30), span=4), _igrid(6, (40, 30), span=4)
    fused = _torch_grads(tt, x, wg, wu, impl_bwd="fused")
    recompute = _torch_grads(tt, x, wg, wu, impl_bwd="recompute")
    with tbackward.use_impl_bwd("recompute"):
        assert tbackward.resolve_impl_bwd(None) == "recompute"
        scoped = _torch_grads(tt, x, wg, wu)
    assert tbackward.current_impl_bwd() == "fused"
    for a, b, c in zip(fused, recompute, scoped):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl_bwd"):
        tbackward.resolve_impl_bwd("pallas")


@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_slope_on_breakpoints_is_bitwise(fmt):
    """zg lands exactly on every breakpoint (x = 1, one row of Wg = the
    breakpoints, Wu = g = 1), so dzg is the decoded slope itself: the left
    segment's, bitwise the JAX backward kernel's."""
    jt, tt = _tables("gelu_tanh", 16, fmt)
    plan, tabs = plan_and_operands(tt)
    bp = tabs[0][:, 0].clone()
    N = bp.shape[0]
    x = torch.ones((3, 1))
    wg = bp[None, :].clone()
    wu = torch.ones((1, N))
    g = torch.ones((3, N))
    dzg, dzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tabs)
    jplan, jtabs = jepi.plan_and_operands(jt)
    jdzg, _ = _glu_dz_2d(*(jnp.asarray(a.numpy()) for a in (x, wg, wu, g)), jtabs,
                         plan=jplan, block=BLK, interpret=True)
    np.testing.assert_array_equal(dzg.numpy().view(np.uint32),
                                  np.asarray(jdzg).view(np.uint32))
    m = tt.m.to(torch.float32) if fmt == "f32" else None
    if m is not None:  # on bp_i the slope is segment i's (the one ending at bp_i)
        torch.testing.assert_close(dzg[0], m[:-1], rtol=0, atol=0)


ORDER_BAND_C = 4  # chip_smoke.ORDER_BAND_C
ORDERS = ("sequential", "reversed", "chunks16", "matmul")


def _z_in_order(x, w, order):
    """``x @ w`` in f32 with the sum over K taken in ``order``: one product
    and one add rounded at a time (from k = 0, or from k = K - 1), 16-wide
    chunks from 0 added one after another, or one ``torch.matmul``."""
    if order == "matmul":
        return x @ w
    K = x.shape[1]
    acc = torch.zeros(x.shape[0], w.shape[1])
    if order == "chunks16":
        for k0 in range(0, K, 16):
            acc = acc + x[:, k0:k0 + 16] @ w[k0:k0 + 16]
        return acc
    for k in (range(K) if order == "sequential" else reversed(range(K))):
        acc = acc + x[:, k:k + 1] * w[k:k + 1]
    return acc


def _aimed(rng, M, K, N, bp, bias):
    """Normal x (M, K) and w (K, N) /sqrt(K) whose last row is chosen so
    that the exact pre-activation of row j % M, column j lands on breakpoint
    j % n_bp (x's last column is 1): every order then rounds it to either
    side of that breakpoint."""
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    x[:, K - 1] = 1.0
    for j in range(N):
        i = j % M
        part = float(x[i, :K - 1].astype(np.float64) @ w[:K - 1, j].astype(np.float64))
        w[K - 1, j] = np.float32(bp[j % len(bp)] - part - (0.0 if bias is None else bias[j]))
    return torch.from_numpy(x), torch.from_numpy(w)


def _check_order_band(fn, seed, M, K, N, with_bias):
    """The slopes of four summation orders disagree only within the order
    band; returns the number of disagreeing elements."""
    table = tsfu.get_store().get(fn=fn, n_breakpoints=32)
    plan, tabs = plan_and_operands(table)
    bp = tabs[0].reshape(-1).double().numpy()
    rng = np.random.default_rng(seed)
    bias = (rng.normal(size=N) * 0.1).astype(np.float32) if with_bias else None
    x, w = _aimed(rng, M, K, N, bp, bias)
    b = None if bias is None else torch.from_numpy(bias)
    slopes = {}
    for order in ORDERS:
        z = _z_in_order(x, w, order)
        if b is not None:
            z = z + b
        slopes[order] = plan.apply_value_and_slope(z, *tabs)[1]
        if order == "matmul":
            zp = z
    mag = x.abs() @ w.abs() + (0.0 if b is None else b.abs())
    band = ORDER_BAND_C * (K + 1) * 2.0 ** -24 * mag
    dist = (zp[..., None] - torch.from_numpy(bp).float()).abs().min(dim=-1).values
    flips = torch.zeros_like(zp, dtype=torch.bool)
    for a, c in itertools.combinations(ORDERS, 2):
        flips |= slopes[a] != slopes[c]
    outside = flips & (dist > band)
    assert not bool(outside.any()), (
        f"{int(outside.sum())} slope disagreements outside the band: z {zp[outside]}, "
        f"distance {dist[outside]}, band {band[outside]}")
    return int(flips.sum())


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), M=st.integers(1, 6), K=st.integers(2, 96),
       N=st.integers(1, 40), fn=st.sampled_from(["gelu_tanh", "silu", "gelu"]),
       with_bias=st.booleans())
def test_order_band_holds_for_four_summation_orders(seed, M, K, N, fn, with_bias):
    _check_order_band(fn, seed, M, K, N, with_bias)


@pytest.mark.parametrize("fn, with_bias", [("gelu_tanh", False), ("silu", False),
                                           ("gelu", True)])
def test_order_band_holds_at_model_width(fn, with_bias):
    """At repro-100m's K = 768 (the GLU's gelu_tanh, olmoe's silu experts,
    whisper's biased gelu linear layer), aimed at every breakpoint: the
    orders do disagree there, and only within the band."""
    assert _check_order_band(fn, 0, 4, 768, 96, with_bias) > 0
