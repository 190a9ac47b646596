"""Port parity: the fused PWL-exp row softmax (``repro_torch.kernels.fused
.fused_pwl_softmax``) against the JAX package's Pallas kernel.

On the CPU the wrapper takes its plain version; the JAX side runs its Pallas
kernel in interpret mode, as the JAX suite does.  Tolerance 1e-5 abs/rel in
f32 (the JAX suite's bound for the fused softmax): sums are taken in another
order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro_torch.kernels import fused as tfused

TOL = dict(atol=1e-5, rtol=1e-5)


def _tables(n_bp, fmt="f32"):
    return (sfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt),
            tsfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt))


def _scores(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mask(seed, shape):
    m = (np.random.default_rng(seed).random(shape) > 0.3).astype(np.float32)
    m[0, 0, 3] = 0.0  # a row with no valid entry gives zeros
    return m


CASES = {
    "maskless": ((2, 3, 24, 24), {}),
    "causal": ((2, 3, 24, 24), {"causal": True}),
    "window": ((2, 3, 24, 24), {"window": 5}),
    "causal_window": ((1, 2, 40, 40), {"causal": True, "window": 7}),
    "mask": ((2, 3, 4, 24), {"mask": True}),
    "ragged_width": ((3, 5, 200), {}),
    "ragged_causal": ((2, 33, 200), {"causal": True}),
}


@pytest.mark.parametrize("fmt", ["f32", "int8"])
@pytest.mark.parametrize("n_bp", [16, 32, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_softmax_plain_matches_jax_kernel(case, n_bp, fmt):
    shape, kw = CASES[case]
    jt, tt = _tables(n_bp, fmt)
    x = _scores(n_bp, shape)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("mask"):
        m = _mask(1, shape)
        jkw["mask"], tkw["mask"] = jnp.asarray(m), torch.from_numpy(m)
    want = np.asarray(jfused.fused_pwl_softmax(jnp.asarray(x), table=jt, **jkw))
    got = tfused.fused_pwl_softmax(torch.from_numpy(x), table=tt, **tkw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if kw.get("mask"):
        assert not got[0, 0, 3].any()


def test_softmax_exact_exp_and_broadcast_mask():
    """``act="exp"`` (the default without a table) runs the exact exponential
    through the same reduction; a mask broadcasts over the leading axes and
    a float mask selects rather than weights."""
    x = _scores(3, (2, 4, 30))
    m = (np.arange(30) % 3 != 0).astype(np.float32) * 0.5
    want = np.asarray(jfused.fused_pwl_softmax(jnp.asarray(x), mask=jnp.asarray(m)))
    got = tfused.fused_pwl_softmax(torch.from_numpy(x), mask=torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_softmax_keeps_the_input_dtype():
    _, tt = _tables(32)
    x = torch.from_numpy(_scores(4, (3, 16))).to(torch.bfloat16)
    got = tfused.fused_pwl_softmax(x, table=tt, causal=True)
    assert got.dtype == torch.bfloat16
    want = tfused.fused_pwl_softmax(x.float(), table=tt, causal=True)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)


def test_softmax_refuses_mask_with_causal():
    _, tt = _tables(32)
    x = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match="not both"):
        tfused.fused_pwl_softmax(x, table=tt, mask=torch.ones(4), causal=True)


# The kernels' split of a row (csrc/softmax.cu): a narrow row is one warp's,
# lane l holding columns l + 32 j; a wide row is `cluster` blocks', rank r
# owning [r * slice, (r + 1) * slice) and its thread t columns
# r * slice + t + THREADS * j; j < per_thread in both.  Mirrored here.
SPLIT_WIDTHS = (1, 31, 32, 33, 1024, 1025, 1500, 2048, 4097, 32767, 32768)
SPLIT_ROWS = (1, 48, 384, 24576, 49152)


def _owned_columns(plan, N):
    """Every column the plan's threads hold, with repeats."""
    from repro_torch.kernels.fused.softmax import NARROW_WIDTH, THREADS

    j = np.arange(plan.per_thread)
    if N <= NARROW_WIDTH:
        c = (np.arange(32)[:, None] + 32 * j[None, :]).ravel()
        return c[c < N]
    out = []
    for r in range(plan.cluster):
        c0, c1 = r * plan.slice, min((r + 1) * plan.slice, N)
        c = (c0 + np.arange(THREADS)[:, None] + THREADS * j[None, :]).ravel()
        out.append(c[c < c1])
    return np.concatenate(out)


@pytest.mark.parametrize("R", SPLIT_ROWS)
@pytest.mark.parametrize("N", SPLIT_WIDTHS)
def test_split_plan_owns_every_column_once(N, R):
    from repro_torch.kernels.fused import softmax as S

    plan = S._split_plan(R, N)
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= S.MAX_CLUSTER
    owned = np.bincount(_owned_columns(plan, N), minlength=N)
    assert owned.shape == (N,) and bool((owned == 1).all())
    # the registers hold it: a power-of-two bucket the kernels are built for,
    # at most 32 floats a lane (narrow) or 16 a thread (wide) of x, and as
    # many of g in the backward, within the 255 registers of a thread
    assert plan.per_thread & (plan.per_thread - 1) == 0
    if N <= S.NARROW_WIDTH:
        assert plan.cluster == 1 and 32 * plan.per_thread >= N
        assert plan.per_thread <= S.NARROW_PER_LANE
    else:
        assert plan.slice % S.SLICE_ALIGN == 0 and plan.cluster * plan.slice >= N
        assert S.THREADS * plan.per_thread >= plan.slice
        assert plan.per_thread <= S.WIDE_PER_THREAD
    assert 2 * plan.per_thread <= 64


def test_split_plan_splits_only_rows_that_do_not_fill_the_card():
    from repro_torch.kernels.fused.softmax import _split_plan

    assert _split_plan(48, 32768).cluster == 8           # 48 x 32768 mask
    assert _split_plan(48, 1500).cluster == 4            # whisper's cross-attention
    assert _split_plan(12 * 2048, 2048).cluster == 1     # a 2048-token prefill
    assert _split_plan(8 * 12 * 512, 512).cluster == 1   # the training rows (narrow)
    assert _split_plan(49152, 32768).cluster == 8        # 4096 columns a block at most
    assert _split_plan(1, 1025).cluster == 4             # >= 256 columns a block


@pytest.mark.parametrize("bad", ["descending", "nan"])
def test_softmax_refuses_unsorted_breakpoints_under_autograd(bad):
    """The refusal holds whichever backward is asked for."""
    from repro_torch.core.pwl import PWLTable

    t = tsfu.get_store().get(fn="exp", n_breakpoints=8)
    bp = t.bp.flip(0) if bad == "descending" else t.bp.clone()
    if bad == "nan":
        bp[3] = float("nan")
    table = PWLTable(bp=bp, m=t.m, q=t.q, name=f"exp {bad}")
    x = torch.from_numpy(_scores(0, (2, 6, 6))).requires_grad_(True)
    for impl_bwd in ("fused", "recompute"):
        with pytest.raises(ValueError, match="ascending"):
            tfused.fused_pwl_softmax(x, table=table, causal=True, impl_bwd=impl_bwd)
