"""Port parity: the fused RMSNorm forward (``repro_torch.kernels.fused.norm``)
against the JAX package, and the host's plan of how the CUDA kernels hold a
row (``_row_plan``: every column owned once, at every width to 5120, by the
first of the splits ``csrc/norm.cu`` is built for that holds the row).

On the CPU ``fused_rmsnorm`` takes its plain version; the JAX side runs its
Pallas kernel in interpret mode, as the JAX suite does, at that suite's
shapes (``tests/test_fused_kernels.py``: leading dims (3, 7, 50) with the
identity epilogue, 33 x 40 with a 32-breakpoint gelu table and 16-row
blocks).  Tolerance 1e-5 abs/rel, the JAX suite's: sums are taken in
another order.  Inputs are numpy draws from a seed.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import norm as tnorm

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _epilogue(kind):
    """``(jax kwargs, port kwargs)`` of an epilogue: "identity", "act:<fn>"
    or "table:<format>" (gelu, 32 breakpoints)."""
    if kind == "identity":
        return {}, {}
    if kind.startswith("act:"):
        return {"act": kind[4:]}, {"act": kind[4:]}
    fmt = kind.split(":")[1]
    return ({"table": sfu.get_store().get(fn="gelu", n_breakpoints=32, dtype=fmt)},
            {"table": tsfu.get_store().get(fn="gelu", n_breakpoints=32, dtype=fmt)})


def _both(x, s, kind, **kw):
    jkw, tkw = _epilogue(kind)
    want = np.asarray(jfused.fused_rmsnorm(jnp.asarray(x), jnp.asarray(s), **jkw, **kw),
                      np.float32)
    got = tfused.fused_rmsnorm(torch.from_numpy(x), torch.from_numpy(s), **tkw, **kw)
    return got, want


EPILOGUES = ["identity", "act:gelu", "act:hardswish", "table:f32", "table:bf16", "table:int8"]


@pytest.mark.parametrize("kind", EPILOGUES)
def test_fused_rmsnorm_leading_dims_matches_jax(kind):
    got, want = _both(_rand(0, (3, 7, 50), 3.0), _rand(1, (50,), 0.3), kind)
    assert got.shape == (3, 7, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", EPILOGUES)
def test_fused_rmsnorm_odd_width_matches_jax(kind):
    got, want = _both(_rand(2, (33, 40), 3.0), _rand(3, (40,), 0.3), kind, block_rows=16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("D", [1, 33, 48])
def test_fused_rmsnorm_widths_and_eps(D):
    """The mean is over the true width (JAX pads to 128 lanes and divides
    by D); eps is the caller's."""
    got, want = _both(_rand(4, (21, D), 2.0), _rand(5, (D,), 0.3), "table:f32", eps=1e-3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_rmsnorm_bf16_input_matches_jax():
    """bf16 x: f32 inside, the result cast back to bf16 (one rounding apart
    at most: 1e-2)."""
    x = _rand(6, (9, 64), 2.0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    s = _rand(7, (64,), 0.3)
    jt = sfu.get_store().get(fn="gelu", n_breakpoints=32)
    tt = tsfu.get_store().get(fn="gelu", n_breakpoints=32)
    want = np.asarray(jfused.fused_rmsnorm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                           jnp.asarray(s), table=jt), np.float32)
    got = tfused.fused_rmsnorm(xb, torch.from_numpy(s), table=tt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_plain_is_the_layer_formula_and_counters_stay_on_cpu():
    """The plain version is ``act(x·rsqrt(mean(x²)+eps)·(1+scale))``, and a
    CPU call launches nothing."""
    x, s = torch.from_numpy(_rand(8, (5, 24), 2.0)), torch.from_numpy(_rand(9, (24,), 0.3))
    n0, b0 = tfused.fused_rmsnorm.launches, tfused.fused_rmsnorm.bwd_launches
    y = tfused.fused_rmsnorm(x.requires_grad_(True), s, act="silu")
    y.sum().backward()
    ref = torch.nn.functional.silu(x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
                                   * (1 + s))
    torch.testing.assert_close(y, ref, atol=1e-6, rtol=1e-6)
    assert (tfused.fused_rmsnorm.launches, tfused.fused_rmsnorm.bwd_launches) == (n0, b0)
    assert tnorm.fused_rmsnorm_plain is tfused.fused_rmsnorm_plain


# The kernels' layout of a row (csrc/norm.cu): part s of the row's warps owns
# lane l's columns l + 32 (s P + j), j < P; a streamed row's lane owns l + 32 j
# for every j; the backward's ds stages take 256 columns at a time.  Mirrored
# here.
PLAN_WIDTHS = (1, 31, 32, 33, 40, 48, 128, 129, 512, 513, 768, 769, 1024, 1025, 2048, 2049,
               3000, 4096, 4097, 5120)


def _plan_columns(D, backward):
    """Every column a row's lanes own under ``_row_plan(D, backward)``, with
    repeats."""
    plan = tnorm._row_plan(D, backward)
    if plan.warps == 0:
        cols = np.arange(32)[:, None] + 32 * np.arange(-(-D // 32))[None, :]
    else:
        j = np.arange(plan.warps * plan.per_lane)  # part s holds j in [s P, s P + P)
        cols = np.arange(32)[:, None] + 32 * j[None, :]
    cols = cols.ravel()
    return cols[cols < D]


def _check_row_plan(D, backward):
    plan = tnorm._row_plan(D, backward)
    assert bool((np.bincount(_plan_columns(D, backward), minlength=D) == 1).all())
    splits = tnorm.BWD_SPLITS if backward else tnorm.FWD_SPLITS
    if D > (1024 if backward else 4096):
        assert plan == (0, 0)  # streamed
        return
    # a split the kernels are built for, the first that holds the row
    assert plan in splits
    assert all(32 * p * w < D for p, w in splits[:splits.index(plan)])


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("D", PLAN_WIDTHS)
def test_row_plan_owns_every_column_once(D, backward):
    _check_row_plan(D, backward)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_row_plan_at_every_width_to_qwen_d_model(backward):
    """Every width from 1 to qwen2.5-32b's d_model, 5120 (the JAX tests' 40
    and 48 among them): each column owned once, by a split the kernels are
    built for, or streamed."""
    for D in range(1, 5121):
        _check_row_plan(D, backward)


def test_row_plan_at_the_model_widths():
    plan = tnorm._row_plan
    assert plan(40) == (4, 1) and plan(48, True) == (4, 1)
    assert plan(768) == (24, 1) and plan(768, True) == (24, 1)
    assert plan(2048) == (32, 2) and plan(1024, True) == (32, 1) and plan(1025, True) == (0, 0)
    assert plan(3000) == (24, 4) and plan(3000, True) == (0, 0)
    assert plan(4096) == (32, 4) and plan(4097) == (0, 0) and plan(5120) == (0, 0)


def test_row_plan_prefers_fewest_warps_then_fewest_registers():
    """The split lists' order: the fewest warps first, and within a warp
    count the fewest columns a lane."""
    for splits in (tnorm.FWD_SPLITS, tnorm.BWD_SPLITS):
        assert list(splits) == sorted(splits, key=lambda sp: (sp[1], sp[0]))


def test_ds_tiles_stay_16_rows():
    """The backward's ds partials are summed over 16-row tiles (the JAX
    suite's 16-row blocks); the wrapper sizes the partials by the kernel's
    ``rmsnorm_tile_rows``, so the tile is csrc/norm.cu's constant alone."""
    src = (pathlib.Path(tnorm.__file__).resolve().parents[2] / "csrc" / "norm.cu").read_text()
    assert "constexpr int TILE_ROWS = 16;" in src
    assert "extern \"C\" int rmsnorm_tile_rows() { return TILE_ROWS; }" in src


@pytest.mark.parametrize("bad", ["descending", "nan"])
def test_rmsnorm_refuses_unsorted_breakpoints_under_autograd(bad):
    """The search's refusal holds on the CPU, whichever backward is asked for."""
    from repro_torch.core.pwl import PWLTable

    t = tsfu.get_store().get(fn="gelu", n_breakpoints=32)
    bp = t.bp.flip(0) if bad == "descending" else t.bp.clone()
    if bad == "nan":
        bp[3] = float("nan")
    table = PWLTable(bp=bp, m=t.m, q=t.q, name=f"gelu {bad}")
    x = torch.from_numpy(_rand(10, (5, 40), 2.0)).requires_grad_(True)
    s = torch.from_numpy(_rand(11, (40,), 0.3))
    for impl_bwd in ("fused", "recompute"):
        with pytest.raises(ValueError, match="ascending"):
            tfused.fused_rmsnorm(x, s, table=table, impl_bwd=impl_bwd)
