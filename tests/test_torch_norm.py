"""Port parity: the fused RMSNorm forward (``repro_torch.kernels.fused.norm``)
against the JAX package.

On the CPU ``fused_rmsnorm`` takes its plain version; the JAX side runs its
Pallas kernel in interpret mode, as the JAX suite does, at that suite's
shapes (``tests/test_fused_kernels.py``: leading dims (3, 7, 50) with the
identity epilogue, 33 x 40 with a 32-breakpoint gelu table and 16-row
blocks).  Tolerance 1e-5 abs/rel, the JAX suite's: sums are taken in
another order.  Inputs are numpy draws from a seed.
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
