"""Port parity: the fused linear layer (``repro_torch.kernels.fused
.fused_linear``, TPU kernels 15 and 16) against the JAX package.

On the CPU ``fused_linear`` takes its plain version; the JAX side runs its
Pallas kernels in interpret mode, as the JAX suite does.

* The forward against JAX's ``fused_linear`` with and without a bias, with
  leading dims, in f32 (1e-5, the JAX suite's bound) and bf16 (one bf16
  rounding: 1e-2).
* The backward kernel's plain version (``dz = g·m(x @ W + b)``) against
  JAX's ``_linear_dz_2d`` at 1e-5, and bitwise against JAX's on inputs on
  an integer grid, where the pre-activation is exact in any order and a
  score sits exactly on a breakpoint.
* Its autograd (dx, dW, db) under both ``impl_bwd`` against ``jax.grad``
  of JAX's ``fused_linear`` at 1e-4 (``tests/test_fused_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro.kernels.fused import epilogue as jepi
from repro.kernels.fused import linear as jlinear
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import linear as tlinear
from repro_torch.kernels.fused.epilogue import plan_and_operands

BLK = (16, 32, 16)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tables(fn="gelu", fmt="f32"):
    return (sfu.get_store().get(fn=fn, n_breakpoints=32, dtype=fmt),
            tsfu.get_store().get(fn=fn, n_breakpoints=32, dtype=fmt))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("m,k,n", [(16, 32, 16), (37, 65, 130), (7, 9, 5), (4, 48, 96)])
def test_fused_linear_plain_matches_jax_kernel(m, k, n, bias):
    jt, tt = _tables()
    x, w, b = _rand(0, (m, k), 2.0), _rand(1, (k, n), 0.2), _rand(2, (n,), 0.1)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    want = np.asarray(jfused.fused_linear(jnp.asarray(x), jnp.asarray(w), jb, table=jt,
                                          block=BLK))
    got = tfused.fused_linear(torch.from_numpy(x), torch.from_numpy(w), tb, table=tt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_linear_leading_dims_and_dtypes(dtype):
    jt, tt = _tables("silu")
    x, w, b = _rand(3, (2, 5, 33), 2.0), _rand(4, (33, 40), 0.2), _rand(5, (40,), 0.1)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jfused.fused_linear(jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd),
                               table=jt, block=BLK)
    got = tfused.fused_linear(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                              torch.from_numpy(b).to(td), table=tt)
    assert got.shape == (2, 5, 40) and got.dtype == td
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("fmt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_dz_plain_matches_jax_kernel(bias, fmt):
    jt, tt = _tables("gelu", fmt)
    x, w, b, g = (_rand(6, (37, 65), 2.0), _rand(7, (65, 130), 0.2), _rand(8, (130,), 0.1),
                  _rand(9, (37, 130)))
    jplan, jtabs = jepi.plan_and_operands(jt, None)
    want = np.asarray(jlinear._linear_dz_2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None, jnp.asarray(g),
        jtabs, plan=jplan, block=BLK, interpret=True, has_bias=bias))
    plan, tabs = plan_and_operands(tt)
    got = tlinear.fused_linear_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(b) if bias else None,
                                         torch.from_numpy(g), plan, tabs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dz_bitwise_on_an_integer_grid():
    """Integer-grid x and w make every product exact in any order, and b
    puts row 0 within a rounding of gelu's breakpoints, where the slope
    jumps: dz equals JAX's bit for bit."""
    jt, tt = _tables()
    rng = np.random.default_rng(10)
    x = (rng.integers(-8, 9, (16, 32)) * 0.125).astype(np.float32)
    w = (rng.integers(-8, 9, (32, 48)) * 0.125).astype(np.float32)
    z = x @ w
    bp = np.asarray(tt.bp, np.float32)
    b = (bp[np.arange(48) % bp.size] - z[0]).astype(np.float32)  # row 0 on breakpoints
    g = (rng.integers(-8, 9, (16, 48)) * 0.25).astype(np.float32)
    jplan, jtabs = jepi.plan_and_operands(jt, None)
    want = np.asarray(jlinear._linear_dz_2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(g), jtabs, plan=jplan,
        block=BLK, interpret=True, has_bias=True))
    plan, tabs = plan_and_operands(tt)
    got = tlinear.fused_linear_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(b), torch.from_numpy(g), plan,
                                         tabs).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("impl_bwd", ["fused", "recompute"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_fused_linear_grads_match_jax(bias, impl_bwd):
    jt, tt = _tables()
    x, w, b = _rand(11, (9, 33), 1.5), _rand(12, (33, 21), 0.2), _rand(13, (21,), 0.1)

    def jloss(x, w, b):
        return jnp.sum(jfused.fused_linear(x, w, b, table=jt, block=BLK,
                                           impl_bwd=impl_bwd) ** 2)

    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None)
    want = jax.grad(jloss, argnums=(0, 1, 2) if bias else (0, 1))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in ((x, w, b) if bias else (x, w))]
    y = tfused.fused_linear(targs[0], targs[1], targs[2] if bias else None, table=tt,
                            impl_bwd=impl_bwd)
    got = torch.autograd.grad((y ** 2).sum(), targs)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-4, rtol=1e-4)
