"""Port parity: the fused GLU (``repro_torch.kernels.fused``) and its PWL
decode against the JAX package.

On the CPU ``fused_glu`` takes its plain version; the JAX side runs its
Pallas kernel in interpret mode, as the JAX suite does.  Tolerance 1e-5
(the JAX suite's own bound for this kernel): sums are taken in another
order.  The decode itself is held bitwise in the slope on inputs that sit
exactly on breakpoints.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import repro_torch.sfu as tsfu
from repro import sfu
from repro.kernels import fused as jfused
from repro.kernels.fused import epilogue as jepi
from repro_torch.kernels import fused as tfused


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("fmt", ["f32", "int8"])
@pytest.mark.parametrize("shape", [(37, 65, 130), (4, 64, 128), (33, 7, 19)])
def test_fused_glu_plain_matches_jax_kernel(shape, fmt):
    M, K, N = shape
    x, wg, wu = _rand(0, (M, K), 2.0), _rand(1, (K, N), 0.2), _rand(2, (K, N), 0.2)
    jt = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32, dtype=fmt)
    tt = tsfu.get_store().get(fn="gelu_tanh", n_breakpoints=32, dtype=fmt)
    want = np.asarray(jfused.fused_glu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                                       table=jt, block=(16, 128, 64)))
    got = tfused.fused_glu(torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
                           table=tt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fused_glu_leading_dims_and_exact_epilogue():
    x, wg, wu = _rand(3, (2, 5, 24), 1.0), _rand(4, (24, 40), 0.3), _rand(5, (24, 40), 0.3)
    want = np.asarray(jfused.fused_glu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                                       act="gelu_tanh", block=(16, 128, 64)))
    got = tfused.fused_glu(torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
                           act="gelu_tanh").numpy()
    assert got.shape == (2, 5, 40)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fmt", ["f32", "bf16", "f16", "int8"])
@pytest.mark.parametrize("fn", ["gelu_tanh", "silu", "exp"])
def test_value_and_slope_decode_on_breakpoints(fn, fmt):
    base_j = sfu.get_store().get(fn=fn, n_breakpoints=32)
    base_t = tsfu.get_store().get(fn=fn, n_breakpoints=32)
    jbp, jdmq = jepi.pack_table(base_j, dtype=fmt)
    tbp, tdmq = tfused.pack_table(base_t, dtype=fmt)
    bp = np.asarray(jbp, np.float32)[:, 0]
    # every breakpoint exactly, its neighbours one ulp away, and a coarse grid
    x = np.concatenate([bp, np.nextafter(bp, np.inf), np.nextafter(bp, -np.inf),
                        np.linspace(-12, 12, 257, dtype=np.float32)]).astype(np.float32)
    # XLA on the CPU flushes subnormal inputs to zero and torch does not; the
    # neighbours of a breakpoint at 0.0 are subnormal, so they are left out
    x = x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]
    jv, js = jepi.pwl_value_and_slope_tile(jnp.asarray(x), jbp, jdmq, 32)
    tv, ts = tfused.pwl_value_and_slope(torch.from_numpy(x), tbp, tdmq, 32)
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)


def test_left_segment_owns_the_breakpoint():
    t = tsfu.get_store().get(fn="gelu_tanh", n_breakpoints=16)
    bp, dmq = tfused.pack_table(t)
    x = t.bp.clone()
    _, slope = tfused.pwl_value_and_slope(x, bp, dmq, 16)
    # on bp_i the slope is segment i's (the one ending at bp_i)
    torch.testing.assert_close(slope, t.m[:-1], rtol=0, atol=0)


def test_wrapper_refuses_other_devices(monkeypatch):
    """A device other than the CPU and CUDA is refused.  Meta tensors stand
    for one here, with the wrappers' shapes-only meta branch
    (``kernels/fused/meta.py``) switched off."""
    from repro_torch.kernels.fused import meta

    monkeypatch.setattr(meta, "is_meta", lambda t: False)
    t = tsfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    x = torch.empty((4, 8), device="meta")
    w = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfused.fused_glu(x, w, w, table=t)


def test_launch_counter_does_not_move_on_cpu():
    t = tsfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    before = tfused.fused_glu.launches
    tfused.fused_glu(torch.ones(2, 8), torch.ones(8, 4), torch.ones(8, 4), table=t)
    assert tfused.fused_glu.launches == before
