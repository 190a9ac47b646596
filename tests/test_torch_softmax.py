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
