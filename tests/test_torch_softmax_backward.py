"""Port parity: the fused PWL-exp softmax's backward
(``repro_torch.kernels.fused.softmax``) against the JAX package.

The port's dx (autograd through ``fused_pwl_softmax``, whose CPU backward is
``fused_pwl_softmax_bwd_plain``, the plain version of the CUDA backward
kernel) against ``jax.grad`` of ``fused_pwl_softmax`` (its Pallas backward
kernel in interpret mode), with the JAX suite's cos-sum loss, on the cases
of ``tests/test_fused_backward.py``: 8..64 breakpoints, causal, a {0, 1}
mask, and argmax ties (the row max is differentiated and its gradient
split across ties).  Integer-grid inputs, tolerance rel 1e-5 of the
gradient's max, the JAX suite's bound for this op.
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
from repro.kernels.fused.softmax import _softmax_bwd_2d
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused.epilogue import plan_and_operands
from repro_torch.kernels.fused.softmax import fused_pwl_softmax_bwd_plain, static_mask

REL = 1e-5


def _igrid(seed, shape, span=16, step=0.125):
    ints = np.random.default_rng(seed).integers(-span, span + 1, size=shape)
    return (ints * step).astype(np.float32)


def _tables(n_bp, fmt="f32"):
    return (sfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt),
            tsfu.get_store().get(fn="exp", n_breakpoints=n_bp, dtype=fmt))


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, atol=REL * scale, rtol=REL,
                               err_msg=what)


def _masks(mask):
    if mask is None:
        return {}, {}
    return {"mask": jnp.asarray(mask)}, {"mask": torch.from_numpy(mask)}


def _jax_grad(jt, x, mask=None, **kw):
    jkw = dict(kw, **_masks(mask)[0])

    def loss(x):
        return jnp.sum(jnp.cos(jfused.fused_pwl_softmax(x, table=jt, block_rows=8,
                                                        impl_bwd="fused", **jkw)))

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


def _torch_grad(tt, x, mask=None, impl_bwd="fused", **kw):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfused.fused_pwl_softmax(xt, table=tt, impl_bwd=impl_bwd,
                                 **dict(kw, **_masks(mask)[1]))
    torch.cos(y).sum().backward()
    return xt.grad.numpy()


def _tied(seed, shape):
    x = _igrid(seed, shape, span=4)
    x[..., :3] = x.max(axis=-1, keepdims=True) + 1.0
    return x


CASES = {
    "plain": lambda: (_igrid(0, (12, 24), span=12), None, {}),
    "causal": lambda: (_igrid(0, (2, 6, 11), span=12), None, {"causal": True}),
    "mask": lambda: (_igrid(1, (12, 24), span=12),
                     (_igrid(2, (12, 24)) > 0).astype(np.float32), {}),
    "ties": lambda: (_tied(0, (8, 16)), None, {}),
}


@pytest.mark.parametrize("n_bp", [8, 16, 32, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_softmax_grad_matches_jax(case, n_bp):
    """Both backwards of the port (the kernel's plain version, and autograd
    through the plain forward) against the JAX backward kernel."""
    jt, tt = _tables(n_bp)
    x, mask, kw = CASES[case]()
    want = _jax_grad(jt, x, mask, **kw)
    for impl_bwd in ("fused", "recompute"):
        got = _torch_grad(tt, x, mask, impl_bwd=impl_bwd, **kw)
        _close(got, want, f"{case} n_bp={n_bp} {impl_bwd}")


def test_int8_table_and_causal_window_grad():
    jt, tt = _tables(32, "int8")
    x = _igrid(3, (1, 2, 20, 20), span=12)
    _close(_torch_grad(tt, x, causal=True, window=5), _jax_grad(jt, x, causal=True, window=5))


@pytest.mark.parametrize("case", ["causal", "mask", "ties"])
def test_bwd_plain_matches_jax_backward_kernel(case):
    """The plain backward on (R, N) rows against the JAX backward kernel on
    the same rows and upstream gradient, with the causal mask synthesized
    from positions on both sides."""
    jt, tt = _tables(32)
    x, mask, kw = CASES[case]()
    N = x.shape[-1]
    x2 = x.reshape(-1, N)
    g2 = _igrid(9, x2.shape, span=8)
    seq_len = x.shape[-2] if kw.get("causal") else 1
    m2 = None if mask is None else mask.reshape(-1, N)
    jplan, jtabs = jepi.plan_and_operands(jt)
    want = _softmax_bwd_2d(jnp.asarray(x2), None if m2 is None else jnp.asarray(m2),
                           jnp.asarray(g2), jtabs, plan=jplan, block_rows=8,
                           interpret=True, seq_len=seq_len,
                           causal=bool(kw.get("causal")), window=None)
    plan, tabs = plan_and_operands(tt)
    tm = None if m2 is None else torch.from_numpy(m2)
    if kw.get("causal"):
        tm = static_mask(x2.shape[0], N, seq_len, True, None)
    got = fused_pwl_softmax_bwd_plain(torch.from_numpy(x2), tm, torch.from_numpy(g2),
                                      plan, tabs)
    _close(got.numpy(), want, case)


def test_grad_keeps_the_input_dtype_and_mask_zeros():
    _, tt = _tables(32)
    x = torch.from_numpy(_igrid(5, (3, 40), span=12)).to(torch.bfloat16).requires_grad_(True)
    mask = torch.from_numpy(_igrid(6, (3, 40)) > 0)
    y = tfused.fused_pwl_softmax(x, table=tt, mask=mask)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.arange(40.0)).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert not x.grad[~mask].any()


def test_bwd_plain_all_masked_row_matches_jax_backward_kernel():
    """A row with no kept score: the forward gives zeros, and the VJP's
    gl * sum(g * u) / L^2 is 0 / 0 there (L = 1e-30, L^2 underflows to 0 in
    f32), so dx is NaN across the row, in the JAX backward kernel as in the
    plain version that the CUDA kernel is held to.  The other rows agree at
    the usual tolerance."""
    jt, tt = _tables(32)
    x2 = _igrid(11, (6, 40), span=12)
    g2 = _igrid(12, (6, 40), span=8)
    m2 = (_igrid(13, (6, 40)) > 0).astype(np.float32)
    m2[2] = 0.0
    jplan, jtabs = jepi.plan_and_operands(jt)
    want = np.asarray(_softmax_bwd_2d(jnp.asarray(x2), jnp.asarray(m2), jnp.asarray(g2), jtabs,
                                      plan=jplan, block_rows=8, interpret=True, seq_len=1,
                                      causal=False, window=None))
    plan, tabs = plan_and_operands(tt)
    got = fused_pwl_softmax_bwd_plain(torch.from_numpy(x2), torch.from_numpy(m2),
                                      torch.from_numpy(g2), plan, tabs).numpy()
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    rest = np.arange(6) != 2
    assert np.isfinite(want[rest]).all()
    _close(got[rest], want[rest], "rows with a kept score")
    y = tfused.fused_pwl_softmax(torch.from_numpy(x2), table=tt, mask=torch.from_numpy(m2))
    assert not y[2].any()
