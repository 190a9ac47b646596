"""Port parity: the fused RMSNorm backward (``repro_torch.kernels.fused.norm``)
against the JAX package.

* The port's autograd ``(dx, dscale)`` against ``jax.grad`` of the JAX op
  through its fused Pallas backward kernel (interpret mode), with the JAX
  suite's loss ``sum(cos(y))`` on its integer grid
  (``tests/test_fused_backward.py``: x (21, 48), scale span 4, step 0.125),
  at 1e-5 of each gradient's max, the JAX suite's bound for this op; f32,
  bf16 and int8 tables, the identity and exact epilogues, leading dims
  (3, 7, 50); under both of the port's backward implementations.
* ``fused_rmsnorm_bwd_plain`` (the plain version of the CUDA backward
  kernel) against the JAX backward kernel ``_rmsnorm_bwd_2d`` itself.
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
from repro.kernels.fused.norm import _rmsnorm_bwd_2d
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import epilogue as tepi

REL = 1e-5


def _igrid(seed, shape, span=16, step=0.125):
    ints = np.random.default_rng(seed).integers(-span, span + 1, size=shape)
    return (ints * step).astype(np.float32)


def _tables(kind):
    """``(jax table, port table)`` or ``(None, None)``: "table:<format>"
    (gelu, 32 breakpoints); anything else has no table."""
    if not kind.startswith("table:"):
        return None, None
    fmt = kind.split(":")[1]
    return (sfu.get_store().get(fn="gelu", n_breakpoints=32, dtype=fmt),
            tsfu.get_store().get(fn="gelu", n_breakpoints=32, dtype=fmt))


def _act(kind):
    return kind[4:] if kind.startswith("act:") else None


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=REL * scale, rtol=REL,
                               err_msg=what)


def _jax_grads(x, s, kind):
    jt, _ = _tables(kind)

    def loss(x, s):
        y = jfused.fused_rmsnorm(x, s, table=jt, act=_act(kind), block_rows=16,
                                 impl_bwd="fused")
        return jnp.sum(jnp.cos(y.astype(jnp.float32)))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))]


def _port_grads(x, s, kind, impl_bwd):
    _, tt = _tables(kind)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, s)]
    y = tfused.fused_rmsnorm(*ts, table=tt, act=_act(kind), impl_bwd=impl_bwd)
    torch.cos(y.float()).sum().backward()
    return [t.grad for t in ts]


KINDS = ["table:f32", "table:bf16", "table:int8", "identity", "act:gelu", "act:hardswish"]


@pytest.mark.parametrize("impl_bwd", ["fused", "recompute"])
@pytest.mark.parametrize("kind", KINDS)
def test_rmsnorm_grads_match_jax(kind, impl_bwd):
    x, s = _igrid(0, (21, 48)), _igrid(1, (48,), span=4)
    want = _jax_grads(x, s, kind)
    for name, g, w in zip(("dx", "dscale"), _port_grads(x, s, kind, impl_bwd), want):
        assert g.shape == w.shape
        _close(g.numpy(), w, f"{kind} {impl_bwd} {name}")


def test_rmsnorm_grads_leading_dims():
    x, s = _igrid(2, (3, 7, 50)), _igrid(3, (50,), span=4)
    want = _jax_grads(x, s, "table:f32")
    for name, g, w in zip(("dx", "dscale"), _port_grads(x, s, "table:f32", "fused"), want):
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("kind", ["table:f32", "act:gelu"])
def test_fused_backward_matches_recompute(kind):
    """The plain version of the backward kernel against autograd through the
    plain forward (``impl_bwd="recompute"``), both the port's, on N(0, 1)
    draws (no integer grid)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((19, 40)) * 2).astype(np.float32)
    s = (rng.standard_normal(40) * 0.3).astype(np.float32)
    fused = _port_grads(x, s, kind, "fused")
    for name, g, w in zip(("dx", "dscale"), fused, _port_grads(x, s, kind, "recompute")):
        _close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("kind", ["table:f32", "table:int8", "identity", "act:gelu"])
def test_bwd_plain_matches_jax_backward_kernel(kind):
    x, s = _igrid(5, (37, 48)), _igrid(6, (48,), span=4)
    g = _igrid(7, (37, 48), span=8)
    jt, tt = _tables(kind)
    jplan, jtabs = jepi.plan_and_operands(jt, _act(kind))
    tplan, ttabs = tepi.plan_and_operands(tt, _act(kind))
    jdx, jds = _rmsnorm_bwd_2d(jnp.asarray(x), jnp.asarray(s), jnp.asarray(g), jtabs,
                               plan=jplan, block_rows=16, eps=1e-6, interpret=True)
    dx, ds = tfused.fused_rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(s),
                                      torch.from_numpy(g), tplan, ttabs)
    assert dx.dtype == ds.dtype == torch.float32
    _close(dx.numpy(), jdx, "dx")
    _close(ds.numpy(), jds, "ds")


def test_bf16_inputs_give_bf16_gradients():
    x = torch.from_numpy(_igrid(8, (6, 32))).to(torch.bfloat16).requires_grad_(True)
    s = torch.from_numpy(_igrid(9, (32,), span=4)).requires_grad_(True)
    tfused.fused_rmsnorm(x, s, act="gelu").float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and s.grad.dtype == torch.float32
