"""Port parity: the exact (``act=``) and identity epilogues against the JAX
package.

* The exact functions of ``repro_torch.core.functions``, value and slope
  (torch autograd) against ``jax.grad`` of ``repro.core.functions`` on a
  grid that holds the kinks -3, 3, 0 and -0: the slopes there follow jnp's
  autodiff (``jnp.clip`` splits 0.5 at a bound, ``where`` takes its branch).
  Tolerance: values 1e-5 relative and 1e-6 absolute, slopes 1e-5 relative
  and 1e-5 of the largest slope: XLA's and torch's transcendental functions
  differ in the last bits, which 1 - t² magnifies where tanh is near ±1
  (gelu_tanh's slope at x = -5 by 3.8e-6).  Hardswish's kink slopes are
  held exactly.
* The CUDA kernels' epilogue codes (``csrc/epilogue.cuh``) name the same
  functions in the registry's order.
* The fused GLU, MoE GLU and linear layer (forward and gradients) and the
  row softmax (gradient) under exact and identity plans, on the CPU (their
  plain versions, which the kernels are held against on the card), against
  the JAX ops in interpret mode with the same ``act=`` or no table:
  forward 1e-5, gradients 1e-4 of each gradient's max (the JAX suite's
  grad-parity bound for these ops with N(0, 1) inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.core import functions as JF
from repro.kernels import fused as jfused
from repro_torch.core import functions as TF
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import epilogue as tepi

BLK = (16, 32, 16)  # the JAX suite's blocks: every grid axis takes several steps
FUNCTIONS = ["gelu", "gelu_tanh", "silu", "sigmoid", "tanh", "exp", "softplus", "hardswish",
             "elu", "mish"]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=rel * scale, rtol=rel,
                               err_msg=what)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_exact_value_and_slope_match_jax(fn):
    x = np.concatenate([np.float32([-3.0, 3.0, 0.0, -0.0, 1.0, -1.0]),
                        np.linspace(-8.0, 8.0, 257, dtype=np.float32)])
    jx = jnp.asarray(x)
    want_v = np.asarray(JF.get(fn).fn(jx))
    want_d = np.asarray(jax.vmap(jax.grad(JF.get(fn).fn))(jx))
    tx = torch.from_numpy(x).requires_grad_(True)
    v = TF.get(fn).fn(tx)
    (d,) = torch.autograd.grad(v.sum(), tx)
    np.testing.assert_allclose(v.detach().numpy(), want_v, rtol=1e-5, atol=1e-6)
    _close(d.numpy(), want_d, 1e-5, "slope")
    # the plain epilogue's (value, slope) is the same autograd
    pv, pd = tepi.exact_plan(fn).apply_value_and_slope(torch.from_numpy(x))
    np.testing.assert_array_equal(pv.numpy(), v.detach().numpy())
    np.testing.assert_array_equal(pd.numpy(), d.numpy())


def test_hardswish_splits_its_slope_at_the_kinks_as_jax():
    x = torch.tensor([-3.0, 3.0], requires_grad=True)
    (d,) = torch.autograd.grad(TF.get("hardswish").fn(x).sum(), x)
    assert d.tolist() == [-0.25, 1.25]


def test_kernel_epilogue_codes():
    """The ids follow the registry, which ``csrc/epilogue.cuh``'s ExactFn
    enumerates in this order."""
    assert list(TF.REGISTRY) == FUNCTIONS
    assert tepi.EXACT_IDS == {fn: i for i, fn in enumerate(FUNCTIONS)}
    assert tepi.kernel_epilogue(tepi.IDENTITY, ()) == (None, None, 0, 0, 0)
    assert tepi.kernel_epilogue(tepi.exact_plan("hardswish"), ()) == (None, None, 0, 1, 7)


def _glu_args(seed):
    return _rand(seed, (19, 33), 1.5), _rand(seed + 1, (33, 24), 0.3), _rand(seed + 2, (33, 24),
                                                                             0.3)


@pytest.mark.parametrize("act", ["gelu", "hardswish", "elu", None])
def test_glu_forward_exact_and_identity(act):
    args = _glu_args(0)
    want = np.asarray(jfused.fused_glu(*(jnp.asarray(a) for a in args), act=act, block=BLK))
    got = tfused.fused_glu(*(torch.from_numpy(a) for a in args), act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _grads_both(jop, top, args, impl_bwd):
    def jloss(*a):
        return jnp.sum(jnp.cos(jop(*a, impl_bwd="fused").astype(jnp.float32)))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    torch.cos(top(*ts, impl_bwd=impl_bwd).float()).sum().backward()
    return [t.grad for t in ts], want


@pytest.mark.parametrize("impl_bwd", ["fused", "recompute"])
@pytest.mark.parametrize("act", ["hardswish", "silu", None])
def test_glu_grads_exact_and_identity(act, impl_bwd):
    got, want = _grads_both(
        lambda *a, **k: jfused.fused_glu(*a, act=act, block=BLK, **k),
        lambda *a, **k: tfused.fused_glu(*a, act=act, **k), _glu_args(3), impl_bwd)
    for name, g, w in zip(("dx", "dWg", "dWu"), got, want):
        _close(g.numpy(), w, 1e-4, f"{act} {name}")


@pytest.mark.parametrize("act", ["tanh", "gelu", None])
def test_linear_forward_and_grads_exact_and_identity(act):
    x, w, b = _rand(6, (9, 33), 1.5), _rand(7, (33, 21), 0.2), _rand(8, (21,), 0.1)
    want = np.asarray(jfused.fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                          act=act, block=BLK))
    got = tfused.fused_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    got, want = _grads_both(
        lambda *a, **k: jfused.fused_linear(*a, act=act, block=BLK, **k),
        lambda *a, **k: tfused.fused_linear(*a, act=act, **k), (x, w, b), "fused")
    for name, g, w_ in zip(("dx", "dW", "db"), got, want):
        _close(g.numpy(), w_, 1e-4, f"{act} {name}")


@pytest.mark.parametrize("act", ["gelu", "hardswish", None])
def test_moe_glu_forward_and_grads_exact_and_identity(act):
    args = (_rand(9, (3, 19, 33), 1.5), _rand(10, (3, 33, 24), 0.3), _rand(11, (3, 33, 24), 0.3))
    want = np.asarray(jfused.fused_moe_glu(*(jnp.asarray(a) for a in args), act=act,
                                           block=BLK))
    got = tfused.fused_moe_glu(*(torch.from_numpy(a) for a in args), act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    got, want = _grads_both(
        lambda *a, **k: jfused.fused_moe_glu(*a, act=act, block=BLK, **k),
        lambda *a, **k: tfused.fused_moe_glu(*a, act=act, **k), args, "fused")
    for name, g, w in zip(("dx", "dWg", "dWu"), got, want):
        _close(g.numpy(), w, 1e-4, f"{act} {name}")


@pytest.mark.parametrize("kw", [dict(causal=True), dict(window=5)], ids=["causal", "window"])
def test_softmax_grads_exact_exp(kw):
    """No table: the exact exp inside the clamps, its slope exp(s)."""
    x = _rand(12, (2, 3, 12, 12), 3.0)
    want = jax.grad(lambda a: jnp.sum(jnp.cos(jfused.fused_pwl_softmax(a, **kw))))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    torch.cos(tfused.fused_pwl_softmax(t, **kw)).sum().backward()
    _close(t.grad.numpy(), want, 1e-4)
