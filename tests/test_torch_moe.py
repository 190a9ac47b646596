"""Port parity: the fused MoE-expert GLU (``repro_torch.kernels.fused.moe``)
against the JAX package.

* ``fused_moe_glu`` on CPU tensors (its plain version) against the JAX
  Pallas kernel in interpret mode, at the JAX suite's shapes
  (``tests/test_fused_moe_softmax.py``): f32 at 1e-5, bf16 operands at 5e-2
  (the JAX suite's bounds; sums are taken in another order, and a bf16
  output rounds once more).
* ``fused_glu_bwd_plain`` on (E, C, ·) operands (the plain version of the
  CUDA backward kernel of the per-expert GLU) against the JAX backward kernel ``_moe_dz_3d`` in interpret mode,
  on integer grids where every f32 partial sum is exact: 1e-6 of each
  output's max.
* The port's autograd ``(dx, dWg, dWu)`` against ``jax.grad`` of the JAX
  op with the JAX suite's cos-sum loss (``test_moe_grad_parity``'s grid), at
  1e-4 of each gradient's max, under both backward implementations.
* Buckets whose rows are all ±0 (one in +0, one in -0, one mixed): the JAX
  forward and backward kernels in interpret mode and the port's plain
  versions give there bitwise what the epilogue gives on +0 accumulators,
  ``act(+0)·(+0)`` and ``(g·0·act'(0), g·act(0))``, which is what the CUDA
  kernel's decode configuration writes for such a bucket without reading
  its weights; under the silu and gelu_tanh tables, exact silu and the
  identity, in f32 and bf16.
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
from repro.kernels.fused.moe import _moe_dz_3d
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused.epilogue import exact_plan, plan_and_operands

BLK = (16, 32, 16)  # the JAX suite's blocks: every grid axis takes several steps


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _igrid(seed, shape, span=16, step=0.125):
    """Integer-grid reals (exact under blocked f32 sums), from numpy."""
    ints = np.random.default_rng(seed).integers(-span, span + 1, size=shape)
    return (ints * step).astype(np.float32)


def _tables(fn="silu", n_bp=32, fmt="f32"):
    return (sfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt),
            tsfu.get_store().get(fn=fn, n_breakpoints=n_bp, dtype=fmt))


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=rel * scale,
                               rtol=rel, err_msg=what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 32, 16), (3, 37, 65, 30), (1, 7, 9, 5),
                                   (4, 40, 48, 96)])
def test_plain_forward_matches_jax_kernel(shape, dtype):
    E, C, D, F = shape
    jt, tt = _tables()
    x, wg, wu = _rand(0, (E, C, D), 2.0), _rand(1, (E, D, F), 0.2), _rand(2, (E, D, F), 0.2)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jfused.fused_moe_glu(*(jnp.asarray(a).astype(jdt) for a in (x, wg, wu)),
                                table=jt, block=BLK)
    got = tfused.fused_moe_glu(*(torch.from_numpy(a).to(tdt) for a in (x, wg, wu)),
                               table=tt)
    assert got.dtype == tdt and got.shape == (E, C, F)
    tol = 1e-5 if dtype == "f32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_plain_forward_exact_epilogue_matches_jax():
    x, wg, wu = _rand(3, (3, 9, 24), 1.0), _rand(4, (3, 24, 40), 0.3), _rand(5, (3, 24, 40), 0.3)
    want = jfused.fused_moe_glu(*(jnp.asarray(a) for a in (x, wg, wu)), act="silu", block=BLK)
    got = tfused.fused_moe_glu(*(torch.from_numpy(a) for a in (x, wg, wu)), act="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fmt", ["f32", "int8"])
@pytest.mark.parametrize("shape", [(3, 19, 33, 24), (2, 37, 65, 30)])
def test_bwd_plain_matches_jax_backward_kernel(shape, fmt):
    E, C, D, F = shape
    jt, tt = _tables(fmt=fmt)
    x = _igrid(0, (E, C, D))
    wg, wu = _igrid(1, (E, D, F), span=4), _igrid(2, (E, D, F), span=4)
    g = _igrid(3, (E, C, F), span=8)
    jplan, jtabs = jepi.plan_and_operands(jt)
    want = _moe_dz_3d(*(jnp.asarray(a) for a in (x, wg, wu, g)), jtabs, plan=jplan,
                      block=BLK, interpret=True)
    plan, tabs = plan_and_operands(tt)
    got = tfused.fused_glu_bwd_plain(*(torch.from_numpy(a) for a in (x, wg, wu, g)),
                                     plan, tabs)
    for name, a, b in zip(("dzg", "dzu"), got, want):
        assert a.dtype == torch.float32 and a.shape == (E, C, F)
        _close(a.numpy(), b, 1e-6, name)


def _jax_grads(table, x, wg, wu, impl_bwd):
    def loss(x, wg, wu):
        y = jfused.fused_moe_glu(x, wg, wu, table=table, block=BLK, impl_bwd=impl_bwd)
        return jnp.sum(jnp.cos(y.astype(jnp.float32)))

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, wg, wu)))


def _torch_grads(table, x, wg, wu, impl_bwd):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, wg, wu)]
    torch.cos(tfused.fused_moe_glu(*ts, table=table, impl_bwd=impl_bwd).float()).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("impl_bwd", ["fused", "recompute"])
@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_autograd_matches_jax_grad(fmt, impl_bwd):
    jt, tt = _tables(fmt=fmt)
    x = _igrid(0, (3, 19, 33))
    wg, wu = _igrid(1, (3, 33, 24), span=4), _igrid(2, (3, 33, 24), span=4)
    want = _jax_grads(jt, x, wg, wu, impl_bwd)
    got = _torch_grads(tt, x, wg, wu, impl_bwd)
    for name, a, b in zip(("dx", "dWg", "dWu"), got, want):
        assert a.shape == b.shape
        _close(a.numpy(), b, 1e-4, name)


def test_wrapper_refuses_other_devices_and_shapes(monkeypatch):
    """Meta tensors stand for a device other than the CPU and CUDA, with
    the wrappers' shapes-only meta branch (``kernels/fused/meta.py``)
    switched off."""
    from repro_torch.kernels.fused import meta

    monkeypatch.setattr(meta, "is_meta", lambda t: False)
    _, t = _tables()
    x = torch.empty((2, 4, 8), device="meta")
    w = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfused.fused_moe_glu(x, w, w, table=t)
    with pytest.raises(ValueError, match=r"\(E, C, K\)"):
        tfused.fused_moe_glu(torch.ones(4, 8), torch.ones(8, 16), torch.ones(8, 16), table=t)


def test_launch_counters_do_not_move_on_cpu():
    _, t = _tables()
    before = (tfused.fused_moe_glu.launches, tfused.fused_moe_glu.bwd_launches)
    x = torch.ones(2, 3, 8, requires_grad=True)
    tfused.fused_moe_glu(x, torch.ones(2, 8, 4), torch.ones(2, 8, 4), table=t).sum().backward()
    assert (tfused.fused_moe_glu.launches, tfused.fused_moe_glu.bwd_launches) == before


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("epilogue", ["silu", "gelu_tanh", "exact silu", "identity"])
def test_empty_buckets_give_the_epilogue_on_zero_accumulators(epilogue, dtype):
    E, C, D, F = 4, 3, 48, 40
    x = _rand(11, (E, C, D), 2.0)
    x[1] = 0.0
    x[2] = -0.0
    x[3] = np.where(np.arange(D) % 2 == 0, np.float32(-0.0), np.float32(0.0))
    assert np.signbit(x[2]).all() and not np.signbit(x[1]).any()
    wg, wu, g = _rand(12, (E, D, F), 0.3), _rand(13, (E, D, F), 0.3), _rand(14, (E, C, F))
    if epilogue in ("silu", "gelu_tanh"):
        jt, tt = _tables(fn=epilogue)
        jkw, tkw = {"table": jt}, {"table": tt}
        plan, tabs = plan_and_operands(tt)
    elif epilogue == "exact silu":
        jkw = tkw = {"act": "silu"}
        plan, tabs = exact_plan("silu"), ()
    else:
        jkw = tkw = {}
        plan, tabs = plan_and_operands(None)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx, jwg, jwu = (jnp.asarray(a).astype(jdt) for a in (x, wg, wu))
    tx, twg, twu = (torch.from_numpy(a).to(tdt) for a in (x, wg, wu))
    fwd = {"jax": jfused.fused_moe_glu(jx, jwg, jwu, block=BLK, **jkw).astype(jnp.float32),
           "port": tfused.fused_moe_glu(tx, twg, twu, **tkw).float()}
    jplan, jtabs = jepi.plan_and_operands(jkw.get("table"), jkw.get("act"))
    bwd = {"jax": _moe_dz_3d(jx, jwg, jwu, jnp.asarray(g), jtabs, plan=jplan, block=BLK,
                             interpret=True),
           "port": tfused.fused_glu_bwd_plain(tx, twg, twu, torch.from_numpy(g), plan, tabs)}
    zero = torch.zeros((C, F))
    act, slope = plan.apply_value_and_slope(zero, *tabs)
    want_fwd = (act * zero).to(tdt).float()
    for e in (1, 2, 3):
        ge = torch.from_numpy(g[e])
        want = [want_fwd, ge * zero * slope, ge * act]
        for side in ("jax", "port"):
            got = [fwd[side][e], *(d[e] for d in bwd[side])]
            for name, a, b in zip(("out", "dzg", "dzu"), got, want):
                np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{side} {name} {e}")
