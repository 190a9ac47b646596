"""Port parity: ``repro_torch.sfu.guard`` against ``repro.sfu.guard`` on the
same numpy inputs: the clamp and non-finite counts of ``wrap_elementwise``
and ``check_fused``, the NaN fault hook with the guard off, the warn-once
latch, and the plan's wrapped activations.  With no collector and no armed
fault every hook must hand back its input and dispatch no operation.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro  # noqa: F401
from repro import sfu as jsfu
from repro_torch import sfu

KEY = "mlp:gelu_tanh"


class _Ops(TorchDispatchMode):
    """Records every operation dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _inputs(seed, shape=(6, 37)):
    x = (np.random.default_rng(seed).standard_normal(shape) * 5).astype(np.float32)
    x.flat[3], x.flat[10], x.flat[11] = np.nan, np.inf, -np.inf
    return x


def _both(fn_j, fn_t, x, resolve=False):
    """[clamped, nonfinite] of one collected call in each package; with
    ``resolve`` the two are factories called inside the collector, as the
    model layers resolve a plan's activation inside each model call."""
    with jsfu.guard.collecting() as jcol:
        jy = (fn_j() if resolve else fn_j)(jnp.asarray(x))
    with sfu.guard.collecting() as tcol:
        ty = (fn_t() if resolve else fn_t)(torch.from_numpy(x))
    jr, tr = jcol.result(), tcol.to_host()
    assert sorted(jr) == sorted(tr)
    return ({k: np.asarray(v).tolist() for k, v in jr.items()},
            {k: v.tolist() for k, v in tr.items()}, np.asarray(jy), ty.numpy())


@pytest.mark.parametrize("lo,hi", [(-4.0, 4.0), (-8.0, 0.1), (0.0, 0.0), (-np.inf, np.inf)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrap_elementwise_counts_equal_jax(seed, lo, hi):
    x = _inputs(seed)
    jw = jsfu.guard.wrap_elementwise(KEY, lambda a: a * 2.0, lo, hi)
    tw = sfu.guard.wrap_elementwise(KEY, lambda a: a * 2.0, lo, hi)
    want, got, jy, ty = _both(jw, tw, x)
    assert got == want
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("clamped", [None, 5])
@pytest.mark.parametrize("seed", [3, 4])
def test_check_fused_counts_equal_jax(seed, clamped):
    x = _inputs(seed)
    jc = None if clamped is None else jnp.int32(clamped)
    tc = None if clamped is None else torch.tensor(clamped, dtype=torch.int32)
    want, got, jy, ty = _both(lambda a: jsfu.guard.check_fused(KEY, a, jc),
                              lambda a: sfu.guard.check_fused(KEY, a, tc), x)
    assert got == want == {KEY: [clamped or 0, 3]}
    np.testing.assert_array_equal(ty, jy)


def test_counts_sum_over_hooks_per_site():
    x = _inputs(5)
    with sfu.guard.collecting() as col:
        for _ in range(3):
            sfu.guard.check_fused(KEY, torch.from_numpy(x))
        sfu.guard.wrap_elementwise("attn.softmax:exp", torch.exp, -1.0, 1.0)(
            torch.from_numpy(x))
    got = {k: v.tolist() for k, v in col.to_host().items()}
    outside = int(np.sum((x < -1.0) | (x > 1.0)))
    with np.errstate(over="ignore"):
        exp_nonfinite = int(np.sum(~np.isfinite(np.exp(x))))
    assert got == {KEY: [0, 9], "attn.softmax:exp": [outside, exp_nonfinite]}
    assert not sfu.guard.active()


@pytest.mark.parametrize("hook", ["check_fused", "wrap_elementwise"])
def test_no_collector_passes_through_and_dispatches_nothing(hook):
    y = torch.randn(4, 9)
    fn = (lambda t: sfu.guard.check_fused(KEY, t)) if hook == "check_fused" else \
        sfu.guard.wrap_elementwise(KEY, lambda t: t, -1.0, 1.0)
    with _Ops() as mode:
        out = fn(y)
    assert out is y
    assert mode.ops == []
    with sfu.guard.force_nan("attn.softmax:exp"), _Ops() as mode:  # armed for another site
        out = fn(y)
    assert out is y and mode.ops == []


def test_force_nan_fires_with_the_guard_off():
    x = np.random.default_rng(6).standard_normal((3, 5, 7)).astype(np.float32)
    xt = torch.from_numpy(x.copy())
    view = xt.transpose(0, 1)  # not contiguous: element 0 is still the logical first
    with jsfu.guard.force_nan(KEY):
        want = np.asarray(jsfu.guard.check_fused(KEY, jnp.asarray(x.transpose(1, 0, 2))))
    with sfu.guard.force_nan(KEY):
        got = sfu.guard.check_fused(KEY, view)
        other = sfu.guard.check_fused("moe.expert:silu", view)
    assert other is view
    assert np.isnan(got[0, 0, 0].item()) and int(torch.isnan(got).sum()) == 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(xt.numpy(), x)  # the input is untouched
    assert sfu.guard.check_fused(KEY, view) is view  # disarmed on exit


def test_force_nan_counts_under_a_collector():
    with sfu.guard.force_nan(KEY), sfu.guard.collecting() as col:
        sfu.guard.check_fused(KEY, torch.zeros(8))
    assert col.to_host()[KEY].tolist() == [0, 1]


def test_warn_nonfinite_once_per_site_without_the_word_fused():
    sfu.reset_all_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            sfu.guard.warn_nonfinite(KEY, "jnp")
        sfu.guard.warn_nonfinite("attn.softmax:exp", "exact")
        sfu.guard.warn_nonfinite(KEY, "exact")
    msgs = [str(w.message) for w in caught]
    assert len(msgs) == 2
    assert all("fused" not in m.lower() for m in msgs)
    assert KEY in msgs[0] and "impl='jnp'" in msgs[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sfu.guard.reset_guard_warnings()
        sfu.guard.warn_nonfinite(KEY, "jnp")
    assert len(caught) == 1


def test_reset_all_warnings_resets_both_latches():
    sfu.reset_all_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sfu.warn_fused_fallback(KEY, "first")
        sfu.guard.warn_nonfinite(KEY, "jnp")
        sfu.warn_fused_fallback(KEY, "latched")
        sfu.guard.warn_nonfinite(KEY, "jnp")
        sfu.reset_all_warnings()
        sfu.warn_fused_fallback(KEY, "again")
        sfu.guard.warn_nonfinite(KEY, "jnp")
    assert [("fused" in str(w.message)) for w in caught] == [True, False, True, False]
    sfu.reset_all_warnings()


@pytest.mark.parametrize("impl", ["jnp", "kernel", "exact"])
def test_plan_act_counts_equal_jax(impl):
    spec = dict(fn="gelu_tanh", n_segments=33, impl=impl)
    jplan = jsfu.ActivationPlan(sites=((KEY, jsfu.ApproxSpec(**spec)),))
    tplan = sfu.ActivationPlan(sites=((KEY, sfu.ApproxSpec(**spec)),))
    x = _inputs(7, (4, 256))
    want, got, jy, ty = _both(lambda: jplan.act(KEY), lambda: tplan.act(KEY), x, resolve=True)
    assert got == want
    if impl == "exact":
        assert got == {}
    else:
        assert got[KEY][0] > 0 and got[KEY][1] >= 3


def test_plan_act_comes_bare_with_the_guard_off():
    tplan = sfu.ActivationPlan(sites=((KEY, sfu.ApproxSpec(fn="gelu_tanh", impl="jnp")),))
    x = torch.from_numpy(_inputs(8))
    bare = tplan.act(KEY)
    with sfu.guard.collecting() as col:
        guarded = tplan.act(KEY)
        y = guarded(x)
    assert bare.__name__ == "pwl_act" and guarded.__name__ == "guarded"
    assert torch.equal(bare(x).nan_to_num(), y.nan_to_num())
    assert KEY in col.to_host()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("moe", [False, True])
def test_unfused_table_glu_rounds_once_as_the_kernel(dtype, moe):
    """The degrade ladder's first rung (the table unfused) computes the GLU
    hidden as the fused kernel does, in f32 rounded once: within one ulp
    of the kernel's plain version in every element, where the expression
    rounded after each operation is further.  (In f32 the two differ by
    the summation order alone: the engine sessions hold that against JAX.)"""
    from repro_torch.kernels import fused
    from repro_torch.models import layers

    plan = sfu.ActivationPlan(sites=((KEY, sfu.ApproxSpec(fn="gelu_tanh", impl="jnp")),))
    table = sfu.get_store().get(plan.spec(KEY))
    g = torch.Generator().manual_seed(3)
    lead = (3, 5) if moe else (7,)
    x = torch.randn(*lead, 96, generator=g).to(dtype)
    wshape = (3, 96, 160) if moe else (96, 160)
    wg, wu = (torch.randn(*wshape, generator=g).mul(0.2).to(dtype) for _ in range(2))
    kernel = (fused.fused_moe_glu if moe else fused.fused_glu)(x, wg, wu, table=table)
    got = layers.plain_glu(plan.act(KEY), x, wg, wu)
    assert got.dtype == dtype
    ulp = torch.finfo(dtype).eps * kernel.float().abs()
    err = (got.float() - kernel.float()).abs()
    assert bool((err <= ulp + torch.finfo(dtype).tiny).all())
    rounded = plan.act(KEY)(x @ wg) * (x @ wu)
    assert float((rounded.float() - kernel.float()).abs().max()) > float(err.max())
