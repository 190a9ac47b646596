"""Port parity: the paper's SGD table fit (``repro_torch.core.fit``) against
the JAX package's ``repro.core.fit`` on the CPU.

Both packages get the same inputs through numpy, JAX's grid among them.

* ``pwl.linspace_f32`` within one ulp of max(|lo|, |hi|) of
  ``jnp.linspace(..., dtype=float32)`` (XLA contracts its products into
  FMAs where it vectorizes; the port rounds each), on the ranges and counts
  the fit, the uniform tables and the metrics use.
* ``_trapezoid_weights``, ``_effective_values`` (exp's right edge
  included), ``_loss_fn``'s value and its gradients in p and v, for all 8
  functions of ``gen_tables``: rtol 1e-5 (the gradients with an atol of
  1e-5 of their largest entry: entries ~1e-6 of it take the two packages'
  summation orders at ~1e-4 relative).
* ``_removal_losses`` and ``_insertion_losses``: rtol 1e-5, the same first
  argmin and argmax.
* One 50-step Adam chunk from the fit's own start (uniform p, exact v),
  lr 0.1.  Where every gradient entry stays away from 0 (silu, sigmoid,
  tanh, softplus) p and v agree to 5e-5 and the chunk's last loss to 2e-5
  (measured: 2.8e-5 and 1.1e-5).  Where a gradient entry is ~1e-9 (gelu,
  gelu_tanh and hardswish at their centre and tails, exp's flat tail)
  Adam's m/(√v + 1e-8) turns the packages' ~1e-11 gradient differences
  into steps of lr·Δg/1e-8, so there p and v agree to 3e-2 and the loss
  to 2e-2 (measured: 2.1e-2, 1.4e-2).
* ``curvature_init`` at 16 and 32 breakpoints for every function: within
  1e-3·(hi - lo).  In gelu_tanh's saturated tail torch's tanh' gives
  f'' ~ -2e-5 where JAX's is 0, and |f''|^½ lifts that to a density of
  ~5e-3 of the peak (measured: 3.9e-4·(hi - lo)).
* The Fig. 2 fit (gelu, 5 breakpoints on [-2, 2], 1200 steps, 2 rounds):
  the port's MSE within 5% of JAX's, at least 7x better than the uniform
  table, breakpoints strictly increasing, and the history labels JAX's
  (``init_train``, ``round0_rm2_ins1``, ``round1_rm2_ins1``).
* ``fit`` runs on ``cuda`` unless asked for the CPU, and raises without a
  GPU; its table comes back on the host.

Torch runs these on one thread: a fit is thousands of small ops, which
threads only slow down.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fit as jfit
from repro.core import functions as JF
from repro.core import pwl as jpwl
from repro_torch.core import fit as tfit
from repro_torch.core import functions as TF
from repro_torch.core import pwl as tpwl

FUNCTIONS = ["gelu", "gelu_tanh", "silu", "sigmoid", "tanh", "exp", "softplus", "hardswish"]
WELL_CONDITIONED = ("silu", "sigmoid", "tanh", "softplus")
N_BP = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _grid(fn: str, n_grid: int = 8192):
    """JAX's grid, its exact values and trapezoid weights, as numpy."""
    lo, hi = JF.get(fn).default_range
    x = jnp.linspace(lo, hi, n_grid, dtype=jnp.float32)
    return (np.asarray(x), np.asarray(JF.get(fn).fn(x)),
            np.asarray(jfit._trapezoid_weights(x)))


def _perturbed(fn: str, seed: int = 0):
    """Sorted breakpoints near uniform and values near f, as numpy."""
    rng = np.random.default_rng(seed)
    lo, hi = JF.get(fn).default_range
    p = np.asarray(jnp.linspace(lo, hi, N_BP, dtype=jnp.float32))
    p = np.sort(p + rng.normal(0, 0.1 * (hi - lo) / N_BP, N_BP)).astype(np.float32)
    v = (np.asarray(JF.get(fn).fn(jnp.asarray(p))) + rng.normal(0, 0.01, N_BP)).astype(np.float32)
    return p, v


def _slopes(fn: str, p):
    return (jpwl.boundary_slopes(JF.get(fn), jnp.asarray(p)),
            tpwl.boundary_slopes(TF.get(fn), _t(p)))


@pytest.mark.parametrize("lo,hi", [(-8.0, 8.0), (-10.0, 0.1), (-2.0, 2.0), (0.0, 1.0)])
@pytest.mark.parametrize("n", [2, 4, 5, 8, 16, 24, 25, 32, 64, 65, 4096, 8192])
def test_linspace_f32_within_one_ulp_of_jnp_linspace(lo, hi, n):
    want = np.asarray(jnp.linspace(lo, hi, n, dtype=jnp.float32))
    got = tpwl.linspace_f32(lo, hi, n).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    assert got[0] == np.float32(lo) and got[-1] == np.float32(hi)
    ulp = float(np.spacing(np.float32(max(abs(lo), abs(hi)))))
    assert np.max(np.abs(got.astype(np.float64) - want)) <= ulp
    assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_weights_values_loss_and_gradients_match_jax(fn):
    x, fx, w = _grid(fn)
    np.testing.assert_allclose(tfit._trapezoid_weights(_t(x)).numpy(), w, rtol=1e-5)
    p, v = _perturbed(fn)
    (jml, jmr), (tml, tmr) = _slopes(fn, p)
    assert (jml, jmr) == pytest.approx((tml, tmr), rel=1e-6)
    want = np.asarray(jfit._effective_values(JF.get(fn), jnp.asarray(p), jnp.asarray(v)))
    got = tfit._effective_values(TF.get(fn), _t(p), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if fn == "exp":  # the right end is a range edge: the exact value there
        assert got[-1] == pytest.approx(float(np.exp(p[-1])), rel=1e-6)

    def jloss(a, b):
        return jfit._loss_fn(JF.get(fn), jnp.asarray(x), jnp.asarray(fx), jnp.asarray(w),
                             a, b, jml, jmr)

    jl, (jgp, jgv) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(v))
    tp, tv = _t(p).requires_grad_(True), _t(v).requires_grad_(True)
    tl = tfit._loss_fn(TF.get(fn), _t(x), _t(fx), _t(w), tp, tv, tml, tmr)
    tgp, tgv = torch.autograd.grad(tl, (tp, tv))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for got, want in ((tgp.numpy(), np.asarray(jgp)), (tgv.numpy(), np.asarray(jgv))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert tgv[0] == 0 and tgv[-1] == 0  # v_0, v_{n-1} follow from p


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_removal_and_insertion_losses_match_jax(fn):
    x, fx, w = _grid(fn)
    p, v = _perturbed(fn, seed=1)
    (jml, jmr), (tml, tmr) = _slopes(fn, p)
    jargs = (jnp.asarray(x), jnp.asarray(fx), jnp.asarray(w), jml, jmr)
    targs = (_t(x), _t(fx), _t(w), tml, tmr)
    rm = jfit._removal_losses(JF.get(fn), jnp.asarray(p), jnp.asarray(v), None, *jargs)
    want = np.array([rm[i] for i in range(1, N_BP - 1)])
    got = tfit._removal_losses(TF.get(fn), _t(p), _t(v), None, *targs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(np.argmin(got)) + 1 == min(rm, key=rm.get)
    want = jfit._insertion_losses(JF.get(fn), jnp.asarray(p), jnp.asarray(v), None, *jargs)
    got = tfit._insertion_losses(TF.get(fn), _t(p), _t(v), None, *targs)
    assert got.shape == (N_BP - 1,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_one_adam_chunk_matches_jax(fn):
    x, fx, w = _grid(fn)
    lo, hi = JF.get(fn).default_range
    p = np.asarray(jnp.linspace(lo, hi, N_BP, dtype=jnp.float32))
    v = np.asarray(JF.get(fn).fn(jnp.asarray(p)))
    (jml, jmr), (tml, tmr) = _slopes(fn, p)
    jstate = (jnp.zeros(N_BP),) * 4 + (jnp.int32(0),)
    jp, jv, jst, jlast = jfit._adam_chunk(
        fn, 50, jnp.asarray(p), jnp.asarray(v), jstate, jnp.float32(0.1),
        jnp.asarray(x), jnp.asarray(fx), jnp.asarray(w), jml, jmr)
    tstate = tuple(torch.zeros(N_BP) for _ in range(4)) + (0,)
    tp, tv, tst, tlast = tfit._adam_chunk(
        TF.get(fn), 50, _t(p), _t(v), tstate, torch.tensor(0.1), _t(x), _t(fx), _t(w), tml, tmr)
    assert tst[4] == int(jst[4]) == 50
    assert torch.all(tp[1:] >= tp[:-1])  # re-sorted after every step
    tol, loss_tol = (5e-5, 2e-5) if fn in WELL_CONDITIONED else (3e-2, 2e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    assert float(tlast) == pytest.approx(float(jlast), rel=loss_tol)


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_curvature_init_matches_jax(fn):
    lo, hi = JF.get(fn).default_range
    for n in (16, 32):
        want = np.asarray(jfit.curvature_init(JF.get(fn), n, lo, hi))
        got = tfit.curvature_init(TF.get(fn), n, lo, hi).numpy()
        assert got.shape == (n,) and np.all(np.diff(got) > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * (hi - lo))


def test_interp_and_cumsum_match_numpy():
    rng = np.random.default_rng(2)
    xp = np.sort(rng.uniform(-3, 3, 50)).astype(np.float32)
    xp[10:13] = xp[10]  # a flat run, as a flat CDF has
    fp = np.cumsum(rng.uniform(0, 1, 50)).astype(np.float32)
    x = np.concatenate([rng.uniform(-4, 4, 200), xp]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    np.testing.assert_allclose(tfit.interp(_t(x), _t(xp), _t(fp)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    for n in (1, 63, 64, 65, 4096, 5000):
        a = rng.uniform(0, 1, n).astype(np.float32)
        np.testing.assert_allclose(tfit._cumsum(_t(a)).numpy(), np.cumsum(a.astype(np.float64)),
                                   rtol=1e-5)


def test_fig2_fit_matches_jax():
    """The paper's Fig. 2 setting: gelu, 5 breakpoints on [-2, 2]."""
    jcfg = jfit.FitConfig(max_steps=1200, max_rounds=2)
    tcfg = tfit.FitConfig(max_steps=1200, max_rounds=2)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = jfit.fit("gelu", 5, -2.0, 2.0, jcfg)
    got = tfit.fit("gelu", 5, -2.0, 2.0, tcfg, device="cpu")
    assert got.mse == pytest.approx(want.mse, rel=0.05)
    uniform = tpwl.mse(tpwl.make_uniform_table(TF.get("gelu"), 5, -2.0, 2.0), TF.get("gelu"),
                       -2.0, 2.0)
    assert uniform / got.mse >= 7.0
    bp = got.table.bp
    assert bp.device.type == "cpu" and got.table.m.device.type == "cpu"
    assert torch.all(bp[1:] > bp[:-1])
    labels = [h[0] for h in got.history]
    assert labels == [h[0] for h in want.history]
    assert labels == ["init_train", "round0_rm2_ins1", "round1_rm2_ins1"]
    assert got.n_breakpoints == 5 and got.range == (-2.0, 2.0)
    assert got.mae == pytest.approx(want.mae, rel=0.05)


def test_fit_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    import inspect

    assert inspect.signature(tfit.fit).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tfit.fit("tanh", 4, cfg=tfit.FitConfig(max_steps=50, max_rounds=0))
