"""Port parity: the Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, in float32, on the CPU, at 1e-5.

* ``_causal_conv``, ``_segsum_exp`` and ``ssd_chunked`` (a chunk multiple,
  and a length that pads its last chunk; the final state too).
* ``mamba2_layer`` on one layer of reduced mamba2-2.7b's JAX init, with
  ``A_log``, ``dt_bias``, ``D``, ``conv_b`` and ``norm_scale`` redrawn from a
  seeded numpy generator (JAX makes them zeros and ones, which would hide a
  mix-up of heads or channels): the forward, a prefill into a cache (its
  conv tail and state, also for L < K - 1, which left-pads the tail), and
  decode steps after it, the cache written in place.
* At S = 256 and chunk 128 with dt·A = -0.8 a step, JAX's gradient of
  ``ssd_chunked`` is NaN (``_segsum_exp`` exponentiates the upper triangle,
  which overflows, before masking it).  The forward there still equals
  JAX's, and the port's gradient is finite and within 1e-4 of a sequential
  recurrence in f64 written here (h_t = e^{a_t} h_{t-1} + B_t x_t,
  y_t = C_t·h_t + D x_t); where JAX's gradient is finite, it equals the
  port's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sfu as jsfu
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro_torch import sfu
from repro_torch.configs import get_reduced_config
from repro_torch.models import ssm

TOL = dict(atol=1e-5, rtol=1e-5)
j_ssd = jax.jit(jssm.ssd_chunked, static_argnames="chunk")


def _rand(seed, shape, scale=1.0, loc=0.0):
    return (loc + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def test_causal_conv_matches_jax():
    x, w, b = _rand(0, (2, 11, 7)), _rand(1, (4, 7)), _rand(2, (7,))
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm._causal_conv(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segsum_exp_matches_jax():
    a = -np.abs(_rand(3, (2, 3, 16)))
    want = jssm._segsum_exp(jnp.asarray(a))
    got = ssm._segsum_exp(_t(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.triu(got.numpy(), 1).any()


def _ssd_inputs(seed, b, l, h, p, n, a_scale=0.3):
    xdt = _rand(seed, (b, l, h, p))
    a = -np.abs(_rand(seed + 1, (b, l, h), a_scale))
    return xdt, a, _rand(seed + 2, (b, l, n)), _rand(seed + 3, (b, l, n))


@pytest.mark.parametrize("l, chunk", [(32, 8), (30, 8), (5, 8), (24, 24)])
def test_ssd_chunked_matches_jax(l, chunk):
    """A chunk multiple, and lengths that pad the last chunk."""
    args = _ssd_inputs(4, 2, l, 3, 4, 5)
    want_y, want_h = j_ssd(*map(jnp.asarray, args), chunk=chunk)
    got_y, got_h = ssm.ssd_chunked(*map(_t, args), chunk=chunk)
    assert got_y.shape == (2, l, 3, 4) and got_h.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


# ---------------------------------------------------------------------------
# mamba2_layer


def redraw_ssm_vectors(tree_np, seed=7):
    """The JAX tree's SSM vectors, drawn afresh from a seeded generator in
    place: ``A_log`` in [-1, 0.5] (A in [0.37, 1.65]), ``dt_bias`` around
    -1, ``D`` around 1, ``conv_b`` and ``norm_scale`` small."""
    rng = np.random.default_rng(seed)
    draws = {"A_log": lambda s: rng.uniform(-1.0, 0.5, s),
             "dt_bias": lambda s: rng.normal(-1.0, 0.5, s),
             "D": lambda s: rng.normal(1.0, 0.3, s),
             "conv_b": lambda s: rng.normal(0.0, 0.1, s),
             "norm_scale": lambda s: rng.normal(0.0, 0.1, s)}
    for slot in tree_np["layers"]:
        if "A_log" in slot["mixer"]:
            for name, draw in draws.items():
                slot["mixer"][name] = draw(slot["mixer"][name].shape).astype(np.float32)
    return tree_np


@pytest.fixture(scope="module")
def layer():
    jcfg = j_get_reduced_config("mamba2-2.7b", act_impl="jnp", dtype=jnp.float32,
                                ssm_chunk=8)
    tcfg = get_reduced_config("mamba2-2.7b", act_impl="jnp", dtype=torch.float32, ssm_chunk=8)
    tree_np = redraw_ssm_vectors(jax.tree_util.tree_map(
        np.asarray, jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))))
    mixer = {k: v[1] for k, v in tree_np["layers"][0]["mixer"].items()}  # the second layer
    jlayer = jax.jit(functools.partial(jssm.mamba2_layer, jcfg, plan=jsfu.plan_for(jcfg)))
    return jlayer, tcfg, mixer


def _run_both(layer, x, jcache=None, tcache=None):
    jlayer, tcfg, mixer = layer
    jy, jnew = jlayer({k: jnp.asarray(v) for k, v in mixer.items()}, jnp.asarray(x), jcache)
    ty, tnew = ssm.mamba2_layer(tcfg, {k: _t(v) for k, v in mixer.items()}, _t(x), tcache,
                                plan=sfu.plan_for(tcfg))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    return jnew, tnew


def _empty_caches(tcfg, B):
    _, H, N, C, _ = ssm.ssm_dims(tcfg)
    K = tcfg.ssm_conv_dim
    jcache = {"conv": jnp.zeros((B, K - 1, C), jnp.float32),
              "ssm": jnp.zeros((B, H, tcfg.ssm_head_dim, N), jnp.float32)}
    tcache = {"conv": torch.zeros((B, K - 1, C)),
              "ssm": torch.zeros((B, H, tcfg.ssm_head_dim, N))}
    return jcache, tcache


def _assert_caches(jcache, tcache):
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL,
                                   err_msg=name)


def test_mamba2_layer_forward_matches_jax(layer):
    _, tcfg, _ = layer
    jnew, tnew = _run_both(layer, _rand(10, (2, 21, tcfg.d_model)))
    assert jnew is None and tnew is None


@pytest.mark.parametrize("L", [19, 2, 1])
def test_mamba2_layer_prefill_then_decode_matches_jax(layer, L):
    """A prefill of L tokens into an empty cache (L = 2 < K - 1 left-pads the
    conv tail; L = 1 with a cache is a decode step from the empty cache),
    then 4 decode steps; the cache is written in place."""
    _, tcfg, _ = layer
    B = 2
    jcache, tcache = _empty_caches(tcfg, B)
    views = dict(tcache)
    jcache, tnew = _run_both(layer, _rand(11, (B, L, tcfg.d_model)), jcache, tcache)
    assert tnew is tcache and all(tcache[k] is views[k] for k in views)
    _assert_caches(jcache, tcache)
    for i in range(4):
        jcache, _ = _run_both(layer, _rand(20 + i, (B, 1, tcfg.d_model)), jcache, tcache)
        _assert_caches(jcache, tcache)


# ---------------------------------------------------------------------------
# the SSD gradient at a training length


def _sequential_f64(xdt, a, Bm, Cm, D, x):
    """The recurrence one step at a time in f64: y_t = C_t·h_t + D x_t."""
    b, l, h, p = xdt.shape
    hs = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(l):
        hs = torch.exp(a[:, t])[:, :, None, None] * hs + \
            xdt[:, t, :, :, None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hs, Cm[:, t]) + D[None, :, None] * x[:, t])
    return torch.stack(ys, dim=1)


def _layer_out(fn, xdt, a, Bm, Cm, D, x, chunk):
    y, _ = fn(xdt, a, Bm, Cm, chunk=chunk)
    return y + D[None, None, :, None] * x


@pytest.mark.parametrize("a_mean, chunk", [(-0.8, 128), (-0.3, 128), (-0.8, 32)])
def test_ssd_gradient_at_a_training_length(a_mean, chunk):
    """S = 256.  At dt·A = -0.8 and chunk 128 a chunk's Σ|a| is ~102, past
    exp's f32 range: JAX's gradient of ``a`` is NaN, the port's finite and
    the sequential f64 recurrence's; at -0.3, or at chunk 32, JAX's is finite
    too and equals the port's."""
    b, l, h, p, n = 1, 256, 2, 3, 4
    xdt, _, Bm, Cm = _ssd_inputs(30, b, l, h, p, n)
    a = (a_mean + 0.05 * _rand(35, (b, l, h))).astype(np.float32)
    D, x, g = _rand(36, (h,), 0.3, 1.0), _rand(37, (b, l, h, p)), _rand(38, (b, l, h, p))
    args = (xdt, a, Bm, Cm, D, x)

    def jloss(*ins):
        y = _layer_out(jssm.ssd_chunked, *ins, chunk)
        return jnp.sum(y * g), y

    (_, jy), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True))(
        *map(jnp.asarray, args))

    tin = [_t(v).requires_grad_(True) for v in args]
    ty = _layer_out(ssm.ssd_chunked, *tin, chunk)
    tgrads = torch.autograd.grad((ty * _t(g)).sum(), tin)
    # a chunk's cumulative a reaches ~-100, whose f32 rounding (~4e-6) both
    # packages' exp(a_cum) carry: 1e-4 here, as against the f64 recurrence
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)

    rin = [torch.from_numpy(np.asarray(v, np.float64)).requires_grad_(True) for v in args]
    ry = _sequential_f64(*rin)
    rgrads = torch.autograd.grad((ry * torch.from_numpy(g.astype(np.float64))).sum(), rin)
    np.testing.assert_allclose(ty.detach().numpy(), ry.detach().numpy(), atol=1e-4, rtol=1e-4)

    jax_nan = not np.isfinite(np.asarray(jgrads[1])).all()
    assert jax_nan == (a_mean == -0.8 and chunk == 128)
    for i, (tg, rg, jg) in enumerate(zip(tgrads, rgrads, jgrads)):
        assert torch.isfinite(tg).all(), f"input {i}"
        scale = float(rg.abs().max())
        np.testing.assert_allclose(tg.numpy() / scale, rg.numpy() / scale, atol=1e-4,
                                   rtol=1e-4, err_msg=f"input {i} against f64")
        if not jax_nan:
            np.testing.assert_allclose(tg.numpy() / scale, np.asarray(jg) / scale, atol=1e-5,
                                       rtol=1e-5, err_msg=f"input {i} against JAX")
