"""Port parity: the MoE layer (``repro_torch.models.moe.moe_layer``) against
the JAX package's ``moe_layer`` on the reduced olmoe-1b-7b config (d_model
64, 8 experts, top 2), in float32, on the same numpy inputs and weights.

The output y at 1e-5 and the load-balancing loss at 1e-4 (sums in another
order), for the fused plan (the per-expert GLU's plain version) and the
exact one, and:

* a call of 4 tokens, whose capacity of 1 drops pairs;
* a zeroed router: every probability ties, so both packages route every
  token to experts 0 and 1 (``lax.top_k`` gives the lower index first) and
  the capacity drops the rest;
* the gradients of x and of every weight through the layer against
  ``jax.grad`` at 1e-4 of each one's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced_config
from repro_torch.models import moe

NAMES = ("router", "w_gate", "w_up", "w_down")


def _configs(impl):
    return (j_get_reduced_config("olmoe-1b-7b", act_impl=impl, dtype=jnp.float32),
            get_reduced_config("olmoe-1b-7b", act_impl=impl, dtype=torch.float32))


def _inputs(cfg, B, S, seed=0, router_scale=0.5):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    params = {
        "router": rng.standard_normal((D, E)) * router_scale,
        "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
        "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
        "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return params, x


def _both(impl, params, x):
    jcfg, tcfg = _configs(impl)
    jy, jaux = jmoe.moe_layer(jcfg, {k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x))
    ty, taux = moe.moe_layer(tcfg, {k: torch.from_numpy(v) for k, v in params.items()},
                             torch.from_numpy(x))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _assert_match(impl, params, x):
    (jy, jaux), (ty, taux) = _both(impl, params, x)
    assert ty.shape == x.shape and ty.dtype == np.float32
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-4)
    return ty


def _dropped(cfg, params, x) -> int:
    """Pairs past their expert's capacity in a call over ``x``."""
    T = x.shape[0] * x.shape[1]
    _, _, top_e = moe.route(cfg, torch.from_numpy(params["router"]),
                            torch.from_numpy(x.reshape(T, -1)))
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    return int((counts - moe.capacity(cfg, T)).clamp(min=0).sum())


@pytest.mark.parametrize("impl", ["fused", "exact"])
@pytest.mark.parametrize("B,S", [(2, 16), (1, 37)])
def test_layer_matches_jax(impl, B, S):
    params, x = _inputs(_configs(impl)[1], B, S)
    _assert_match(impl, params, x)


@pytest.mark.parametrize("impl", ["fused", "exact"])
def test_capacity_drops_match_jax(impl):
    tcfg = _configs(impl)[1]
    params, x = _inputs(tcfg, 1, 4, seed=3)
    assert moe.capacity(tcfg, 4) == 1
    assert _dropped(tcfg, params, x) > 0
    _assert_match(impl, params, x)


@pytest.mark.parametrize("impl", ["fused", "exact"])
def test_zero_router_ties_pick_the_first_experts_as_jax(impl):
    tcfg = _configs(impl)[1]
    params, x = _inputs(tcfg, 2, 16, seed=4)
    params["router"][:] = 0.0
    _, top_w, top_e = moe.route(tcfg, torch.from_numpy(params["router"]),
                                torch.from_numpy(x.reshape(32, -1)))
    assert (top_e == torch.tensor([0, 1])).all() and (top_w == 0.5).all()
    assert _dropped(tcfg, params, x) == 2 * (32 - moe.capacity(tcfg, 32))
    y = _assert_match(impl, params, x)
    # tokens past capacity 10 on both experts get nothing from the FFN
    assert not y.reshape(32, -1)[moe.capacity(tcfg, 32):].any()


@pytest.mark.parametrize("impl", ["fused", "exact"])
def test_layer_gradients_match_jax(impl):
    jcfg, tcfg = _configs(impl)
    params, x = _inputs(tcfg, 2, 16, seed=5)

    def jloss(p, x):
        y, aux = jmoe.moe_layer(jcfg, p, x)
        return jnp.sum(jnp.cos(y)) + aux

    want = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in params.items()},
                                           jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_layer(tcfg, tp, tx)
    (torch.cos(y).sum() + aux).backward()
    pairs = [(tx.grad, want[1], "x")] + [(tp[k].grad, want[0][k], k) for k in NAMES]
    for got, w, name in pairs:
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), w, atol=1e-4 * scale, rtol=1e-4, err_msg=name)
