"""Port parity: reduced jamba-v0.1-52b (8 layers in one period: SSM layers
with attention at layer 4, MoE FFNs at the odd layers, dense GLUs at the
even ones; d_model 64, 4 heads with 2 KV heads, 4 experts top 2) of
``repro_torch`` against the JAX ``Model`` on converted parameters, in
float32, on the CPU, under the fused-softmax plan (the GLU, the MoE GLU and
the row softmax on their kernels' plain versions; ``ssm:silu`` pinned
exact, ``ssm:softplus`` the jnp PWL evaluation), at 1e-4.  The JAX tree's
SSM vectors are redrawn from a seeded numpy generator first.

* The reduced config equals JAX's; the full width is refused and names
  distribution.
* Logits, the loss (nll and the MoE aux loss) and every gradient leaf.
* A dense prefill, then decode steps: the cache holds {conv, ssm} in the
  SSM slots and {k, v} in the attention slot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ssm import redraw_ssm_vectors

import repro  # noqa: F401
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.models import Model as JModel
from repro_torch import tree
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import Model, params_from_numpy

ARCH = "jamba-v0.1-52b"
B, S = 2, 24
TOL = dict(atol=1e-4, rtol=1e-4)
PLAN = dict(act_impl="fused", pwl_softmax=True)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_reduced_config(ARCH, dtype=jnp.float32, **PLAN)
    tcfg = get_reduced_config(ARCH, dtype=torch.float32, **PLAN)
    tree_np = redraw_ssm_vectors(jax.tree_util.tree_map(
        np.asarray, jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree_np)
    return jcfg, tcfg, jparams, tree_np


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def test_reduced_config_is_the_jax_config_and_full_width_waits():
    t, j = get_reduced_config(ARCH), j_get_reduced_config(ARCH)
    for f in dataclasses.fields(t):
        if f.name in ("dtype", "act_plan", "act_site_specs"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert [(k, s.to_json()) for k, s in t.act_site_specs] == \
        [(k, s.to_json()) for k, s in j.act_site_specs]
    assert t.layer_kinds == j.layer_kinds and t.period == j.period == 8
    assert [m for m, _ in t.layer_kinds].count("attn") == 1
    with pytest.raises(ValueError, match="distribution.*102.9 GB"):
        get_config(ARCH)


def test_forward_logits_match(setup):
    jcfg, tcfg, jparams, tree_np = setup
    toks = _tokens(0, (B, S))
    want, _ = jax.jit(JModel(jcfg).forward)(jparams, {"tokens": jnp.asarray(toks)})
    got = Model(tcfg, device="cpu").forward(params_from_numpy(tree_np, tcfg, "cpu"),
                                            torch.from_numpy(toks))
    assert got.shape == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_and_every_gradient_match_jax(setup):
    jcfg, tcfg, jparams, tree_np = setup
    toks = _tokens(1, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JModel(jcfg).loss(p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    masters = params_from_numpy(tree_np, tcfg, "cpu", master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, metrics = Model(tcfg, device="cpu").loss(
        masters, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for key in ("nll", "aux"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-4)
    assert metrics["aux"].item() > 0
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=f"gradient leaf {i}")


def test_dense_prefill_and_decode_logits_match(setup):
    jcfg, tcfg, jparams, tree_np = setup
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    tparams = params_from_numpy(tree_np, tcfg, "cpu")
    n, steps = 12, 4
    toks = _tokens(2, (B, n))
    T = n + steps
    jlog, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks), jmodel.make_cache(B, T))
    tcache = tmodel.make_cache(B, T)
    kinds = [m for m, _ in tcfg.layer_kinds]
    assert [sorted(c) for c in tcache] == [["k", "v"] if m == "attn" else ["conv", "ssm"]
                                           for m in kinds]
    tlog = tmodel.prefill(tparams, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    decode = jax.jit(jmodel.decode_step)
    cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = decode(jparams, jnp.asarray(cur), jcache, jnp.int32(n + i))
        tlog = tmodel.decode_step(tparams, torch.from_numpy(cur), tcache, n + i)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for got, want in zip(tree.leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
