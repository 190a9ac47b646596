"""Port parity: the reduced olmoe-1b-7b model (2 layers, d_model 64, 8
experts top 2, SwiGLU experts) of ``repro_torch`` against the JAX ``Model``
on converted parameters, in float32, on the CPU, under the fused plan
(the ``moe.expert:silu`` site on the per-expert GLU's plain version and its
backward).

* Logits through ``forward`` and through ``prefill_paged`` /
  ``decode_step_paged`` at 1e-4 (sums in another order).
* The loss, its nll and its MoE aux loss, and every gradient leaf of
  ``Model.loss`` against ``jax.value_and_grad`` of the JAX loss: at 1e-4,
  each leaf on the scale of its max.  The router is f32 in both trees.
* Three steps of ``build_train_step`` against the JAX package's jitted
  train step on a one-device mesh: losses and gradient norms at rel 1e-4,
  and the parameters after three steps within ``3·2·lr`` elementwise (the
  AdamW reasoning of ``tests/test_torch_train_parity.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro  # noqa: F401
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import Model as JModel
from repro.models import ShapeCell
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, params_from_numpy, train_state_from_numpy
from repro_torch.optim import adamw

B, S = 2, 24
LR = 1e-3
N_STEPS = 3
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_reduced_config("olmoe-1b-7b", act_impl="fused", dtype=jnp.float32)
    tcfg = get_reduced_config("olmoe-1b-7b", act_impl="fused", dtype=torch.float32)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    data = SyntheticLMData(DataConfig(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=B))
    return jcfg, tcfg, jparams, data


def _serving_params(tcfg, jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")


def test_router_stays_f32_in_the_serving_tree(setup):
    _, tcfg, jparams, _ = setup
    bf16 = get_reduced_config("olmoe-1b-7b", act_impl="fused")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), bf16, "cpu")
    ffn = params["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16
    assert ffn["w_gate"].shape == (tcfg.n_layers, 8, 64, 64)
    np.testing.assert_array_equal(ffn["router"].numpy(),
                                  np.asarray(jparams["layers"][0]["ffn"]["router"]))


def test_forward_logits_match(setup):
    jcfg, tcfg, jparams, data = setup
    toks = data.batch_at(0)["tokens"]
    want, _ = JModel(jcfg).forward(jparams, {"tokens": jnp.asarray(toks)})
    got = Model(tcfg, device="cpu").forward(_serving_params(tcfg, jparams),
                                            torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_prefill_and_decode_logits_match(setup):
    jcfg, tcfg, jparams, _ = setup
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    tparams = _serving_params(tcfg, jparams)
    ps, P, n = 16, 9, 20  # a 20-token prompt in a 32-token bucket
    table = np.asarray([[3, 5, 0]], np.int32)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=n)
    lens = np.asarray([n], np.int32)
    jcache = jmodel.make_paged_cache(P, ps)
    jlog, jcache = jmodel.prefill_paged(jparams, jnp.asarray(toks), jcache,
                                        jnp.asarray(table[:, :2]), jnp.asarray(lens))
    tcache = tmodel.make_paged_cache(P, ps)
    tlog = tmodel.prefill_paged(tparams, torch.from_numpy(toks), tcache,
                                torch.from_numpy(table[:, :2]), torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    cur = np.asarray(jnp.argmax(jlog[:, 0], -1)).astype(np.int32)
    kv = lens.copy()
    for _ in range(3):
        jlog, jcache = jmodel.decode_step_paged(jparams, jnp.asarray(cur[:, None]), jcache,
                                                jnp.asarray(table), jnp.asarray(kv))
        tlog = tmodel.decode_step_paged(tparams, torch.from_numpy(cur[:, None]), tcache,
                                        torch.from_numpy(table), torch.from_numpy(kv))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        cur = np.asarray(jnp.argmax(jlog[:, 0], -1)).astype(np.int32)
        kv = kv + 1


def test_loss_aux_and_every_gradient_match_jax(setup):
    jcfg, tcfg, jparams, data = setup
    batch = data.batch_at(0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JModel(jcfg).loss(p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    masters = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu",
                                master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, metrics = Model(tcfg, device="cpu").loss(
        masters, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(metrics["nll"].item(), float(jmetrics["nll"]), rtol=1e-4)
    np.testing.assert_allclose(metrics["aux"].item(), float(jmetrics["aux"]), rtol=1e-4)
    assert metrics["aux"].item() > 1.0  # two layers, each E·Σ f·p >= 1 at balance
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=f"gradient leaf {i}")


def test_three_train_steps_match_jax(setup):
    jcfg, tcfg, jparams, data = setup
    opt = dict(lr=LR, total_steps=N_STEPS, warmup_steps=1)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    fn, in_sh, out_sh, _, _ = j_build_train_step(
        jcfg, mesh, ShapeCell("host", S, B, "train"), opt_cfg=jadamw.AdamWConfig(**opt),
        microbatches=1)
    jstep = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    jstate = jadamw.init_state(jparams)
    tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    tstep = build_train_step(tcfg, "cpu", opt_cfg=adamw.AdamWConfig(**opt))
    for step in range(N_STEPS):
        batch = data.batch_at(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == N_STEPS
    for got, want in zip(tree.leaves(tstate["params"]),
                         jax.tree_util.tree_leaves(jstate["params"])):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= N_STEPS * 2 * LR
        assert np.median(diff) <= 1e-6
