"""Port parity: reduced gemma3-1b (6 layers, 5 local : 1 global, window 16,
GQA 4:1, head dim 16, GeGLU, tied embeddings) of ``repro_torch`` against
the JAX ``Model`` on converted parameters, in float32, on the CPU.

* Logits at S = 24 (within twice the window: the dense row softmax under
  the fused-softmax plan) and S = 64 (past it: the banded flash branch, and
  the fused flash kernel's plain version with the window), under the exact
  plan and under the fused-softmax plan.
* A dense prefill, then decode steps past the local layers' 16-slot ring's
  wrap, step by step against JAX's ``prefill`` / ``decode_step``: a
  10-token prompt (the ring fills during decode) and a 20-token prompt (the
  prefill keeps its last 16 tokens, rolled by 20 % 16), and the caches
  after the prefill.
* The plain ``flash_attention`` with a window against JAX's (1e-5, the JAX
  suite's tolerance for its flash paths), banded, padded and non-causal.
* Every gradient of the loss, and three train steps, against JAX's.
* ``serve --arch gemma3-1b --reduced --device cpu`` asks for the paged
  cache, says on stderr that it runs dense mode, and generates JAX's dense
  ``generate`` tokens from the same weights.

The reduced model at init is ill-conditioned: scaling its embedding by
``1 + 1e-7·N(0, 1)`` (f32 rounding) moves the logits at S = 64 by ~5e-4
in either package, above 1e-4.  So, as ``tests/test_torch_train_parity.py``
does for full-width gradients, the model-level comparisons hold the port
within 1e-4 or within 4 times JAX's own change when every JAX weight is
scaled by ``1 + 1e-7·N(0, 1)``, whichever is larger; the tests print both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro  # noqa: F401
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.launch.serve import generate as j_generate
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import Model as JModel
from repro.models import ShapeCell
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch import serve
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, layers, params_from_numpy, train_state_from_numpy
from repro_torch.models.transformer import make_cache
from repro_torch.optim import adamw

PLANS = {"exact": dict(act_impl="fused"), "fused_softmax": dict(act_impl="fused",
                                                                pwl_softmax=True)}
B = 2
LR = 1e-3
N_STEPS = 3


def _configs(plan):
    kw = PLANS[plan]
    return (j_get_reduced_config("gemma3-1b", dtype=jnp.float32, **kw),
            get_reduced_config("gemma3-1b", dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _configs("exact")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _nudged(jparams):
    """JAX's weights each scaled by ``1 + 1e-7·N(0, 1)``: f32 rounding."""
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-7 * rng.standard_normal(a.shape).astype(np.float32)), jparams)


def _atol(want, nudged) -> float:
    """1e-4, or 4 times JAX's own change under the nudge."""
    return max(1e-4, 4 * float(np.abs(np.asarray(nudged) - np.asarray(want)).max()))


def _assert_close(got, want, nudged, what):
    atol = _atol(want, nudged)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(f"{what}: port vs jax {err:.3g}, tolerance {atol:.3g}")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=1e-4,
                               err_msg=what)


def test_reduced_config_layers():
    _, tcfg = _configs("exact")
    assert tcfg.sliding_window == 16 and tcfg.period == 6
    assert [m for m, _ in tcfg.layer_kinds] == ["attn_local"] * 5 + ["attn_global"]
    cache = make_cache(tcfg, B, 40, "cpu")
    assert [c["k"].shape[2] for c in cache] == [16] * 5 + [40]
    assert [c["k"].shape[2] for c in make_cache(tcfg, B, 12, "cpu")] == [12] * 6


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("S", [24, 64])
def test_forward_logits_match(weights, plan, S):
    jparams, tree_np = weights
    jcfg, tcfg = _configs(plan)
    toks = _tokens(S, (B, S))
    forward = jax.jit(JModel(jcfg).forward)
    want, _ = forward(jparams, {"tokens": jnp.asarray(toks)})
    nudged, _ = forward(_nudged(jparams), {"tokens": jnp.asarray(toks)})
    got = Model(tcfg, device="cpu").forward(params_from_numpy(tree_np, tcfg, "cpu"),
                                            torch.from_numpy(toks))
    _assert_close(got.numpy(), want, nudged, f"logits S={S}")


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("S, steps", [(10, 10), (20, 6)])
def test_prefill_then_decode_past_the_ring_wrap(weights, plan, S, steps):
    jparams, tree_np = weights
    jcfg, tcfg = _configs(plan)
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    tparams = params_from_numpy(tree_np, tcfg, "cpu")
    T = S + steps
    assert T > tcfg.sliding_window  # the local layers hold a ring
    toks = _tokens(S + 1, (B, S))
    nparams = _nudged(jparams)
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    jlog, jcache = prefill(jparams, jnp.asarray(toks), jmodel.make_cache(B, T))
    nlog, ncache = prefill(nparams, jnp.asarray(toks), jmodel.make_cache(B, T))
    tcache = tmodel.make_cache(B, T)
    tlog = tmodel.prefill(tparams, torch.from_numpy(toks), tcache)
    _assert_close(tlog.numpy(), jlog, nlog, f"prefill S={S}")
    for slot in range(tcfg.period):
        for name in ("k", "v"):
            _assert_close(tcache[slot][name].numpy(), jcache[slot][name],
                          ncache[slot][name], f"prefill S={S} cache slot {slot} {name}")
    cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = decode(jparams, jnp.asarray(cur), jcache, jnp.int32(S + i))
        nlog, ncache = decode(nparams, jnp.asarray(cur), ncache, jnp.int32(S + i))
        tlog = tmodel.decode_step(tparams, torch.from_numpy(cur), tcache, S + i)
        _assert_close(tlog.numpy(), jlog, nlog, f"decode step at position {S + i}")
        cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]


@pytest.mark.parametrize("S, H, Hkv, window, causal, q_chunk, pwl", [
    (24, 4, 1, 16, True, 256, False),     # one band over every key
    (64, 4, 1, 16, True, 256, True),      # one band, the window masking most keys
    (700, 4, 2, 128, True, 256, True),    # three bands, the last q chunk padded
    (40, 2, 2, 8, False, 16, False),      # non-causal window, bands clipped at both ends
    (100, 4, 1, 512, True, 256, False),   # a window wider than T: no band
])
def test_plain_flash_attention_with_a_window_matches_jax(S, H, Hkv, window, causal, q_chunk,
                                                         pwl):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, Hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, Hkv, 16)).astype(np.float32)
    jexp, texp = jnp.exp, torch.exp
    if pwl:
        kw = dict(act_impl="jnp", pwl_softmax=True)
        jexp = jlayers.resolve_exp(j_get_reduced_config("gemma3-1b", **kw))
        texp = layers.resolve_exp(get_reduced_config("gemma3-1b", **kw))
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, exp_fn=jexp, q_chunk=q_chunk)
    got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal, window=window, exp_fn=texp, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("plan", list(PLANS))
def test_loss_and_every_gradient_match_jax(weights, plan):
    jparams, tree_np = weights
    jcfg, tcfg = _configs(plan)
    toks = _tokens(3, (B, 65))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}  # S = 64: banded
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: JModel(jcfg).loss(p, b), has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = grad_fn(jparams, jb)
    (nloss, _), ngrads = grad_fn(_nudged(jparams), jb)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    nudged = [np.asarray(w) for w in jax.tree_util.tree_leaves(ngrads)]
    masters = params_from_numpy(tree_np, tcfg, "cpu", master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, _ = Model(tcfg, device="cpu").loss(
        masters, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    rel = max(1e-4, 4 * abs(float(nloss) - float(jloss)) / abs(float(jloss)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rel)
    assert len(grads) == len(want)
    for i, (g, w, n) in enumerate(zip(grads, want, nudged)):
        scale = max(float(np.abs(w).max()), 1e-12)
        _assert_close(g.numpy() / scale, w / scale, n / scale, f"gradient leaf {i} / its max")


def test_three_train_steps_match_jax(weights):
    jparams, _ = weights
    jcfg, tcfg = _configs("exact")
    S = 24
    data = SyntheticLMData(DataConfig(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=B))
    opt = dict(lr=LR, total_steps=N_STEPS, warmup_steps=1)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    fn, in_sh, out_sh, _, _ = j_build_train_step(
        jcfg, mesh, ShapeCell("host", S, B, "train"), opt_cfg=jadamw.AdamWConfig(**opt),
        microbatches=1)
    jstep = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    jstate = jadamw.init_state(jparams)
    tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    nstate = jadamw.init_state(_nudged(jparams))
    tstep = build_train_step(tcfg, "cpu", opt_cfg=adamw.AdamWConfig(**opt))
    for step in range(N_STEPS):
        batch = data.batch_at(step)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, jm = jstep(jstate, jb)
        nstate, nm = jstep(nstate, jb)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            want, nudged = float(jm[key]), float(nm[key])
            rel = max(1e-4, 4 * abs(nudged - want) / abs(want))
            print(f"step {step} {key}: port {float(tm[key]):.7g} jax {want:.7g} "
                  f"nudged jax {nudged:.7g}")
            np.testing.assert_allclose(float(tm[key]), want, rtol=rel, err_msg=key)
    for got, want, nudged in zip(tree.leaves(tstate["params"]),
                                 jax.tree_util.tree_leaves(jstate["params"]),
                                 jax.tree_util.tree_leaves(nstate["params"])):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= N_STEPS * 2 * LR
        own = float(np.median(np.abs(np.asarray(nudged) - np.asarray(want))))
        assert np.median(diff) <= max(1e-6, 4 * own)


def test_serve_falls_back_to_dense_and_matches_jax_generate(weights, monkeypatch, capsys):
    """The launcher in f32 on JAX's weights (its config getter and init
    patched to them), so that its greedy tokens can equal JAX's."""
    jparams, tree_np = weights
    jcfg, _ = _configs("exact")
    monkeypatch.setattr(serve, "get_reduced_config", lambda arch, **kw: dataclasses.replace(
        get_reduced_config(arch, **kw), dtype=torch.float32))
    monkeypatch.setattr(serve.Model, "init", lambda self, seed=0, master=False:
                        params_from_numpy(tree_np, self.cfg, self.device))
    args = serve.build_parser().parse_args(
        ["--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "20", "--max-new", "8"])
    assert args.mode == "paged"
    summary = serve.run(args)
    err = capsys.readouterr().err
    assert "[serve] paged cache unsupported (" in err and "running dense mode" in err
    assert summary["mode"] == "dense"
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 20)).astype(
        np.int32)
    want = np.asarray(j_generate(JModel(jcfg), jparams, jnp.asarray(prompts), max_new=8))
    assert summary["results"] == want.tolist()
