"""Port parity: the reduced dense architectures olmo-1b (non-parametric
LayerNorm, tied embeddings), stablelm-1.6b (LayerNorm, SwiGLU), qwen2.5-32b
(QKV biases, GQA 4:2, head dim 32) and internvl2-1b (GQA 4:2, an 8-token
vision prefix) of ``repro_torch`` against the JAX ``Model`` on converted
parameters, in float32, on the CPU, under the fused plan (the ``mlp`` site
on the GLU's plain version and its backward).

* Each config's fields are the JAX config's; the two architectures whose
  full width is still refused say what they wait on.
* Logits through ``forward``, the loss and every gradient leaf of
  ``Model.loss``, the dense ``prefill`` then ``decode_step``, and the paged
  ``prefill_paged`` / ``decode_step_paged`` at 1e-4 (sums in another
  order); internvl's forward, loss and dense prefill run with its vision
  prefix, its paged calls with tokens only, as in JAX.
* qwen's biases are drawn from a seeded numpy generator into the JAX tree
  before the conversion: JAX makes them zeros, which would test nothing.
* olmo's empty norm subtrees pass ``params_from_numpy``, AdamW, the train
  step and a checkpoint; three train steps match the JAX train step, and a
  resumed run the uninterrupted one bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import Model as JModel
from repro.models import ShapeCell
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, params_from_numpy, train_state_from_numpy
from repro_torch.optim import adamw

ARCHS = ["olmo-1b", "stablelm-1.6b", "qwen2.5-32b", "internvl2-1b"]
B, S = 2, 24
LR = 1e-3
N_STEPS = 3
TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_params(arch, jcfg):
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tree_np = jax.tree_util.tree_map(np.asarray, jparams)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        for slot in tree_np["layers"]:
            for name in ("bq", "bk", "bv"):
                shape = slot["mixer"][name].shape
                slot["mixer"][name] = rng.normal(0.0, 0.5, size=shape).astype(np.float32)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree_np)
    return jparams, tree_np


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = j_get_reduced_config(arch, act_impl="fused", dtype=jnp.float32)
    tcfg = get_reduced_config(arch, act_impl="fused", dtype=torch.float32)
    jparams, tree_np = _jax_params(arch, jcfg)
    return arch, jcfg, tcfg, jparams, params_from_numpy(tree_np, tcfg, "cpu"), tree_np


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _vision(tcfg, seed, batch=B):
    if not tcfg.n_vision_tokens:
        return None
    return np.random.default_rng(seed).normal(
        size=(batch, tcfg.n_vision_tokens, tcfg.d_model)).astype(np.float32)


def _batch(tcfg, seed):
    toks = _tokens(seed, (B, S + 1), tcfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    vision = _vision(tcfg, seed + 100)
    if vision is not None:
        batch["vision_embeds"] = vision
    return batch


def _field(cfg, name):
    """A config field, its site pins as JSON (each package has its own
    ``ApproxSpec`` class)."""
    value = getattr(cfg, name)
    if name == "act_site_specs":
        return [(k, s.to_json()) for k, s in value]
    return value


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_is_the_jax_config(arch):
    t, j = get_config(arch), j_get_config(arch)
    names = [f.name for f in dataclasses.fields(t) if f.name not in ("dtype", "act_plan")]
    for name in names:
        assert _field(t, name) == _field(j, name), name
    assert t.layer_kinds == j.layer_kinds and t.period == j.period
    tr, jr = get_reduced_config(arch), j_get_reduced_config(arch)
    for name in names:
        assert _field(tr, name) == _field(jr, name), name


@pytest.mark.parametrize("arch, waits_on", [("jamba-v0.1-52b", "distribution"),
                                            ("phi3.5-moe-42b-a6.6b", "distribution")])
def test_unported_archs_say_what_they_wait_on(arch, waits_on):
    with pytest.raises(ValueError, match=waits_on):
        get_config(arch)


def test_forward_logits_match(setup):
    _, jcfg, tcfg, jparams, tparams, _ = setup
    batch = _batch(tcfg, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "targets"}
    want, _ = JModel(jcfg).forward(jparams, jb)
    vision = batch.get("vision_embeds")
    got = Model(tcfg, device="cpu").forward(
        tparams, torch.from_numpy(batch["tokens"]),
        vision_embeds=None if vision is None else torch.from_numpy(vision))
    assert got.shape == (B, S + tcfg.n_vision_tokens, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_and_every_gradient_match_jax(setup):
    _, jcfg, tcfg, jparams, _, tree_np = setup
    batch = _batch(tcfg, 1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JModel(jcfg).loss(p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    masters = params_from_numpy(tree_np, tcfg, "cpu", master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, metrics = Model(tcfg, device="cpu").loss(
        masters, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert metrics["aux"].item() == 0.0
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=f"gradient leaf {i}")


def test_dense_prefill_and_decode_logits_match(setup):
    _, jcfg, tcfg, jparams, tparams, _ = setup
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    n, steps = 12, 4
    toks = _tokens(2, (B, n), tcfg.vocab_size)
    vision = _vision(tcfg, 3)
    nv = tcfg.n_vision_tokens
    T = nv + n + steps
    jextra = {} if vision is None else {"vision_embeds": jnp.asarray(vision)}
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.make_cache(B, T), **jextra)
    tcache = tmodel.make_cache(B, T)
    tlog = tmodel.prefill(tparams, torch.from_numpy(toks), tcache,
                          vision_embeds=None if vision is None else torch.from_numpy(vision))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(steps):
        pos = nv + n + i
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(cur), jcache, jnp.int32(pos))
        tlog = tmodel.decode_step(tparams, torch.from_numpy(cur), tcache, pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]


def test_paged_prefill_and_decode_logits_match(setup):
    _, jcfg, tcfg, jparams, tparams, _ = setup
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    ps, P, n = 16, 9, 20  # a 20-token prompt in a 32-token bucket
    table = np.asarray([[3, 5, 0], [7, 2, 0]], np.int32)
    toks = np.zeros((2, 32), np.int32)
    toks[:, :n] = _tokens(4, (2, n), tcfg.vocab_size)
    lens = np.asarray([n, n - 7], np.int32)
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


def test_qkv_biases_are_held_in_the_model_dtype():
    cfg = get_reduced_config("qwen2.5-32b", act_impl="fused")
    params = Model(cfg, device="cpu").init(seed=0)
    mixer = params["layers"][0]["mixer"]
    for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
        assert mixer[name].dtype == torch.bfloat16
        assert mixer[name].shape == (cfg.n_layers, heads, cfg.resolved_head_dim)
        assert not mixer[name].any()


# ---------------------------------------------------------------------------
# olmo-1b: empty norm subtrees through the training state


def _olmo():
    jcfg = j_get_reduced_config("olmo-1b", act_impl="fused", dtype=jnp.float32)
    tcfg = get_reduced_config("olmo-1b", act_impl="fused", dtype=torch.float32)
    return jcfg, tcfg, JModel(jcfg).init(jax.random.PRNGKey(0))


def test_empty_norm_subtrees_survive_the_training_state(tmp_path):
    _, tcfg, jparams = _olmo()
    masters = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu",
                                master=True)
    assert masters["final_norm"] == {} and masters["layers"][0]["ln1"] == {}
    state = adamw.init_state(masters)
    assert state["mu"]["final_norm"] == {} and state["nu"]["layers"][0]["ln2"] == {}
    step = build_train_step(tcfg, "cpu", opt_cfg=adamw.AdamWConfig(lr=LR, total_steps=2,
                                                                   warmup_steps=1))
    data = SyntheticLMData(DataConfig(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=B))
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()})
    for part in ("params", "mu", "nu"):
        assert state[part]["final_norm"] == {} and state[part]["layers"][0]["ln1"] == {}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    for like in (None, state):
        back, _ = mgr.restore(like=like)
        assert back["params"]["final_norm"] == {} and back["mu"]["layers"][0]["ln2"] == {}
        for x, y in zip(tree.leaves(back), tree.leaves(state)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    state, _ = step(back, {k: torch.from_numpy(v) for k, v in data.batch_at(1).items()})
    assert torch.isfinite(state["params"]["embed"]).all()


def test_olmo_three_train_steps_match_jax():
    jcfg, tcfg, jparams = _olmo()
    data = SyntheticLMData(DataConfig(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=B))
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
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == N_STEPS
    got_leaves = tree.leaves(tstate["params"])
    want_leaves = jax.tree_util.tree_leaves(jstate["params"])
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= N_STEPS * 2 * LR
        assert np.median(diff) <= 1e-6


def _train_args(tmp_path, steps):
    return train.build_parser().parse_args(
        ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--batch", "2", "--seq", "24",
         "--steps", str(steps), "--ckpt-dir", str(tmp_path), "--ckpt-every", "100"])


def test_olmo_resume_continues_exactly(tmp_path):
    """4 steps straight give the losses of 2 steps, a save, a restore and 2
    more, through the train launcher."""
    straight = train.run(_train_args(tmp_path / "a", 4))
    first = train.run(_train_args(tmp_path / "b", 2))
    second = train.run(_train_args(tmp_path / "b", 4))
    assert len(second["losses"]) == 2
    np.testing.assert_array_equal(first["losses"] + second["losses"], straight["losses"])
    a, _ = CheckpointManager(str(tmp_path / "a")).restore()
    b, _ = CheckpointManager(str(tmp_path / "b")).restore()
    assert a["params"]["final_norm"] == {} == b["params"]["final_norm"]
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
