"""Port parity: reduced mamba2-2.7b (2 SSM layers, d_model 64, 8 heads of
16, state 16, the empty FFN of d_ff 0, tied embeddings) of ``repro_torch``
against the JAX ``Model`` on converted parameters, in float32, on the CPU.
The JAX tree's ``A_log``, ``dt_bias``, ``D``, ``conv_b`` and ``norm_scale``
are redrawn from a seeded numpy generator first (JAX makes them zeros and
ones).

* Logits, the loss and every gradient leaf (the FFN's empty ones included)
  at S = 64, 1e-4, under the config's own plan (exact activations).
* A dense prefill of 20 tokens, then decode steps past position 32, with
  ``ssm_chunk=16`` on both sides (the prefill crosses a chunk boundary and
  pads its last chunk).
* ``serve --arch mamba2-2.7b --reduced --device cpu`` asks for the paged
  cache, says on stderr that it runs dense mode, and generates JAX's dense
  ``generate`` tokens from the same weights.
* Three train steps against the JAX train step; a launcher run resumed
  from a checkpoint equals the straight run bitwise.
* The fused plan (the serve launcher's default) against JAX under
  ``act_impl="jnp"``: JAX cannot run its fused plan here (its fused GLU
  divides by the empty FFN's width), and the fused plan runs ``ssm:softplus``
  as the jnp PWL evaluation and an FFN that adds exactly 0.
* A plan with ``ssm:softplus`` at ``impl="kernel"`` (the standalone PWL
  kernel's plain version on the CPU) equals the jnp plan's logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_ssm import redraw_ssm_vectors

import repro  # noqa: F401
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.launch.serve import generate as j_generate
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import Model as JModel
from repro.models import ShapeCell
from repro.optim import adamw as jadamw
from repro_torch import sfu, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch import serve, train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, params_from_numpy, train_state_from_numpy
from repro_torch.optim import adamw

ARCH = "mamba2-2.7b"
B = 2
LR = 1e-3
N_STEPS = 3
TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(**kw):
    return (j_get_reduced_config(ARCH, dtype=jnp.float32, **kw),
            get_reduced_config(ARCH, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    tree_np = redraw_ssm_vectors(jax.tree_util.tree_map(
        np.asarray, jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))))
    return jax.tree_util.tree_map(jnp.asarray, tree_np), tree_np


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _logits_both(jcfg, tcfg, weights, toks):
    jparams, tree_np = weights
    want, _ = jax.jit(JModel(jcfg).forward)(jparams, {"tokens": jnp.asarray(toks)})
    got = Model(tcfg, device="cpu").forward(params_from_numpy(tree_np, tcfg, "cpu"),
                                            torch.from_numpy(toks))
    return got, np.asarray(want)


def test_reduced_config_and_its_layers():
    _, tcfg = _configs()
    assert tcfg.layer_kinds == [("ssm", "dense")] * 2 and tcfg.d_ff == 0
    assert dict(sfu.plan_for(tcfg).items())["ssm:silu"].impl == "exact"


def test_forward_logits_match(weights):
    got, want = _logits_both(*_configs(), weights, _tokens(0, (B, 64)))
    assert got.shape == (B, 64, 512)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_loss_and_every_gradient_match_jax(weights):
    jparams, tree_np = weights
    jcfg, tcfg = _configs()
    toks = _tokens(1, (B, 65))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JModel(jcfg).loss(p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    masters = params_from_numpy(tree_np, tcfg, "cpu", master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, _ = Model(tcfg, device="cpu").loss(
        masters, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert len(grads) == len(want)
    n_empty = 0
    for i, (g, w) in enumerate(zip(grads, want)):
        if w.size == 0:  # the (D, 0) / (0, D) FFN leaves
            n_empty += 1
            assert g.shape == w.shape
            continue
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=f"gradient leaf {i}")
    assert n_empty == 3


def test_dense_prefill_then_decode_across_a_chunk_boundary(weights):
    jparams, tree_np = weights
    jcfg, tcfg = _configs(ssm_chunk=16)
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    tparams = params_from_numpy(tree_np, tcfg, "cpu")
    n, steps = 20, 16  # decode positions 20..35 cross the chunk boundary at 32
    toks = _tokens(2, (B, n))
    T = n + steps
    jlog, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks), jmodel.make_cache(B, T))
    tcache = tmodel.make_cache(B, T)
    assert [sorted(c) for c in tcache] == [["conv", "ssm"]]
    tlog = tmodel.prefill(tparams, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[0][name].numpy(), np.asarray(jcache[0][name]), **TOL)
    decode = jax.jit(jmodel.decode_step)
    cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(steps):
        jlog, jcache = decode(jparams, jnp.asarray(cur), jcache, jnp.int32(n + i))
        tlog = tmodel.decode_step(tparams, torch.from_numpy(cur), tcache, n + i)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]


def test_serve_falls_back_to_dense_and_matches_jax_generate(weights, monkeypatch, capsys):
    """The launcher (its fused default plan) in f32 on JAX's weights, its
    config getter and init patched to them, against JAX's ``generate`` under
    ``act_impl="jnp"``."""
    jparams, tree_np = weights
    jcfg, _ = _configs(act_impl="jnp")
    monkeypatch.setattr(serve, "get_reduced_config", lambda arch, **kw: dataclasses.replace(
        get_reduced_config(arch, **kw), dtype=torch.float32))
    monkeypatch.setattr(serve.Model, "init", lambda self, seed=0, master=False:
                        params_from_numpy(tree_np, self.cfg, self.device))
    args = serve.build_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--max-new", "8"])
    assert args.mode == "paged"
    summary = serve.run(args)
    captured = capsys.readouterr()
    assert "[serve] paged cache unsupported (" in captured.err
    assert "'ssm' in layer_kinds" in captured.err and "running dense mode" in captured.err
    assert "'ssm:softplus': 'jnp'" in captured.out and "'mlp:silu': 'fused'" in captured.out
    assert summary["mode"] == "dense"
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 20)).astype(
        np.int32)
    want = np.asarray(j_generate(JModel(jcfg), jparams, jnp.asarray(prompts), max_new=8))
    assert summary["results"] == want.tolist()


def test_three_train_steps_match_jax(weights):
    jparams, _ = weights
    jcfg, tcfg = _configs()
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
        assert got.shape == want.shape
        if got.numel() == 0:
            continue
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= N_STEPS * 2 * LR
        assert np.median(diff) <= 1e-6


def _train_args(tmp_path, steps):
    return train.build_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "24",
         "--steps", str(steps), "--ckpt-dir", str(tmp_path), "--ckpt-every", "100"])


def test_resume_continues_exactly(tmp_path):
    """4 steps straight give the losses of 2 steps, a save, a restore and 2
    more, through the train launcher (the empty FFN leaves in every tree)."""
    straight = train.run(_train_args(tmp_path / "a", 4))
    first = train.run(_train_args(tmp_path / "b", 2))
    second = train.run(_train_args(tmp_path / "b", 4))
    assert len(second["losses"]) == 2
    np.testing.assert_array_equal(first["losses"] + second["losses"], straight["losses"])
    a, _ = CheckpointManager(str(tmp_path / "a")).restore()
    b, _ = CheckpointManager(str(tmp_path / "b")).restore()
    assert a["params"]["layers"][0]["ffn"]["w_down"].shape == (2, 0, 64)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_fused_plan_matches_jax_under_jnp(weights):
    jcfg, _ = _configs(act_impl="jnp")
    _, tcfg = _configs(act_impl="fused")
    plan = dict(sfu.plan_for(tcfg).items())
    assert plan["mlp:silu"].impl == "fused" and plan["ssm:softplus"].impl == "jnp"
    got, want = _logits_both(jcfg, tcfg, weights, _tokens(3, (B, 40)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_softplus_kernel_plan_equals_the_jnp_plan(weights):
    _, tree_np = weights
    _, tcfg = _configs(act_impl="jnp")
    jnp_plan = sfu.compile_plan(tcfg)
    kernel_plan = sfu.ActivationPlan(sites=tuple(
        (k, dataclasses.replace(s, impl="kernel") if k == "ssm:softplus" else s)
        for k, s in jnp_plan.items()))
    toks = torch.from_numpy(_tokens(4, (B, 40)))
    out = {}
    for name, plan in (("jnp", jnp_plan), ("kernel", kernel_plan)):
        cfg = dataclasses.replace(tcfg, act_plan=plan)
        with torch.no_grad():
            out[name] = Model(cfg, device="cpu").forward(params_from_numpy(tree_np, cfg, "cpu"),
                                                         toks)
    np.testing.assert_allclose(out["kernel"].numpy(), out["jnp"].numpy(), atol=1e-6, rtol=1e-6)


def test_in_place_update_is_the_pure_update(weights):
    """The train launcher's in-place AdamW step (one copy of the state, as
    full-width mamba2 needs on one card) writes bitwise the pure step's
    values into the state's own tensors."""
    _, tree_np = weights
    _, tcfg = _configs()
    data = SyntheticLMData(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=B))
    opt = adamw.AdamWConfig(lr=LR, total_steps=4, warmup_steps=1)
    pure = build_train_step(tcfg, "cpu", opt_cfg=opt)
    inplace = build_train_step(tcfg, "cpu", opt_cfg=opt, in_place=True)
    a = adamw.init_state(params_from_numpy(tree_np, tcfg, "cpu", master=True))
    b = adamw.init_state(params_from_numpy(tree_np, tcfg, "cpu", master=True))
    for step in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
        held = tree.leaves(b)
        a, _ = pure(a, batch)
        b, _ = inplace(b, batch)
        assert all(x is y for x, y in zip(tree.leaves(b)[:-1], held[:-1]))
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_sigterm_waits_for_the_step_to_end():
    import os
    import signal

    got = []
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: got.append("handler"))
    try:
        with train._sigterm_deferred():
            os.kill(os.getpid(), signal.SIGTERM)
            got.append("step done")
        assert got == ["step done", "handler"]
    finally:
        signal.signal(signal.SIGTERM, prev)
