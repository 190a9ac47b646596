"""Port parity: the reduced whisper-small encoder-decoder (2 + 2 layers,
d_model 64, 4 heads, ``encoder_seq`` 24; LayerNorm, biased GELU MLPs,
sinusoidal positions) of ``repro_torch`` against the JAX ``Model`` on
converted parameters, in float32, on the CPU, with stub frames made with
numpy.

Two plans: exact activations, and every site fused (the MLP through the
fused linear layer's plain version and its backward, the softmax of every
attention, encoder and cross included, through the fused PWL-exp softmax).
Under the fused plan one more case sets both packages' dense fused-softmax
cap to 0, so the encoder's and the cross-attention's non-causal softmax
takes the flash attention.

* Logits of ``forward`` and the loss at 1e-4, and every gradient leaf of
  ``Model.loss`` against the jitted ``jax.value_and_grad`` at 1e-4 of the
  leaf's max, or within 4x JAX's own gap between its jitted and its eager
  gradient where that is larger (at init this model's gradients move by
  1e-4 to 1.5e-3 of their max in JAX itself under f32 roundings in another
  order).
* ``prefill(frames=)`` and 4 greedy ``decode_step`` logits at 1e-4.
* Three steps of ``build_train_step`` against the JAX package's jitted
  train step on a one-device mesh, fed a batch that carries ``frames``
  (the JAX launcher cannot), each from JAX's state before the step: losses
  and gradient norms at rel 1e-4, the parameters after the step within
  ``2·lr`` elementwise (a rounding-noise gradient element may step the
  other way) and at 1e-6 in the median.
* The port's launchers refuse the encoder-decoder with a plain error.
"""
import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro  # noqa: F401
import repro.models.layers as jlayers
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import Model as JModel
from repro.models import ShapeCell
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, params_from_numpy, train_state_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.optim import adamw
from repro_torch.serving.resilience import UnsupportedCacheError

B, S = 2, 12
LR = 1e-3
N_STEPS = 3
TOL = dict(atol=1e-4, rtol=1e-4)
PLANS = {"exact": {}, "fused": dict(act_impl="fused", pwl_softmax=True)}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
        "frames": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def _configs(plan: str):
    kw = PLANS[plan]
    jcfg = j_get_reduced_config("whisper-small", dtype=jnp.float32, **kw)
    tcfg = get_reduced_config("whisper-small", dtype=torch.float32, **kw)
    return jcfg, tcfg, JModel(jcfg).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=sorted(PLANS))
def setup(request):
    return _configs(request.param)


def _params(tcfg, jparams, master=False):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu",
                             master=master)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_is_the_jax_config():
    from repro.configs import get_config as j_get_config

    t, j = get_config("whisper-small"), j_get_config("whisper-small")
    for f in ("n_layers", "n_encoder_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "activation", "mlp_type", "norm_type", "is_encoder_decoder",
              "encoder_seq"):
        assert getattr(t, f) == getattr(j, f), f


def test_forward_logits_match(setup):
    jcfg, tcfg, jparams = setup
    batch = _batch(tcfg, 0)
    want, _ = JModel(jcfg).forward(jparams, _j(batch))
    got = Model(tcfg, device="cpu").forward(_params(tcfg, jparams),
                                            torch.from_numpy(batch["tokens"]),
                                            torch.from_numpy(batch["frames"]))
    assert got.shape == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_through_the_flash_attention(monkeypatch):
    jcfg, tcfg, jparams = _configs("fused")
    monkeypatch.setattr(jlayers, "DENSE_FUSED_SOFTMAX_MAX_SCORES", 0)
    monkeypatch.setattr(tlayers, "DENSE_FUSED_SOFTMAX_MAX_SCORES", 0)
    batch = _batch(tcfg, 1)
    want, _ = JModel(jcfg).forward(jparams, _j(batch))
    got = Model(tcfg, device="cpu").forward(_params(tcfg, jparams),
                                            torch.from_numpy(batch["tokens"]),
                                            torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_loss_and_grads(jcfg, jparams, batch, jit: bool):
    f = jax.value_and_grad(lambda p, b: JModel(jcfg).loss(p, b), has_aux=True)
    if jit:
        return jax.jit(f)(jparams, _j(batch))
    with jax.disable_jit():
        return f(jparams, _j(batch))


def test_loss_and_every_gradient_match_jax(setup):
    jcfg, tcfg, jparams = setup
    batch = _batch(tcfg, 2)
    (jloss, jmetrics), jgrads = _jax_loss_and_grads(jcfg, jparams, batch, jit=True)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    _, eager = _jax_loss_and_grads(jcfg, jparams, batch, jit=False)
    eager = [np.asarray(w) for w in jax.tree_util.tree_leaves(eager)]
    masters = _params(tcfg, jparams, master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, metrics = Model(tcfg, device="cpu").loss(masters, _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(metrics["nll"].item(), float(jmetrics["nll"]), rtol=1e-4)
    assert metrics["aux"].item() == 0.0
    assert len(grads) == len(want) == len(eager)
    for i, (g, w, e) in enumerate(zip(grads, want, eager)):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        # 1e-4 of the leaf's max, or 4x JAX's own gap between its jitted and
        # its eager gradient where that is larger: at init the decoder's
        # hidden states are mostly the sinusoidal positions (the token
        # embeddings are 0.02-scale), so the gradient contributions of
        # different targets nearly cancel, and f32 roundings in another order
        # move the gradients by 1e-4 to 1.5e-3 of their max in JAX itself
        tol = max(1e-4, 4 * float(np.abs(e - w).max()) / scale)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= tol, f"gradient leaf {i}: {err:.3g} of its max > {tol:.3g}"


def test_prefill_and_decode_logits_match(setup):
    jcfg, tcfg, jparams = setup
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    tparams = _params(tcfg, jparams)
    batch = _batch(tcfg, 3)
    n_new = 4
    jcache = jmodel.make_cache(B, S + n_new)
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(batch["tokens"]), jcache,
                                  frames=jnp.asarray(batch["frames"]))
    tcache = tmodel.make_cache(B, S + n_new)
    tlog = tmodel.prefill(tparams, torch.from_numpy(batch["tokens"]), tcache,
                          frames=torch.from_numpy(batch["frames"]))
    assert tlog.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    for i in range(n_new):
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(cur[:, None]), jcache, S + i)
        tlog = tmodel.decode_step(tparams, torch.from_numpy(cur[:, None]), tcache, S + i)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        cur = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    for name in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL)


def test_three_train_steps_match_jax(setup):
    jcfg, tcfg, jparams = setup
    opt = dict(lr=LR, total_steps=N_STEPS, warmup_steps=1)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    fn, in_sh, out_sh, _, _ = j_build_train_step(
        jcfg, mesh, ShapeCell("host", S, B, "train"), opt_cfg=jadamw.AdamWConfig(**opt),
        microbatches=1)
    jstep = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    tstep = build_train_step(tcfg, "cpu", opt_cfg=adamw.AdamWConfig(**opt))
    jstate = jadamw.init_state(jparams)
    for step in range(N_STEPS):
        # each step from JAX's state: AdamW moves every weight by about lr
        # whatever its gradient's size, so where a gradient element is
        # rounding noise (see the gradient test) the two packages would step
        # it in opposite directions, and a chained run's next gradient norm
        # would differ by ~1% under the fused plan
        tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg,
                                        "cpu")
        batch = _batch(tcfg, 10 + step)
        jstate, jm = jstep(jstate, _j(batch))
        tstate, tm = tstep(tstate, _t(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for got, want in zip(tree.leaves(tstate["params"]),
                             jax.tree_util.tree_leaves(jstate["params"])):
            diff = np.abs(got.numpy() - np.asarray(want))
            assert diff.max() <= 2 * LR
            assert np.median(diff) <= 1e-6


def test_no_paged_cache_for_the_encoder_decoder():
    with pytest.raises(UnsupportedCacheError, match="decoder-only"):
        Model(get_reduced_config("whisper-small"), device="cpu").make_paged_cache(4, 16)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_refuse_the_encoder_decoder(launcher):
    from repro_torch.launch import serve, train

    mod = serve if launcher == "serve" else train
    args = mod.build_parser().parse_args(["--arch", "whisper-small", "--reduced",
                                          "--device", "cpu"])
    assert isinstance(args, argparse.Namespace)
    with pytest.raises(ValueError, match=r"encoder-decoder.*Model\.prefill"):
        mod.run(args)
