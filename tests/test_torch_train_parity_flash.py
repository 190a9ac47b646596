"""Port parity of training through the flash attention: reduced repro-100m
in f32 under the plan with the MLP and the softmax site fused, with the
dense fused-softmax cap of both packages set to 0 inside each test, so that
every attention of both models takes the fused flash attention (forward,
and its blocked backward: the plain version of the port's CUDA backward
kernels, JAX's Pallas passes in interpret mode), on the CPU.

* The loss and every gradient leaf of ``Model.loss`` against
  ``jax.value_and_grad`` of the JAX ``Model.loss``: loss at rel 1e-5, each
  leaf at 1e-4 of its max, as ``tests/test_torch_train_parity.py`` holds the
  dense path.
* The port's gradients with ``remat=True`` bitwise equal to ``remat=False``.
* Three steps of ``build_train_step`` against the JAX package's jitted train
  step on a one-device mesh, with the bounds of
  ``tests/test_torch_train_parity.py``, except that a step's gradient norm
  is held at rel 1e-4 or, where JAX's own norm moves more than that when
  the weights before the step are scaled by ``1 + 1e-7·N(0, 1)`` (f32
  rounding), within 4 times that move.  At the weights of step 2 it does:
  a score or pre-activation then sits within rounding of a PWL breakpoint,
  where the slope jumps (JAX's norm moves by ~1e-4 of itself, and the
  port's, 2e-4 from JAX's, agrees with its own dense oracle at 4e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro  # noqa: F401
import repro.models.layers as jlayers
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.kernels import fused as jfused
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import Model as JModel
from repro.models import ShapeCell
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.kernels.fused import attention as tattn
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, params_from_numpy, train_state_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.optim import adamw

B, S = 2, 24
LR = 1e-3
N_STEPS = 3


@pytest.fixture(scope="module")
def setup():
    kw = dict(act_impl="fused", pwl_softmax=True)
    jcfg = j_get_reduced_config("repro-100m", dtype=jnp.float32, **kw)
    tcfg = get_reduced_config("repro-100m", dtype=torch.float32, **kw)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    data = SyntheticLMData(DataConfig(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=B))
    return jcfg, tcfg, jparams, data


@pytest.fixture
def flash_calls(monkeypatch):
    """Both packages' dense cap at 0, and counts of what took the flash
    path: JAX's ``fused_flash_attention`` (once per trace of a layer body,
    which JAX's layer scan traces once for all layers), the port's flash
    forward and its backward kernels' wrapper."""
    monkeypatch.setattr(jlayers, "DENSE_FUSED_SOFTMAX_MAX_SCORES", 0)
    monkeypatch.setattr(tlayers, "DENSE_FUSED_SOFTMAX_MAX_SCORES", 0)
    calls = {"jax": 0, "forward": 0, "backward": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(jfused, "fused_flash_attention",
                        counted("jax", jfused.fused_flash_attention))
    monkeypatch.setattr(tattn, "fused_flash_attention_plain",
                        counted("forward", tattn.fused_flash_attention_plain))
    monkeypatch.setattr(tattn, "fused_flash_attention_bwd",
                        counted("backward", tattn.fused_flash_attention_bwd))
    return calls


def _jax_loss_and_grads(jcfg, jparams, batch):
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JModel(jcfg).loss(p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jloss), [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]


def _global_norm(leaves) -> float:
    return float(np.sqrt(sum(np.square(np.asarray(a, np.float64)).sum() for a in leaves)))


def _port_loss_and_grads(tcfg, jparams, batch):
    masters = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu",
                                master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, _ = Model(tcfg, device="cpu").loss(
        masters, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, leaves)


def test_loss_and_every_gradient_match_jax_through_the_flash_path(setup, flash_calls):
    jcfg, tcfg, jparams, data = setup
    batch = data.batch_at(0)
    jloss, want = _jax_loss_and_grads(jcfg, jparams, batch)
    loss, grads = _port_loss_and_grads(tcfg, jparams, batch)
    n = tcfg.n_layers
    assert flash_calls["jax"] >= 1 and flash_calls["forward"] == flash_calls["backward"] == n
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=f"gradient leaf {i}")


def test_flash_remat_gradients_bitwise_equal_no_remat(setup, flash_calls):
    _, tcfg, jparams, data = setup
    batch = data.batch_at(1)
    loss, grads = _port_loss_and_grads(tcfg, jparams, batch)
    rloss, rgrads = _port_loss_and_grads(dataclasses.replace(tcfg, remat=True), jparams, batch)
    n = tcfg.n_layers
    # remat runs each layer's forward twice, its backward once
    assert flash_calls["forward"] == 3 * n and flash_calls["backward"] == 2 * n
    assert rloss.item() == loss.item()
    assert all(torch.equal(a, b) for a, b in zip(rgrads, grads))


def test_three_train_steps_match_jax_through_the_flash_path(setup, flash_calls):
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
    rng = np.random.default_rng(1)
    for step in range(N_STEPS):
        batch = data.batch_at(step)
        before = jstate["params"]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        jnorm = float(jm["grad_norm"])
        nudged = jax.tree_util.tree_map(
            lambda a: a * (1 + 1e-7 * rng.standard_normal(a.shape).astype(np.float32)), before)
        sensitivity = abs(_global_norm(_jax_loss_and_grads(jcfg, nudged, batch)[1]) - jnorm)
        assert abs(float(tm["grad_norm"]) - jnorm) <= max(1e-4 * jnorm, 4 * sensitivity)
    n = tcfg.n_layers
    assert flash_calls["jax"] >= 1
    assert flash_calls["forward"] == N_STEPS * n and flash_calls["backward"] == N_STEPS * n
    assert int(tstate["step"]) == int(jstate["step"]) == N_STEPS
    for got, want in zip(tree.leaves(tstate["params"]),
                         jax.tree_util.tree_leaves(jstate["params"])):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= N_STEPS * 2 * LR
        assert np.median(diff) <= 1e-6
