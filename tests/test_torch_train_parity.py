"""Port parity of training: reduced repro-100m in f32 under the plan with the
MLP and the softmax site fused (the GLU's and the row softmax's backward
kernels), on weights carried across from a JAX init, on the CPU.

* The loss and every gradient leaf of ``Model.loss`` against
  ``jax.value_and_grad`` of the JAX ``Model.loss``: loss at rel 1e-5, each
  leaf at 1e-4 of its max (sums taken in another order through two layers
  and the logsumexp over the vocab).
* Three steps of ``build_train_step`` against the JAX package's jitted train
  step on a one-device mesh: losses and gradient norms at rel 1e-4, the
  learning rate at 1e-6.  Parameters after three steps are held to
  ``3·2·lr`` elementwise: AdamW divides each moment by its root mean
  square, so an element whose gradient is rounding-sized moves by about
  ``±lr`` a step in either package, with the sign of that rounding (two
  correct updates differ by up to ``2·lr`` a step).  Every other element
  agrees far closer, which the median checks at 1e-6.
* Remat: the port's gradients with ``remat=True`` (each period recomputed in
  the backward by ``torch.utils.checkpoint``) bitwise equal to
  ``remat=False``, and at 1e-4 of each leaf's max against JAX with its own
  ``jax.checkpoint`` remat on.
* Full width (d_model 768, 12 heads, d_ff 3072, vocab 32000) at two layers,
  remat on in both packages: the init gradients and their global norm
  against JAX's.  At full width a rounding-sized change moves the
  gradients of a PWL model by percents (a score or pre-activation crosses a
  breakpoint, where the slope jumps, and the backward amplifies it), so the
  tolerance is measured, not assumed: JAX's own gradients with every
  weight scaled by ``1 + 1e-7·N(0, 1)`` (f32 rounding) give the worst
  leaf's change, and the port must agree with JAX within 4 times that.
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
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, params_from_numpy, train_state_from_numpy
from repro_torch.optim import adamw

B, S = 2, 24  # S > 16: the JAX embedding takes its gather, as the port does
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


def _jax_loss_and_grads(jcfg, jparams, batch):
    """JAX's loss and gradient leaves (numpy) on a numpy batch."""
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JModel(jcfg).loss(p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jloss), [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]


def _port_loss_and_grads(tcfg, jparams, batch):
    """The port's loss, metrics and gradient leaves on the f32 masters
    carried across from JAX's params."""
    masters = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu",
                                master=True)
    leaves = [p.requires_grad_(True) for p in tree.leaves(masters)]
    loss, metrics = Model(tcfg, device="cpu").loss(
        masters, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


def _assert_leaves_close(grads, want, rel):
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=rel * scale, rtol=rel,
                                   err_msg=f"gradient leaf {i}")


def _worst_leaf(got, want) -> float:
    """The largest elementwise difference of a leaf over that leaf's max."""
    return max(float(np.abs(np.asarray(g) - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want))


def _global_norm(leaves) -> float:
    return float(np.sqrt(sum(np.square(np.asarray(a, np.float64)).sum() for a in leaves)))


def test_loss_and_every_gradient_match_jax(setup):
    jcfg, tcfg, jparams, data = setup
    batch = data.batch_at(0)
    jloss, want = _jax_loss_and_grads(jcfg, jparams, batch)
    loss, metrics, grads = _port_loss_and_grads(tcfg, jparams, batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert metrics["nll"].item() == loss.item()
    _assert_leaves_close(grads, want, 1e-4)


def test_remat_gradients_bitwise_equal_no_remat(setup):
    _, tcfg, jparams, data = setup
    assert not tcfg.remat
    batch = data.batch_at(1)
    loss, _, grads = _port_loss_and_grads(tcfg, jparams, batch)
    rloss, _, rgrads = _port_loss_and_grads(dataclasses.replace(tcfg, remat=True), jparams,
                                            batch)
    assert rloss.item() == loss.item()
    assert all(torch.equal(a, b) for a, b in zip(rgrads, grads))


def test_remat_gradients_match_jax_remat(setup):
    jcfg, tcfg, jparams, data = setup
    batch = data.batch_at(1)
    jloss, want = _jax_loss_and_grads(dataclasses.replace(jcfg, remat=True), jparams, batch)
    loss, _, grads = _port_loss_and_grads(dataclasses.replace(tcfg, remat=True), jparams,
                                          batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    _assert_leaves_close(grads, want, 1e-4)


@pytest.mark.parametrize("plan", ["default", "fused_softmax"])
def test_full_width_init_gradients_match_jax_within_its_rounding_sensitivity(plan):
    kw = {} if plan == "default" else dict(act_impl="fused", pwl_softmax=True)
    jcfg = dataclasses.replace(j_get_config("repro-100m", **kw), n_layers=2,
                               dtype=jnp.float32, remat=True)
    tcfg = dataclasses.replace(get_config("repro-100m", **kw), n_layers=2,
                               dtype=torch.float32, remat=True)
    assert (tcfg.d_model, tcfg.n_heads, tcfg.d_ff, tcfg.vocab_size) == (768, 12, 3072, 32000)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    batch = SyntheticLMData(DataConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                                       global_batch=1)).batch_at(0)
    jloss, want = _jax_loss_and_grads(jcfg, jparams, batch)
    rng = np.random.default_rng(1)
    nudged = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-7 * rng.standard_normal(a.shape).astype(np.float32)), jparams)
    _, jax_nudged = _jax_loss_and_grads(jcfg, nudged, batch)
    loss, _, grads = _port_loss_and_grads(tcfg, jparams, batch)
    sensitivity = _worst_leaf(jax_nudged, want)
    port_gap = _worst_leaf(grads, want)
    norm, jnorm = _global_norm(grads), _global_norm(want)
    print(f"full width, 2 layers, {plan} plan: loss port {loss.item():.6f} jax {jloss:.6f}; "
          f"global grad norm port {norm:.6g} jax {jnorm:.6g}; worst leaf port vs jax "
          f"{port_gap:.3g}, jax vs jax with weights nudged by 1e-7 {sensitivity:.3g}")
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert port_gap <= 4 * sensitivity
    assert abs(norm - jnorm) <= 4 * sensitivity * jnorm


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
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == N_STEPS
    for got, want in zip(tree.leaves(tstate["params"]),
                         jax.tree_util.tree_leaves(jstate["params"])):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= N_STEPS * 2 * LR
        assert np.median(diff) <= 1e-6
