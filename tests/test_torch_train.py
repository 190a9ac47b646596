"""The training host modules of the torch port against the JAX package, and
the train launcher's behaviour, on the CPU.

* AdamW (``repro_torch.optim.adamw``): the schedules and one
  ``apply_updates`` on the same state and gradients as the JAX package's, at
  1e-6 (f32 arithmetic in another order).
* ``SyntheticLMData``: batches bitwise the JAX package's.
* ``CheckpointManager``: round trip, ``latest_step``, retention, and a save
  cut short (a ``.tmp`` directory) never taken for a checkpoint.
* ``train_state_from_numpy``: a JAX AdamW state carried across.
* The launcher: defaults to ``cuda`` and raises without a GPU; refuses the
  flash path under a fused-softmax plan and ``--model-parallel``; trains the
  reduced model on the CPU when asked; resumes exactly (4 steps straight
  give the losses of 2 + save + restore + 2); saves on SIGTERM.
"""
import dataclasses
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as j_get_reduced_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager, install_sigterm_save
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticLMData
from repro_torch.launch import train
from repro_torch.models import train_state_from_numpy
from repro_torch.optim import adamw

TOL = dict(atol=1e-6, rtol=1e-6)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tree(seed, scale=1.0):
    """A parameter-shaped tree: a matrix, a stacked (2-D) norm scale, a
    vector and a list of layers."""
    return {"w": _rand(seed, (6, 5), scale), "norm": {"scale": _rand(seed + 1, (2, 7), scale)},
            "bias": _rand(seed + 2, (9,), scale),
            "layers": [{"a": _rand(seed + 3, (3, 4, 2), scale)}, {"a": _rand(seed + 4, (4,), scale)}]}


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return [_to_torch(v) for v in tree]


def _assert_trees_close(got, want, **tol):
    gl = [t.numpy() for t in tree.leaves(got)]
    wl = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
    js = jadamw.make_schedule(jadamw.AdamWConfig(**cfg))
    ts = adamw.make_schedule(adamw.AdamWConfig(**cfg))
    for step in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        want = float(js(jnp.int32(step)))
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_apply_updates_matches_jax(clip):
    """Identical gradients fed to both updates: params, moments and metrics
    at 1e-6.  ``clip`` 1.0 scales the gradients (their norm is ~8), 1e3
    leaves them."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    params, grads = _tree(0), _tree(10, 0.5)
    mu, nu = _tree(20, 0.1), jax.tree_util.tree_map(np.abs, _tree(30, 0.01))
    jstate = {"params": params, "mu": mu, "nu": nu, "step": jnp.int32(3)}
    want, wm = jadamw.apply_updates(
        jax.tree_util.tree_map(jnp.asarray, jstate), jax.tree_util.tree_map(jnp.asarray, grads),
        jadamw.AdamWConfig(**cfg))
    tstate = {"params": _to_torch(params), "mu": _to_torch(mu), "nu": _to_torch(nu),
              "step": torch.tensor(3, dtype=torch.int32)}
    got, gm = adamw.apply_updates(tstate, _to_torch(grads), adamw.AdamWConfig(**cfg))
    for key in ("params", "mu", "nu"):
        _assert_trees_close(got[key], want[key], **TOL)
    assert int(got["step"]) == int(want["step"]) == 4
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), **TOL)
    # the old state is left as it was
    np.testing.assert_array_equal(tstate["params"]["w"].numpy(), params["w"])


def test_init_state_mirrors_the_tree():
    state = adamw.init_state(_to_torch(_tree(0)))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert [t.shape for t in tree.leaves(state["mu"])] == \
        [t.shape for t in tree.leaves(state["params"])]
    assert not any(t.any() for t in tree.leaves(state["nu"]))


@pytest.mark.parametrize("process", [(0, 1), (1, 2)])
def test_synthetic_batches_bitwise(process):
    idx, count = process
    jd = JSyntheticLMData(JDataConfig(vocab_size=512, seq_len=33, global_batch=4), idx, count)
    td = SyntheticLMData(DataConfig(vocab_size=512, seq_len=33, global_batch=4), idx, count)
    for step in (0, 1, 17):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert sorted(got) == ["targets", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_iterator_position():
    data = SyntheticLMData(DataConfig(vocab_size=100, seq_len=8, global_batch=2))
    it = PrefetchIterator(data)
    try:
        for step in range(3):
            np.testing.assert_array_equal(next(it)["tokens"], data.batch_at(step)["tokens"])
        assert it.state.step == 3
    finally:
        it.close()


def _state(seed=0):
    return {"params": {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(seed)),
                       "layers": [{"s": torch.ones(2, 5)}, {"s": torch.zeros(5)}],
                       "half": torch.full((3,), 1.5, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    state = _state()
    path = mgr.save(7, state, extra={"step": 7, "iterator": {"step": 7, "seed": 1}})
    assert path.name == "step_00000007"
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["n_leaves"] == 5
    assert ["params", "layers", 0, "s"] in [m["path"] for m in manifest["leaves"]]
    got, extra = mgr.restore(like=state)
    assert extra == {"step": 7, "iterator": {"step": 7, "seed": 1}}
    for a, b in zip(tree.leaves(got), tree.leaves(state)):
        assert a.dtype == b.dtype and a.device.type == "cpu"
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert isinstance(got["params"]["layers"], list)
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(like={"params": {"w": torch.zeros(4, 3)}})


def test_checkpoint_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [3, 4]
    # a save cut before its rename, and a directory with no manifest, are
    # not checkpoints
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000008").mkdir()
    assert mgr.latest_step() == 4
    got, _ = mgr.restore()
    torch.testing.assert_close(got["params"]["w"], _state(4)["params"]["w"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_train_state_from_jax():
    cfg = j_get_reduced_config("repro-100m", dtype=jnp.float32)
    jstate = jadamw.init_state(JModel(cfg).init(jax.random.PRNGKey(0)))
    jstate = dict(jstate, step=jnp.int32(5))
    tcfg = get_reduced_config("repro-100m")  # bf16 compute, f32 masters
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    assert int(state["step"]) == 5
    leaves = tree.leaves(state["params"])
    assert all(t.dtype == torch.float32 for t in leaves)
    np.testing.assert_array_equal(state["params"]["embed"].numpy(),
                                  np.asarray(jstate["params"]["embed"]))
    _assert_trees_close(state["params"], jstate["params"], atol=0, rtol=0)


def test_train_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        train.train(["--reduced", "--steps", "1"])


def _softmax_plan(tmp_path):
    from repro_torch import sfu
    from repro_torch.configs import get_config

    cfg = get_config("repro-100m", act_impl="fused", pwl_softmax=True)
    return str(sfu.dump_plan(sfu.compile_plan(cfg), tmp_path / "softmax_plan.json"))


def test_training_past_the_dense_cap_takes_the_flash_kernels(tmp_path, monkeypatch):
    """With the dense cap at 0 every attention of the reduced model is past
    it: the launcher trains (the loss falls, rc 0) through the flash op's
    forward and the plain version of its backward kernels, once each per
    layer and step (the reduced config has no remat)."""
    from repro_torch.kernels.fused import attention as tattn
    from repro_torch.models import layers

    plan = _softmax_plan(tmp_path)
    monkeypatch.setattr(layers, "DENSE_FUSED_SOFTMAX_MAX_SCORES", 0)
    calls = {"forward": 0, "backward": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tattn, "fused_flash_attention_plain",
                        counted("forward", tattn.fused_flash_attention_plain))
    monkeypatch.setattr(tattn, "fused_flash_attention_bwd",
                        counted("backward", tattn.fused_flash_attention_bwd))
    steps = 8
    out = train.run(_args(tmp_path / "ck", steps, "--plan", plan, "--lr", "3e-3"))
    assert out["rc"] == 0 and len(out["losses"]) == steps
    assert all(np.isfinite(out["losses"]))
    n_layers = get_reduced_config("repro-100m").n_layers
    assert calls == {"forward": n_layers * steps, "backward": n_layers * steps}


def test_model_parallel_and_removed_flags_are_refused():
    # without a process group (torchrun), a mesh has no ranks to span
    with pytest.raises(ValueError, match="process group of several ranks"):
        train.train(["--reduced", "--device", "cpu", "--model-parallel", "2"])
    with pytest.raises(SystemExit):
        train.train(["--reduced", "--device", "cpu", "--act-impl", "fused"])


def _args(tmp_path, steps, *extra):
    return train.build_parser().parse_args(
        ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "24", "--steps", str(steps),
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "100", *extra])


def test_resume_continues_exactly(tmp_path):
    """4 steps straight give the losses of 2 steps, a save, a restore and 2
    more (the schedule is the same for the first 5 steps at any length)."""
    straight = train.run(_args(tmp_path / "a", 4))
    first = train.run(_args(tmp_path / "b", 2))
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 2
    second = train.run(_args(tmp_path / "b", 4))
    assert len(straight["losses"]) == 4 and len(second["losses"]) == 2
    np.testing.assert_array_equal(first["losses"] + second["losses"], straight["losses"])
    a, _ = CheckpointManager(str(tmp_path / "a")).restore()
    b, _ = CheckpointManager(str(tmp_path / "b")).restore()
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_train_on_cpu_under_the_fused_softmax_plan(tmp_path, capsys):
    plan = _softmax_plan(tmp_path)
    out = train.run(_args(tmp_path / "ck", 3, "--plan", plan, "--log-every", "1"))
    assert out["rc"] in (0, 2) and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert "attn.softmax:exp': 'fused'" in capsys.readouterr().out


def test_sigterm_saves_a_checkpoint(tmp_path):
    saved = []
    prev = signal.getsignal(signal.SIGTERM)
    try:
        install_sigterm_save(lambda: saved.append(True))
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(SystemExit) as e:
            handler(signal.SIGTERM, None)
        assert e.value.code == 143 and saved == [True]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_reduced_config_trains_without_remat():
    assert get_reduced_config("repro-100m").remat is False
    assert dataclasses.replace(get_reduced_config("repro-100m"), remat=True).remat
