"""Port parity: the serving engine's guard and fault paths
(``PagedServingEngine(guard=True, faults=...)``) against the JAX engine's, on
the reduced repro-100m config in float32 under the fused plan with the same
(converted) parameters and the same fault specs: a NaN at the MLP site, a
dropped tick and a kernel failure in one session.  The port must report
JAX's clamp counts, incidents and recoveries and emit JAX's tokens, which
are the fault-free session's.

The port writes its page pools in place (JAX's jit gives every call fresh
ones), so the re-runs are held to the pools too: after a dropped tick the
pools are bitwise a fault-free session's, and after a NaN-poisoned step and
its degraded re-run they are bitwise those of a fault-free session that runs
the same step degraded (the ``jnp`` impl rounds otherwise than the fused
plain version, so that step's own rows differ from an undegraded run's;
nothing of the poisoned attempt may survive).  One JAX session, in a
module-scoped fixture: its compiles dominate this file's time.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config
from repro.models import Model as JModel
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultSpec as JFaultSpec
from repro.serving import GenRequest as JGenRequest
from repro.serving import PagedServingEngine as JPagedServingEngine
from repro_torch import sfu
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models import Model, layers, params_from_numpy
from repro_torch.serving import FaultInjector, FaultSpec, GenRequest, PagedServingEngine

KEY = "mlp:gelu_tanh"
NAN_STEP = 2
SPECS = [("kernel_fail", 1, "", 1), ("nan", NAN_STEP, KEY, 1), ("drop_tick", 3, "", 1)]
EDGE_REL = 1e-5  # a pre-activation this close (relative to max |z|) to an edge may count either way


def _requests(cls):
    rng = np.random.default_rng(0)
    return [cls("a", rng.integers(1, 500, size=11).tolist(), 4),
            cls("b", rng.integers(1, 500, size=27).tolist(), 6),
            cls("c", rng.integers(1, 500, size=5).tolist(), 5)]


def _engine(env, **kw):
    return PagedServingEngine(env["model"], env["params"], max_slots=2, page_size=16,
                              max_context=64, **kw)


def _faults(specs):
    return FaultInjector([FaultSpec(*s) for s in specs])


def _session(env, **kw):
    eng = _engine(env, **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = eng.run(_requests(GenRequest))
    return eng, {r.request_id: (list(r.tokens), r.finish_reason) for r in res}, caught


def _pools(eng):
    return [t for layer in eng.cache for t in (layer["k_pages"], layer["v_pages"])]


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                                    for x, y in zip(a, b))


@pytest.fixture(scope="module")
def env():
    jcfg = dataclasses.replace(get_reduced_config("repro-100m"), act_impl="fused",
                               dtype=jnp.float32)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = t_get_reduced_config("repro-100m", act_impl="fused", dtype=torch.float32)
    out = {"model": Model(tcfg, device="cpu"),
           "params": params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")}
    jeng = JPagedServingEngine(jmodel, jparams, max_slots=2, page_size=16, max_context=64,
                               guard=True,
                               faults=JFaultInjector([JFaultSpec(*s) for s in SPECS]))
    jres = jeng.run(_requests(JGenRequest))
    out["jax"] = ({r.request_id: (list(r.tokens), r.finish_reason) for r in jres},
                  jeng.health_summary())
    near = []
    real = sfu.guard.count_outside

    def counting(z, lo, hi):  # the MLP checkpoint's clamp count, with its near-edge elements
        tol = EDGE_REL * float(z.abs().max())
        near.append(int(((z - lo).abs() <= tol).sum() + ((z - hi).abs() <= tol).sum()))
        return real(z, lo, hi)

    sfu.guard.count_outside = counting
    try:
        out["faulted"] = _session(out, guard=True, faults=_faults(SPECS))
    finally:
        sfu.guard.count_outside = real
    out["near_edge"] = sum(near)
    out["clean"] = _session(out, guard=True)
    out["unguarded"] = _session(out)
    return out


def test_tokens_equal_jax_and_the_fault_free_session(env):
    want, _ = env["jax"]
    _, got, _ = env["faulted"]
    _, clean, _ = env["clean"]
    _, unguarded, _ = env["unguarded"]
    assert got == want == clean == unguarded
    assert all(reason == "length" for _, reason in got.values())


def test_clamp_counts_equal_jax_within_the_edge_band(env):
    _, jh = env["jax"]
    eng, _, _ = env["faulted"]
    got, want = eng.health_summary()["clamped"], jh["clamped"]
    assert sorted(got) == sorted(want) == [KEY]
    assert want[KEY] > 0
    # no pre-activation of this session lies within 1e-5 max|z| of a table
    # edge, so the counts must be equal
    assert env["near_edge"] == 0
    assert abs(got[KEY] - want[KEY]) <= env["near_edge"]
    clean, _, _ = env["clean"]
    assert clean.health_summary()["clamped"] == got  # re-runs are not counted


def test_recoveries_and_incidents_equal_jax(env):
    _, jh = env["jax"]
    eng, _, caught = env["faulted"]
    h = eng.health_summary()
    assert h["nonfinite_recoveries"] == jh["nonfinite_recoveries"] == {KEY: 1}
    assert [i["kind"] for i in h["incidents"]] == [i["kind"] for i in jh["incidents"]]
    assert [i["kind"] for i in h["incidents"]] == [
        "step_retry", "nan_injected", "nonfinite_output", "dropped_tick"]
    deg = [i for i in h["incidents"] if i["kind"] == "nonfinite_output"]
    assert deg[0]["sites"] == [KEY] and deg[0]["degraded_to"] == "jnp"
    assert h["faults_fired"] == jh["faults_fired"]
    assert (h["step_retries"], h["dropped_ticks"]) == (jh["step_retries"], jh["dropped_ticks"])
    assert h["nonfinite"][KEY] > 0 and h["guard"]
    msgs = [str(w.message) for w in caught]
    assert sum("sfu.guard: non-finite" in m for m in msgs) == 1
    assert not any("fused" in m.lower() for m in msgs)


def test_guard_off_lets_the_nan_through(env):
    eng, got, _ = _session(env, faults=_faults([("nan", NAN_STEP, KEY, 1)]))
    _, clean, _ = env["clean"]
    assert got != clean
    h = eng.health_summary()
    assert h["nonfinite_recoveries"] == {} and h["clamped"] == {}
    assert [i["kind"] for i in h["incidents"]] == ["nan_injected"]


def test_kernel_fail_retries_then_finishes_unrecoverable(env):
    eng, got, _ = _session(env, guard=True, faults=_faults([("kernel_fail", 1, "", 2)]))
    _, clean, _ = env["clean"]
    assert got == clean and eng.health_summary()["step_retries"] == 2
    eng, got, _ = _session(env, guard=True, faults=_faults([("kernel_fail", 1, "", 5)]))
    h = eng.health_summary()
    assert [i["kind"] for i in h["incidents"]] == ["step_retry", "step_retry", "step_failed"]
    assert {reason for _, reason in got.values()} == {"preempted_unrecoverable"}
    assert eng.sched.allocator.num_free == eng.sched.allocator.num_pages - 1


def test_dropped_tick_leaves_no_drift(env):
    eng, got, _ = _session(env, guard=True, faults=_faults([("drop_tick", 1, "", 2)]))
    clean_eng, clean, _ = env["clean"]
    assert got == clean
    assert eng.health_summary()["dropped_ticks"] == 2
    assert eng.decode_steps == clean_eng.decode_steps
    assert _bitwise(_pools(eng), _pools(clean_eng))


def test_degraded_rerun_overwrites_the_poisoned_rows(env):
    eng, got, _ = _session(env, guard=True, faults=_faults([("nan", NAN_STEP, KEY, 1)]))
    ref = _engine(env, guard=True)
    primary = ref._fns["decode"]

    def decode(*args):  # the same step degraded, with no NaN
        if ref.decode_steps == NAN_STEP:
            return ref._degraded_fns((KEY,), "jnp")["decode"](*args)
        return primary(*args)

    ref._fns = {**ref._fns, "decode": decode}
    ref.run(_requests(GenRequest))
    assert all(bool(torch.isfinite(t).all()) for t in _pools(eng))
    assert _bitwise(_pools(eng), _pools(ref))
    assert eng.health_summary()["nonfinite_recoveries"] == {KEY: 1}


def test_each_run_reports_its_own_warnings(env, monkeypatch):
    real = layers._fused_mlp_hidden

    def falling_back(cfg, params, x, plan):  # a fused site that reports a fallback
        sfu.warn_fused_fallback(KEY, "test fallback")
        return real(cfg, params, x, plan)

    monkeypatch.setattr(layers, "_fused_mlp_hidden", falling_back)
    for _ in range(2):  # two sessions in one process: each reports both warnings
        _, _, caught = _session(env, guard=True, faults=_faults([("nan", 1, KEY, 1)]))
        msgs = [str(w.message) for w in caught]
        assert sum("test fallback" in m for m in msgs) == 1
        assert sum("sfu.guard: non-finite" in m for m in msgs) == 1


@pytest.mark.parametrize("argv", [["--guard"],
                                  ["--chaos", "0", "--max-slots", "2", "--batch", "3",
                                   "--prompt-len", "30", "--max-new", "8"]],
                         ids=["guard", "chaos0"])
def test_serve_guard_and_chaos_on_cpu(argv, capsys):
    from repro_torch.launch import serve

    assert serve.serve(["--reduced", "--device", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    assert "guard=True" in out and "clamped-per-site {'mlp:gelu_tanh':" in out
    if "--chaos" in argv:
        assert "chaos session OK" in out and "nonfinite recoveries" in out
    else:
        assert "fused fallbacks during session: 0" in out


def test_serve_chaos_needs_paged_mode():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.serve(["--reduced", "--device", "cpu", "--chaos", "0", "--mode", "dense"])
