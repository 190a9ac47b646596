"""Port parity: the deterministic fault injector (``repro_torch.serving.faults``)
against the JAX package's (``repro.serving.faults``): spec validation, the
"first opportunity at or after its step" rule, the allocator's scopes, the
canned chaos mix per seed, and the injector's firing log on the same
sequence of queries.  Pure host logic: no model runs here.
"""
import dataclasses

import pytest

import repro  # noqa: F401
from repro.serving import faults as jfaults
from repro_torch.serving import (
    FAULT_KINDS,
    ContinuousBatchingScheduler,
    FaultInjector,
    FaultSpec,
    GenRequest,
    PageAllocator,
    PagePoolExhausted,
    chaos_specs,
)


def test_fault_kinds_are_jax_s():
    assert FAULT_KINDS == jfaults.FAULT_KINDS


@pytest.mark.parametrize("kw,err", [({"kind": "meltdown", "step": 0}, "unknown fault kind"),
                                    ({"kind": "nan", "step": 1, "count": 0}, "count must be"),
                                    ({"kind": "drop_tick", "step": 2, "count": -3},
                                     "count must be")],
                         ids=["kind", "count0", "count_negative"])
def test_fault_spec_validation(kw, err):
    with pytest.raises(ValueError, match=err):
        FaultSpec(**kw)
    with pytest.raises(ValueError, match=err):
        jfaults.FaultSpec(**kw)


def test_fault_spec_is_frozen_with_jax_s_defaults():
    spec = FaultSpec("nan", 3)
    assert (spec.site, spec.count) == ("", 1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.step = 4


@pytest.mark.parametrize("kind,query", [("kernel_fail", "kernel_fail_due"),
                                        ("drop_tick", "drop_tick_due"),
                                        ("alloc_exhaust", "alloc_should_fail")])
def test_fires_at_first_opportunity_at_or_after_its_step(kind, query):
    inj = FaultInjector([FaultSpec(kind, step=3, count=2)])
    ask = getattr(inj, query)
    for step in range(3):
        inj.set_step(step)
        assert not ask()
    inj.set_step(5)  # no query at steps 3 and 4: it fires at the next one
    assert ask() and ask() and not ask()
    assert inj.exhausted
    assert [f["fired_step"] for f in inj.fired] == [5, 5]
    assert all(f["armed_step"] == 3 and f["kind"] == kind for f in inj.fired)


def test_nan_site_due_names_the_site_once():
    inj = FaultInjector([FaultSpec("nan", step=1, site="mlp:gelu_tanh")])
    inj.set_step(0)
    assert inj.nan_site_due() is None
    inj.set_step(1)
    assert inj.nan_site_due() == "mlp:gelu_tanh"
    assert inj.nan_site_due() is None


@pytest.mark.parametrize("site,scopes", [("grow", {"grow"}), ("admit", {"admit"}),
                                         ("", {"grow", "admit", ""})])
def test_allocator_scopes(site, scopes):
    for scope in ("grow", "admit", ""):
        inj = FaultInjector([FaultSpec("alloc_exhaust", step=0, site=site)])
        inj.set_step(0)
        alloc = PageAllocator(8, faults=inj)
        if scope in scopes:
            with pytest.raises(PagePoolExhausted, match="injected fault"):
                alloc.alloc(1, scope=scope)
            assert alloc.num_free == 7  # nothing was taken
            assert alloc.alloc(1, scope=scope) == [1]  # spent after one firing
        else:
            assert alloc.alloc(2, scope=scope) == [1, 2]
        assert alloc.alloc(0, scope=scope) == []


def test_scheduler_passes_admit_and_grow_scopes():
    inj = FaultInjector([FaultSpec("alloc_exhaust", step=0, site="admit"),
                         FaultSpec("alloc_exhaust", step=0, site="grow")])
    inj.set_step(0)
    sched = ContinuousBatchingScheduler(2, 4, 16, policy="optimistic", faults=inj)
    sched.submit(GenRequest("a", [1, 2, 3, 4], 4))
    assert sched.admit() == []  # the admit-scoped fault defers the admission
    (adm,) = sched.admit()
    assert adm.request.request_id == "a" and len(adm.pages) == 1
    with pytest.raises(PagePoolExhausted):  # kv_len 4 fills the page: grow allocates
        sched.grow(adm.slot)
    assert sched.grow(adm.slot) is not None
    assert [f["site"] for f in inj.fired] == ["admit", "grow"]


@pytest.mark.parametrize("seed", range(32))
def test_chaos_specs_equal_jax_s(seed):
    for site, max_step in (("mlp:gelu_tanh", 8), ("moe.expert:silu", 2), ("mlp:silu", 15)):
        got = chaos_specs(seed, site, max_step=max_step)
        want = jfaults.chaos_specs(seed, site, max_step=max_step)
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]


SPECS = [("alloc_exhaust", 1, "grow", 1), ("alloc_exhaust", 0, "admit", 2),
         ("nan", 2, "mlp:gelu_tanh", 1), ("kernel_fail", 3, "", 2), ("drop_tick", 1, "", 1),
         ("nan", 4, "attn.softmax:exp", 1), ("alloc_exhaust", 5, "", 1)]
# (step, query, scope); the engine's order within a step: grow, then the call
QUERIES = [(s, q, scope) for s in range(8) for q, scope in (
    ("alloc_should_fail", "admit"), ("alloc_should_fail", "grow"), ("nan_site_due", None),
    ("kernel_fail_due", None), ("drop_tick_due", None), ("kernel_fail_due", None))]


@pytest.mark.parametrize("order", ["forward", "reversed_specs"])
def test_injector_log_equals_jax_s(order):
    specs = SPECS if order == "forward" else SPECS[::-1]
    got_inj = FaultInjector([FaultSpec(*s) for s in specs])
    want_inj = jfaults.FaultInjector([jfaults.FaultSpec(*s) for s in specs])
    for step, query, scope in QUERIES:
        for inj in (got_inj, want_inj):
            inj.set_step(step)
        args = () if scope is None else (scope,)
        assert getattr(got_inj, query)(*args) == getattr(want_inj, query)(*args), \
            (step, query, scope)
    assert got_inj.fired == want_inj.fired
    assert got_inj.exhausted == want_inj.exhausted
    assert len(got_inj.fired) == sum(s[3] for s in specs)
