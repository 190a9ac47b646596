"""Port parity: the reduced repro-100m model of ``repro_torch`` against the
JAX ``Model`` on converted parameters, in float32.

The same weights (the JAX init, converted through numpy) give the same
logits through ``forward``, ``prefill_paged`` and ``decode_step_paged`` at
atol/rtol 1e-4: the sums are taken in another order.  Within the port, a
paged engine session gives the dense greedy tokens and returns every page.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro_torch import sfu
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.launch.serve import generate
from repro_torch.models import Model, layers, params_from_numpy
from repro_torch.serving import GenRequest, PageAllocator, PagedServingEngine, RetryPolicy
from repro_torch.serving.resilience import SimulatedKernelFailure

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg = get_reduced_config("repro-100m", act_impl="fused", dtype=jnp.float32)
    tcfg = t_get_reduced_config("repro-100m", act_impl="fused", dtype=torch.float32)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = Model(tcfg, device="cpu")
    return jmodel, jparams, tmodel, params_from_numpy(tree, tcfg, "cpu")


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def test_forward_logits_match(pair):
    jmodel, jparams, tmodel, tparams = pair
    toks = _tokens(0, (2, 24))
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_prefill_and_decode_logits_match(pair):
    jmodel, jparams, tmodel, tparams = pair
    ps, P, n = 16, 9, 20  # a 20-token prompt in a 32-token bucket
    alloc = PageAllocator(P)
    alloc.free(alloc.alloc(3)[::-1])  # recycle, so the pages come out reversed
    pages = alloc.alloc(2)
    table = np.asarray([pages + [0]], np.int32)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = _tokens(1, (n,))
    lens = np.asarray([n], np.int32)

    jcache = jmodel.make_paged_cache(P, ps)
    jlog, jcache = jmodel.prefill_paged(jparams, jnp.asarray(toks), jcache,
                                        jnp.asarray(table[:, :2]), jnp.asarray(lens))
    tcache = tmodel.make_paged_cache(P, ps)
    tlog = tmodel.prefill_paged(tparams, torch.from_numpy(toks), tcache,
                                torch.from_numpy(table[:, :2]), torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)

    # three decode steps; the first token's K/V lands at position 20
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
    # the pools agree away from the sentinel page
    for jl, tl in zip(jcache, tcache):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tl[name][:, :, 1:].numpy(),
                                       np.asarray(jl[name])[:, :, 1:], **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_masks_match_jax(causal):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 9, 2, 16)).astype(np.float32)  # GQA: 2 groups
    v = rng.standard_normal((3, 9, 2, 16)).astype(np.float32)
    valid = np.array([9, 4, 0], np.int32)  # full, ragged, and no valid key
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, kv_valid_len=jnp.asarray(valid))
    got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 kv_valid_len=torch.from_numpy(valid), q_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2].any()  # a row with no valid key gives 0


def test_fused_softmax_plan_runs_elementwise_on_the_cpu_only():
    """The fused PWL-exp attention kernels are not ported: a plan with the
    softmax site fused runs their plain version on the CPU (and warns) and
    raises on any other device instead of giving way to it there."""
    cfg = t_get_reduced_config("repro-100m", act_impl="fused", pwl_softmax=True,
                               dtype=torch.float32)
    D, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = D // H
    g = torch.Generator().manual_seed(0)
    shapes = {"wq": (D, H, dh), "wk": (D, Hkv, dh), "wv": (D, Hkv, dh), "wo": (H, dh, D)}
    params = {k: 0.1 * torch.randn(s, generator=g) for k, s in shapes.items()}
    x = torch.randn(1, 5, D, generator=g)
    sfu.reset_fused_fallback_warnings()
    with pytest.warns(UserWarning, match="attn.softmax:exp"):
        y, _ = layers.attention_layer(cfg, params, x)
    assert torch.isfinite(y).all()
    meta = {k: w.to("meta") for k, w in params.items()}
    with pytest.raises(NotImplementedError, match="not ported to meta"):
        layers.attention_layer(cfg, meta, x.to("meta"))


def _dense_greedy(model, params, prompt, n_new):
    toks = torch.tensor([prompt], dtype=torch.int32)
    return generate(model, params, toks, max_new=n_new)[0].tolist()


def test_paged_session_equals_dense_greedy_and_frees_pages(pair):
    _, _, tmodel, tparams = pair
    rng = np.random.default_rng(0)
    reqs = [GenRequest("a", rng.integers(1, 500, size=11).tolist(), 4),
            GenRequest("b", rng.integers(1, 500, size=27).tolist(), 6),
            GenRequest("c", rng.integers(1, 500, size=5).tolist(), 5)]
    engine = PagedServingEngine(tmodel, tparams, max_slots=2, page_size=16, max_context=64)
    got = {r.request_id: r.tokens for r in engine.run(reqs)}
    ref = {r.request_id: _dense_greedy(tmodel, tparams, r.prompt, r.max_new_tokens)
           for r in reqs}
    assert got == ref
    assert engine.sched.allocator.num_free == engine.sched.allocator.num_pages - 1
    assert engine.prefills == 3 and engine.health_summary()["nonfinite_logits"] == 0


def test_optimistic_policy_preempts_and_keeps_greedy_tokens(pair):
    _, _, tmodel, tparams = pair
    rng = np.random.default_rng(4)
    reqs = [GenRequest(f"r{i}", rng.integers(1, 500, size=14).tolist(), 12)
            for i in range(3)]
    ample = PagedServingEngine(tmodel, tparams, max_slots=3, page_size=4, max_context=32)
    tight = PagedServingEngine(tmodel, tparams, max_slots=3, page_size=4, max_context=32,
                               num_pages=14, policy="optimistic")
    want = {r.request_id: r.tokens for r in ample.run(reqs)}
    got = {r.request_id: r.tokens for r in tight.run(reqs)}
    assert got == want
    assert tight.health_summary()["preemptions"] >= 1
    assert tight.sched.allocator.num_free == 13


def test_deadline_expires_active_request(pair):
    _, _, tmodel, tparams = pair
    engine = PagedServingEngine(tmodel, tparams, max_slots=2, page_size=16, max_context=64)
    res = {r.request_id: r for r in engine.run(
        [GenRequest("slow", [5, 6, 7], 10, deadline_ticks=3),
         GenRequest("ok", [8, 9], 2)])}
    assert res["slow"].finish_reason == "timeout" and len(res["slow"].tokens) < 10
    assert res["ok"].finish_reason == "length" and len(res["ok"].tokens) == 2


def test_wall_clock_budget_times_out_the_session(pair):
    _, _, tmodel, tparams = pair
    engine = PagedServingEngine(tmodel, tparams, max_slots=1, page_size=16, max_context=32,
                                wall_clock_budget_s=0.0)
    res = engine.run([GenRequest("a", [1, 2, 3], 5), GenRequest("b", [4, 5], 5)])
    assert {r.finish_reason for r in res} == {"timeout"}
    assert engine.health_summary()["timeouts"] == 2


def _flaky(fn, fail_times):
    """``fn`` that raises a retryable failure on its first ``fail_times``
    calls (``fail_times=None``: on every call)."""
    state = {"calls": 0}

    def call(*a, **kw):
        state["calls"] += 1
        if fail_times is None or state["calls"] <= fail_times:
            raise SimulatedKernelFailure("simulated decode failure")
        return fn(*a, **kw)

    return call


def test_failed_decode_step_is_retried(pair):
    _, _, tmodel, tparams = pair
    reqs = [GenRequest("a", [3, 4, 5, 6], 4)]
    want = PagedServingEngine(tmodel, tparams, max_slots=1, page_size=16,
                              max_context=32).run(reqs)[0].tokens
    eng = PagedServingEngine(tmodel, tparams, max_slots=1, page_size=16, max_context=32,
                             retry=RetryPolicy(max_retries=2, backoff_s=0.0))
    eng.model = type(tmodel)(tmodel.cfg, device="cpu")
    eng.model.decode_step_paged = _flaky(tmodel.decode_step_paged, 2)
    assert eng.run(reqs)[0].tokens == want
    assert eng.health_summary()["step_retries"] == 2


def test_decode_step_failing_past_its_retries_ends_the_work(pair):
    _, _, tmodel, tparams = pair
    eng = PagedServingEngine(tmodel, tparams, max_slots=1, page_size=16, max_context=32,
                             retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    eng.model = type(tmodel)(tmodel.cfg, device="cpu")
    eng.model.decode_step_paged = _flaky(tmodel.decode_step_paged, None)
    res = eng.run([GenRequest("a", [3, 4, 5], 4), GenRequest("b", [7, 8], 3)])
    assert {r.finish_reason for r in res} == {"preempted_unrecoverable"}
    kinds = [i["kind"] for i in eng.health_summary()["incidents"]]
    assert "step_failed" in kinds and eng.sched.allocator.num_free == eng.sched.allocator.num_pages - 1


def test_engine_refuses_an_append_past_the_page_table(pair):
    """The kernels cannot raise on a bad target, so the engine checks its host
    mirrors before every step."""
    _, _, tmodel, tparams = pair
    eng = PagedServingEngine(tmodel, tparams, max_slots=1, page_size=16, max_context=32)
    grow = eng._grow_with_preemption

    def corrupt(active):
        live = grow(active)
        eng.kv_len[live] = eng.max_cols * eng.page_size
        return live

    eng._grow_with_preemption = corrupt
    with pytest.raises(ValueError, match="past the page table"):
        eng.run([GenRequest("a", [3, 4, 5], 4)])
