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
    """Under a plan with ``attn.softmax:exp`` fused, ``attention_layer`` takes
    the fused PWL-exp softmax paths (the row-softmax kernel's plain version
    for prefill and dense decode, the split-KV kernel's for paged decode) and
    gives the JAX layer's outputs at 1e-4: prefill, a dense-cache decode step
    and a paged decode step over a fragmented table."""
    jcfg = get_reduced_config("repro-100m", act_impl="fused", pwl_softmax=True,
                              dtype=jnp.float32)
    tcfg = t_get_reduced_config("repro-100m", act_impl="fused", pwl_softmax=True,
                                dtype=torch.float32)
    assert layers._softmax_fused_table(sfu.plan_for(tcfg)) is not None
    D, H, Hkv = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads
    dh = D // H
    rng = np.random.default_rng(0)
    shapes = {"wq": (D, H, dh), "wk": (D, Hkv, dh), "wv": (D, Hkv, dh), "wo": (H, dh, D)}
    params = {k: (0.2 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(w) for k, w in params.items()}
    tp = {k: torch.from_numpy(w) for k, w in params.items()}
    B, S, ps, P = 2, 16, 8, 9
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)

    # prefill (no cache)
    want, _ = jlayers.attention_layer(jcfg, jp, jnp.asarray(x))
    got, _ = layers.attention_layer(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # dense cache: prefill 16 positions of a 24-long cache, then one decode step
    zeros = np.zeros((B, 24, Hkv, dh), np.float32)
    jc = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
    tc = {"k": torch.from_numpy(zeros.copy()), "v": torch.from_numpy(zeros.copy())}
    _, jc = jlayers.attention_layer(jcfg, jp, jnp.asarray(x), cache=jc, cache_pos=0)
    layers.attention_layer(tcfg, tp, torch.from_numpy(x), cache=tc, cache_pos=0)
    want, _ = jlayers.attention_layer(jcfg, jp, jnp.asarray(x1), cache=jc, cache_pos=S)
    got, _ = layers.attention_layer(tcfg, tp, torch.from_numpy(x1), cache=tc, cache_pos=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # paged cache: LIFO reuse gives each row reversed, interleaved pages
    alloc = PageAllocator(P)
    alloc.free(alloc.alloc(6)[::-1])
    rows = [alloc.alloc(3), alloc.alloc(3)]
    table = np.asarray(rows, np.int32)
    pools = np.zeros((Hkv, P, ps, dh), np.float32)
    jc = {"k_pages": jnp.asarray(pools), "v_pages": jnp.asarray(pools)}
    tc = {"k_pages": torch.from_numpy(pools.copy()), "v_pages": torch.from_numpy(pools.copy())}
    pg = {"page_table": table[:, :2]}
    _, jc = jlayers.attention_layer(jcfg, jp, jnp.asarray(x), cache=jc,
                                    paged={k: jnp.asarray(v) for k, v in pg.items()})
    layers.attention_layer(tcfg, tp, torch.from_numpy(x), cache=tc,
                           paged={k: torch.from_numpy(v) for k, v in pg.items()})
    kv_len = np.asarray([S, 11], np.int32)  # the second request ends mid-page
    pg = {"page_table": table, "kv_len": kv_len}
    want, _ = jlayers.attention_layer(jcfg, jp, jnp.asarray(x1), cache=jc, cache_pos=jnp.asarray(kv_len),
                                      paged={k: jnp.asarray(v) for k, v in pg.items()})
    got, _ = layers.attention_layer(tcfg, tp, torch.from_numpy(x1), cache=tc,
                                    cache_pos=torch.from_numpy(kv_len),
                                    paged={k: torch.from_numpy(v) for k, v in pg.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_two_kv_chunks_match_jax():
    """Past the causal unroll (S = 2064 does not split into <= 16 equal q
    chunks) attention walks 2048-key chunks and applies the PWL exp to the
    running-max correction at the chunk boundary, as the JAX package does.
    The last 16 keys are scaled up so that the rows reaching them find a new
    max in the second chunk.  Tolerance 1e-5 (the JAX suite's for its flash
    paths)."""
    jcfg = get_reduced_config("repro-100m", act_impl="jnp", pwl_softmax=True,
                              dtype=jnp.float32)
    tcfg = t_get_reduced_config("repro-100m", act_impl="jnp", pwl_softmax=True,
                                dtype=torch.float32)
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 2064, 2, 16)).astype(np.float32) for _ in range(3))
    k[:, 2048:] *= 3.0
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                   exp_fn=jlayers.resolve_exp(jcfg))
    got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=True, exp_fn=layers.resolve_exp(tcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


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
