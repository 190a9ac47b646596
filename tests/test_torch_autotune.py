"""Port parity: the autotuner's pieces (``repro_torch.sfu.autotune``)
against the JAX package's ``repro.sfu.autotune`` on the CPU.

* ``candidates()`` equals JAX's, compared as JSON, for every site of every
  port arch's plan (the softmax site included), quick and full; the port
  has no block axis (``blocks_for`` gives ``(None,)`` to every arm).
* ``cache_key_id`` is JAX's on the same keys; the cache computes once and
  persists; the port's machine key carries ``"package": "repro_torch"``,
  so it never aliases JAX's.
* ``workload_for`` equals JAX's but for ``dtype`` (the config's).
* ``site_mse`` is within the tolerance of the port's ``pwl.mse`` parity
  test (rel 1e-3) of JAX's for every candidate of ``mlp:gelu_tanh``,
  ``moe.expert:silu``, ``attn.softmax:exp`` and ``ssm:softplus``, and the
  candidates within the baseline's budget are the same on both sides.
* Every arm's workload function computes what JAX's does on the same f32
  inputs (1e-5); the fused arms call the fused wrappers with the table.
* ``logit_metrics`` (the e2e check's arithmetic) is JAX's
  ``e2e_logit_check`` on the same logits (1e-5).
* ``provenance`` and ``time_fn`` on the CPU; the e2e check of a reduced
  model under its own exact plan.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.sfu import autotune as jat
from repro.sfu.autotune import measure as jmeasure
from repro_torch import sfu as tsfu
from repro_torch.configs import ARCH_IDS, REDUCED_ONLY, get_config, get_reduced_config
from repro_torch.kernels import fused
from repro_torch.sfu import autotune as tat
from repro_torch.sfu.autotune import measure as tmeasure

ARCHS = [(a, False) for a in ARCH_IDS] + [(a, True) for a in REDUCED_ONLY]
ARCH_IDS_ = [a for a, _ in ARCHS]
SITES = ("mlp:gelu_tanh", "moe.expert:silu", "attn.softmax:exp", "ssm:softplus")


def _cfgs(arch, reduced, **kw):
    if reduced:
        return get_reduced_config(arch, **kw), jax_reduced(arch, **kw)
    return get_config(arch, **kw), jax_config(arch, **kw)


def _port_sites(arch, reduced):
    tc, _ = _cfgs(arch, reduced, act_impl="fused", pwl_softmax=True)
    return [k for k, _ in tsfu.compile_plan(tc).items()]


# ---------------------------------------------------------------------------
# search space


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("arch,reduced", ARCHS, ids=ARCH_IDS_)
def test_candidates_equal_jax(arch, reduced, quick):
    sites = _port_sites(arch, reduced)
    assert sites
    for key in sites:
        site, _, fn = key.partition(":")
        got = [c.to_json() for c in tat.candidates(site, fn, quick=quick)]
        want = [c.to_json() for c in jat.candidates(site, fn, quick=quick)]
        assert json.dumps(got) == json.dumps(want)
        assert sum(1 for c in got if c["impl"] == "exact") == 1
        for impl in ("fused", "jnp", "exact"):
            assert tat.blocks_for(site, impl, quick=quick) == (None,)


# ---------------------------------------------------------------------------
# measurement cache and machine key


def test_cache_key_id_matches_jax():
    keys = [{"b": 2, "a": 1}, {"kind": "site_latency", "machine": {"backend": "cpu"},
                                "spec": {"fn": "silu", "n_segments": 33}, "block": None,
                                "warmup": 2, "iters": 10}, {}]
    for k in keys:
        assert tat.cache_key_id(k) == jat.cache_key_id(k)
    assert tat.cache_key_id({"b": 2, "a": 1}) == tat.cache_key_id({"a": 1, "b": 2})
    assert tat.cache_key_id({"a": 1}) != tat.cache_key_id({"a": 2})


def test_measurement_cache_compute_once_and_persist(tmp_path):
    cache = tat.MeasurementCache(tmp_path)
    calls = []

    def compute():
        calls.append(1)
        return 42.0

    key = {"kind": "t", "machine": {"backend": "cpu"}, "x": 1}
    assert cache.get_or(key, compute) == 42.0
    assert cache.get_or(key, compute) == 42.0
    assert len(calls) == 1 and cache.misses == 1 and cache.hits == 1
    cache2 = tat.MeasurementCache(tmp_path)
    assert cache2.get_or(key, compute) == 42.0
    assert len(calls) == 1 and len(cache2) == 1
    assert cache2.get(dict(key, machine={"backend": "cuda"})) is None
    # the file is JAX's {"key", "value"} layout, which JAX's cache reads
    entry = json.loads((tmp_path / f"{tat.cache_key_id(key)}.json").read_text())
    assert entry == {"key": key, "value": 42.0}
    assert jat.MeasurementCache(tmp_path).get(key) == 42.0


def test_machine_key_never_aliases_jax():
    prov = tat.provenance(device="cpu")
    mid = tat.machine_id(prov)
    assert mid["package"] == "repro_torch"
    jmid = jat.machine_id(jat.provenance())
    assert {k: v for k, v in mid.items() if k != "package"}.keys() == jmid.keys()
    assert tat.cache_key_id(mid) != tat.cache_key_id(jmid)


def test_provenance_on_cpu():
    prov = tat.provenance(quick=True, device="cpu")
    jprov = jat.provenance(quick=True)
    assert set(prov) == (set(jprov) - {"jax_version"}) | {"torch_version"}
    assert prov["backend"] == "cpu" and prov["interpret_mode"] is True
    assert prov["device"] == "cpu" and prov["device_count"] == 1
    assert prov["mesh"] is None and prov["quick"] is True
    assert prov["torch_version"] == torch.__version__
    json.dumps(prov)


def test_time_fn_median_on_cpu():
    calls = []
    us = tat.time_fn(lambda x: calls.append(1) or x * 2, torch.ones(4), warmup=3, iters=5)
    assert us > 0 and len(calls) == 8


# ---------------------------------------------------------------------------
# workloads


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("arch,reduced", ARCHS, ids=ARCH_IDS_)
def test_workload_for_matches_jax_but_dtype(arch, reduced, quick):
    tc, jc = _cfgs(arch, reduced)
    for site in ("mlp", "moe.expert", "attn.softmax", "ssm"):
        got = tat.workload_for(tc, site, quick=quick).to_json()
        want = jat.workload_for(jc, site, quick=quick).to_json()
        assert got.pop("dtype") == {torch.bfloat16: "bf16", torch.float32: "f32"}[tc.dtype]
        assert got == want


def test_workload_inputs_in_the_config_dtype():
    wl = tat.workload_for(get_reduced_config("olmoe-1b-7b"), "moe.expert", quick=True)
    assert wl.dtype == "bf16"
    x, wg, wu = tmeasure.workload_inputs(wl, "cpu")
    assert x.shape == (wl.n_experts, wl.expert_capacity, wl.d_model)
    assert wg.shape == wu.shape == (wl.n_experts, wl.d_model, wl.d_ff)
    assert {t.dtype for t in (x, wg, wu)} == {torch.bfloat16}
    again = tmeasure.workload_inputs(wl, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((x, wg, wu), again))


# ---------------------------------------------------------------------------
# accuracy


@pytest.mark.parametrize("key", SITES)
def test_site_mse_and_qualifying_sets_match_jax(key):
    site, _, fn = key.partition(":")
    tc = get_config("repro-100m", act_impl="fused")
    base_impl = "fused" if site in tsfu.FUSED_SITES else "jnp"
    base = tsfu.ApproxSpec(fn=fn, n_segments=tc.act_breakpoints + 1, dtype="f32",
                           impl=base_impl)
    jbase = repro.sfu.ApproxSpec.from_json(base.to_json())
    budget, jbudget = tat.site_mse(base), jat.site_mse(jbase)
    assert budget == pytest.approx(jbudget, rel=1e-3)
    got_q, want_q = [], []
    for i, (c, jc) in enumerate(zip(tat.candidates(site, fn), jat.candidates(site, fn))):
        m, jm = tat.site_mse(c), jat.site_mse(jc)
        if c.impl == "exact":
            assert m == jm == 0.0
        else:
            assert m == pytest.approx(jm, rel=1e-3)
        if m <= budget * (1 + 1e-9):
            got_q.append(i)
        if jm <= jbudget * (1 + 1e-9):
            want_q.append(i)
    assert got_q == want_q
    assert len(got_q) >= 3  # the baseline's fused and jnp arms, and exact


# ---------------------------------------------------------------------------
# the arms' workload functions against JAX's on the same inputs

TINY = dict(tokens=48, d_model=32, d_ff=96, n_heads=2, head_dim=16, seq=40)
ARMS = [(site, fn, impl, n, dt)
        for site, fn in (("mlp", "gelu_tanh"), ("moe.expert", "silu"), ("attn.softmax", "exp"),
                         ("ssm", "softplus"))
        for impl, n, dt in (("fused", 33, "f32"), ("fused", 9, "int8"), ("jnp", 17, "bf16"),
                            ("exact", 33, "f32"))
        if impl != "fused" or site != "ssm"]


@pytest.mark.parametrize("site,fn,impl,n_seg,dtype", ARMS)
def test_arm_matches_jax_on_the_same_inputs(site, fn, impl, n_seg, dtype):
    import jax
    import jax.numpy as jnp

    moe = site == "moe.expert"
    kw = dict(TINY, n_experts=3 if moe else 0, expert_capacity=8 if moe else 0)
    wl = tmeasure.SiteWorkload(site=site, dtype="f32", **kw)
    jwl = jmeasure.SiteWorkload(site=site, **kw)
    spec = tsfu.ApproxSpec(fn=fn, n_segments=n_seg, dtype=dtype, impl=impl)
    jspec = repro.sfu.ApproxSpec.from_json(spec.to_json())
    fn_t, args = tmeasure._latency_thunk(spec, None, wl, "cpu")
    fn_j, _ = jmeasure._latency_thunk(jspec, None, jwl)
    if impl == "fused":
        assert fn_t.kernel is {"mlp": fused.fused_glu, "moe.expert": fused.fused_moe_glu,
                               "attn.softmax": fused.fused_flash_attention}[site]
    else:
        assert getattr(fn_t, "kernel", None) is None
    rng = np.random.default_rng(3)
    inputs = [rng.standard_normal(tuple(a.shape)).astype(np.float32) * (0.3 if i else 1.0)
              for i, a in enumerate(args)]
    with torch.no_grad():
        got = fn_t(*(torch.from_numpy(a) for a in inputs))
    # JAX op by op: under jit XLA drops the bf16 / f16 tables' intermediate
    # roundings, which the port (and JAX's eager evaluation) keeps
    with jax.disable_jit(impl != "fused"):
        want = np.asarray(fn_j(*(jnp.asarray(a) for a in inputs)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["fused", "jnp", "exact"])
def test_measure_site_latency_on_cpu(impl):
    wl = tmeasure.SiteWorkload(site="mlp", tokens=16, d_model=32, d_ff=64, dtype="bf16")
    spec = tsfu.ApproxSpec(fn="gelu_tanh", n_segments=33, impl=impl)
    n0 = fused.fused_glu.launches
    us = tat.measure_site_latency(spec, None, wl, warmup=1, iters=3, device="cpu")
    assert us > 0
    assert fused.fused_glu.launches == n0  # the CPU runs the plain version: no launch


# ---------------------------------------------------------------------------
# the e2e metrics


def test_logit_metrics_match_jax(monkeypatch):
    import jax.numpy as jnp

    import repro.models

    rng = np.random.default_rng(11)
    le = rng.standard_normal((3, 5, 97)).astype(np.float32) * 4
    lp = le + rng.standard_normal(le.shape).astype(np.float32) * 0.7
    lp[0, 0] = le[0, 0]  # some rows agree exactly

    class FakeModel:
        def __init__(self, cfg):
            self.exact = cfg.act_plan is None and cfg.act_impl == "exact"

        def init(self, rng):
            return {}

        def forward(self, params, batch):
            return jnp.asarray(le if self.exact else lp), None

    monkeypatch.setattr(repro.models, "Model", FakeModel)
    cfg = jax_reduced("repro-100m", act_impl="fused")
    want = jat.e2e_logit_check(cfg, repro.sfu.compile_plan(cfg))
    got = tat.logit_metrics(torch.from_numpy(le), torch.from_numpy(lp))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-5), k
    assert 0 < got["top1_agree"] < 1 and got["mean_kl"] > 0


def test_e2e_check_of_the_exact_plan_is_exact():
    cfg = get_reduced_config("repro-100m", act_impl="fused")
    exact = dataclasses.replace(cfg, act_impl="exact")
    m = tat.e2e_logit_check(cfg, tsfu.compile_plan(exact), device="cpu")
    assert m == {"max_logit_delta": 0.0, "mean_kl": 0.0, "top1_agree": 1.0}
    m = tat.e2e_logit_check(cfg, tsfu.compile_plan(cfg), device="cpu")
    assert m["top1_agree"] >= 0.98 and m["max_logit_delta"] > 0
