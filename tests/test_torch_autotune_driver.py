"""Port parity: the autotune driver (``repro_torch.sfu.autotune.driver``)
and its CLI (``repro_torch.launch.autotune``) against the JAX package's on
the CPU.

The latency is stubbed in both packages, by monkeypatching the
``measure_site_latency`` that each driver module imported, with one
deterministic function of the spec's JSON that ignores the block and
gives no two specs the same time: the impls in the order the card's
measurements put them (fused, then jnp, then exact), and within an impl a
hash of the JSON.  (Under a hash alone, reduced repro-100m's plan is
``jnp`` at the MLP and exact at the softmax; its bf16 e2e top-1 agreement
is 0.992 in the port and 0.961 in JAX, whose gate then falls back: the two
packages round the bf16 model differently, and 128 positions put that gate
within a few argmax flips.  Each package draws its own weights and
tokens for the check, so only its arithmetic, ``logit_metrics``, is held
against JAX's, in ``test_torch_autotune.py``.)  With it:

* the port's plan ``dumps()`` is byte-identical to JAX's on reduced
  repro-100m (``--quick --pwl-softmax``) and on reduced olmoe-1b-7b
  (``--quick``), neither side falling back, with the same per-site report
  (chosen spec, budget, counts);
* reduced mamba2-2.7b (port only: JAX's fused GLU divides by mamba2's d_ff
  of 0, and its e2e check reaches that GLU) keeps ``ssm:silu`` exact, its
  budget 0;
* a warm-cache rerun is byte-identical with 0 misses; the plan loads into a
  config with ``plan_missing_sites == []``; the report is JSON-serialisable.

The CLI, unstubbed: ``--device cpu --reduced --quick`` writes the plan and
the report and returns 0; ``--device cuda`` without a GPU raises; a gate
that no plan can pass returns 2 with the accuracy-first plan written.
"""
import hashlib
import json

import pytest
import torch

import repro  # noqa: F401
import repro.sfu.autotune.driver as jdriver
import repro_torch.sfu.autotune.driver as tdriver
from repro.sfu import autotune as jat
from repro_torch import sfu as tsfu
from repro_torch.configs import get_reduced_config
from repro_torch.launch import autotune as cli
from repro_torch.sfu import autotune as tat


IMPL_RANK = {"fused": 0, "jnp": 1, "exact": 2}


def _stub_us(spec, block, wl, **kw):
    blob = json.dumps(spec.to_json(), sort_keys=True).encode()
    return 10.0 * (1 + IMPL_RANK[spec.impl]) + int(hashlib.sha1(blob).hexdigest()[:10], 16) / 1e12


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(jdriver, "measure_site_latency", _stub_us)
    monkeypatch.setattr(tdriver, "measure_site_latency", _stub_us)


def _site_summary(report):
    return [(e["site"], e["chosen"]["spec"], e["accuracy_first"]["spec"],
             e["baseline"]["spec"], e["n_candidates"], e["n_within_budget"],
             [m["spec"] for m in e["measurements"]]) for e in report["sites"]]


@pytest.mark.parametrize("arch,pwl_softmax", [("repro-100m", True), ("olmoe-1b-7b", None)])
def test_plan_bytes_equal_jax(stubbed, tmp_path, arch, pwl_softmax):
    kw = dict(arch=arch, reduced=True, quick=True, pwl_softmax=pwl_softmax)
    res = tat.autotune(tat.AutotuneConfig(**kw, cache_dir=str(tmp_path / "t"), device="cpu"))
    jres = jat.autotune(jat.AutotuneConfig(**kw, cache_dir=str(tmp_path / "j")))
    assert not res.report["accuracy_fallback"]
    assert not jres.report["accuracy_fallback"]
    assert res.plan.dumps() == jres.plan.dumps()
    assert res.fingerprint == jres.fingerprint
    assert _site_summary(res.report) == _site_summary(jres.report)
    sites = [e["site"] for e in res.report["sites"]]
    assert sites == (["mlp:gelu_tanh", "attn.softmax:exp"] if arch == "repro-100m"
                     else ["moe.expert:silu"])
    for e in res.report["sites"]:
        assert e["chosen"]["block"] is None and e["chosen"]["mse"] <= e["budget_mse"] * (1 + 1e-9)
        assert e["chosen"]["us"] <= e["baseline"]["us"]
        assert e["budget_mse"] == pytest.approx(
            next(j["budget_mse"] for j in jres.report["sites"] if j["site"] == e["site"]),
            rel=1e-3)
    assert res.report["e2e"]["top1_agree"] >= 0.98
    assert res.report["backend"] == "cpu" and res.report["interpret_mode"] is True

    # warm cache: the same bytes, nothing measured again
    again = tat.autotune(tat.AutotuneConfig(**kw, cache_dir=str(tmp_path / "t"), device="cpu"))
    assert again.plan.dumps() == res.plan.dumps()
    assert again.report["cache"]["misses"] == 0 and again.report["cache"]["hits"] > 0

    p = tsfu.dump_plan(res.plan, tmp_path / "plan.json")
    loaded = tsfu.load_plan(p)
    assert loaded == res.plan
    cfg = get_reduced_config(arch, act_plan=loaded)
    assert tsfu.plan_missing_sites(cfg, loaded) == []
    json.loads(json.dumps(res.report))


def test_mamba2_keeps_the_ssm_silu_pin(stubbed, tmp_path):
    at = tat.AutotuneConfig(arch="mamba2-2.7b", reduced=True, quick=True,
                            cache_dir=str(tmp_path), device="cpu")
    res = tat.autotune(at)
    rpt = res.report
    assert [e["site"] for e in rpt["sites"]] == ["mlp:silu", "ssm:silu", "ssm:softplus"]
    silu = next(e for e in rpt["sites"] if e["site"] == "ssm:silu")
    assert silu["budget_mse"] == 0.0 and silu["n_within_budget"] == 1
    assert silu["chosen"]["spec"]["impl"] == "exact"
    assert res.plan.spec("ssm:silu").impl == "exact"
    assert not rpt["accuracy_fallback"] and rpt["e2e"]["top1_agree"] >= 0.98
    assert all(c.impl != "fused" for c in tat.candidates("ssm", "softplus", quick=True))
    cfg = get_reduced_config("mamba2-2.7b", act_plan=res.plan)
    assert tsfu.plan_missing_sites(cfg, res.plan) == []
    again = tat.autotune(at)
    assert again.plan.dumps() == res.plan.dumps() and again.report["cache"]["misses"] == 0
    json.dumps(rpt)


def test_cli_on_cpu_writes_plan_and_report(tmp_path, capsys):
    out, report = tmp_path / "plan.json", tmp_path / "report.json"
    rc = cli.run(["--device", "cpu", "--reduced", "--quick", "--out", str(out),
                  "--report", str(report), "--cache-dir", str(tmp_path / "cache")])
    assert rc == 0
    plan = tsfu.load_plan(out)
    rpt = json.loads(report.read_text())
    assert rpt["plan_fingerprint"] == plan.fingerprint
    assert rpt["backend"] == "cpu" and rpt["cache"]["misses"] > 0
    assert all(s["chosen"]["us"] > 0 for s in rpt["sites"])
    printed = capsys.readouterr().out
    assert "[autotune] repro-100m (reduced, quick) on cpu [interpret mode]" in printed
    assert f"plan {plan.fingerprint}" in printed


def test_cli_gate_failure_returns_2_with_the_plan(stubbed, tmp_path):
    out = tmp_path / "plan.json"
    rc = cli.run(["--device", "cpu", "--reduced", "--quick", "--min-top1", "1.01",
                  "--out", str(out), "--report", str(tmp_path / "r.json"),
                  "--cache-dir", str(tmp_path / "cache")])
    assert rc == 2
    rpt = json.loads((tmp_path / "r.json").read_text())
    assert rpt["accuracy_fallback"] is True
    assert tsfu.load_plan(out).fingerprint == rpt["plan_fingerprint"]


def test_cli_cuda_without_a_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cli.run(["--reduced", "--quick", "--out", str(tmp_path / "p.json"),
                 "--cache-dir", str(tmp_path / "cache")])
    assert not (tmp_path / "p.json").exists()
