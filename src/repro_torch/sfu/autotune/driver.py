"""The autotune search driver: space x measurements -> ActivationPlan.

Per plan site of the target architecture, the driver

  1. sets the **accuracy budget** from the config's own baseline plan
     (the uniform ``act_impl="fused"`` / 32-breakpoint / f32 plan every
     launcher compiles by default): a candidate qualifies only if its
     per-function table MSE (:func:`~.measure.site_mse`) is within
     ``mse_scale`` x the baseline's.  A site the config pins exact
     (``act_site_specs``, e.g. ``ssm:silu``) has budget 0, so only exact
     candidates qualify — the autotuner cannot un-pin a safety pin;
  2. **measures latency** for every qualifying candidate at the config's
     own dimensions and in its dtype, on ``AutotuneConfig.device`` (the
     block loop of :func:`~.space.blocks_for` has the one ``None`` block:
     the CUDA kernels fix their own tiles);
  3. picks the **latency argmin** (ties broken by lower MSE, then by
     deterministic candidate order);

then gates the assembled plan end-to-end with the Table-3-style logit
check (:func:`~.measure.e2e_logit_check`).  If greedy top-1 agreement
falls below ``min_top1``, the driver falls back to the accuracy-first
candidate per site (lowest MSE — in practice exact) and re-checks.

Every measurement is keyed by (machine, workload, spec, block, iters) in a
:class:`~.cache.MeasurementCache`, so re-runs are incremental and a warm
cache plus fixed seed reproduces the plan byte-for-byte.  Raw
measurements go in the **report**, not the plan: the plan JSON stays
exactly the schema ``--plan`` consumes, with the same fingerprint recipe as
any hand-written plan (and the JAX package's).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

from repro_torch.sfu.plan import ActivationPlan, compile_plan
from repro_torch.sfu.spec import ApproxSpec

from . import space
from .cache import MeasurementCache
from .measure import (
    e2e_logit_check,
    machine_id,
    measure_site_latency,
    provenance,
    site_mse,
    workload_for,
)

DEFAULT_CACHE_DIR = "experiments/autotune_cache"


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """One autotune run's knobs (all deterministic given a warm cache)."""

    arch: str = "repro-100m"
    reduced: bool = False
    quick: bool = False          # restricted sweep + smaller workloads (CI)
    seed: int = 0                # e2e-check params/batch seed
    mse_scale: float = 1.0       # budget = baseline site MSE * mse_scale
    min_top1: float = 0.98       # e2e gate: greedy top-1 agreement vs exact
    cache_dir: Optional[str] = None
    warmup: int = 2
    iters: int = 10
    pwl_softmax: Optional[bool] = None  # None: keep the arch's own setting
    device: str = "cuda"         # where the workloads and the e2e check run


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    plan: ActivationPlan
    report: dict

    @property
    def fingerprint(self) -> str:
        return self.plan.fingerprint


def _model_cfg(at: AutotuneConfig):
    # lazy: repro_torch.configs imports repro_torch.models which imports
    # repro_torch.sfu — importing it at module scope would make sfu.autotune
    # circular
    from repro_torch.configs import get_config, get_reduced_config

    getter = get_reduced_config if at.reduced else get_config
    overrides = {"act_impl": "fused"}
    if at.pwl_softmax is not None:
        overrides["pwl_softmax"] = at.pwl_softmax
    return getter(at.arch, **overrides)


def _measure_best_block(
    cand: ApproxSpec, site: str, wl, cache: MeasurementCache, mid: dict,
    at: AutotuneConfig,
) -> tuple[float, Optional[tuple]]:
    """(best latency us, best block) over the candidate's block sweep."""
    best_us, best_block = None, None
    for block in space.blocks_for(site, cand.impl, quick=at.quick):
        key = {
            "kind": "site_latency",
            "machine": mid,
            "workload": wl.to_json(),
            "spec": cand.to_json(),
            "block": list(block) if block is not None else None,
            "warmup": at.warmup,
            "iters": at.iters,
        }
        us = cache.get_or(key, lambda c=cand, b=block: measure_site_latency(
            c, b, wl, warmup=at.warmup, iters=at.iters, device=at.device))
        if best_us is None or us < best_us:
            best_us, best_block = us, block
    return best_us, best_block


def _search_site(
    site_key: str, base_spec: ApproxSpec, cfg, cache: MeasurementCache,
    mid: dict, at: AutotuneConfig,
) -> dict:
    """Run the per-site sweep; returns the site's report entry (the chosen
    spec rides in ``entry["chosen"]["spec"]``)."""
    site, _, fn = site_key.partition(":")
    wl = workload_for(cfg, site, quick=at.quick)
    budget = site_mse(base_spec) * at.mse_scale
    base_us, _ = _measure_best_block(base_spec, site, wl, cache, mid, at)

    cands = space.candidates(site, fn, quick=at.quick)
    # epsilon absorbs float noise so the baseline spec always qualifies
    # against its own budget
    qualifying = [(i, c, site_mse(c)) for i, c in enumerate(cands)
                  if site_mse(c) <= budget * (1 + 1e-9)]
    measured = []
    for i, c, m in qualifying:
        us, block = _measure_best_block(c, site, wl, cache, mid, at)
        measured.append({
            "spec": c.to_json(), "mse": m, "us": us,
            "block": list(block) if block is not None else None,
            "order": i,
        })
    chosen = min(measured, key=lambda e: (e["us"], e["mse"], e["order"]))
    accuracy_first = min(measured, key=lambda e: (e["mse"], e["us"], e["order"]))
    return {
        "site": site_key,
        "workload": wl.to_json(),
        "budget_mse": budget,
        "baseline": {"spec": base_spec.to_json(),
                     "mse": site_mse(base_spec), "us": base_us},
        "chosen": chosen,
        "accuracy_first": accuracy_first,
        "n_candidates": len(cands),
        "n_within_budget": len(qualifying),
        "measurements": measured,
    }


def _assemble(site_entries: list[dict], which: str) -> ActivationPlan:
    return ActivationPlan(sites=tuple(
        (e["site"], ApproxSpec.from_json(e[which]["spec"]))
        for e in site_entries
    ))


def autotune(at: AutotuneConfig) -> AutotuneResult:
    """Run the full search for ``at.arch`` and return (plan, report)."""
    cfg = _model_cfg(at)
    baseline_plan = compile_plan(cfg)
    prov = provenance(quick=at.quick, device=at.device)
    mid = machine_id(prov)
    cache = MeasurementCache(at.cache_dir or DEFAULT_CACHE_DIR)

    entries = [
        _search_site(site_key, base_spec, cfg, cache, mid, at)
        for site_key, base_spec in baseline_plan.items()
    ]
    plan = _assemble(entries, "chosen")
    e2e = e2e_logit_check(cfg, plan, seed=at.seed, device=at.device)
    fell_back = False
    if e2e["top1_agree"] < at.min_top1:
        # accuracy-first fallback: take each site's lowest-MSE qualifying
        # candidate (exact, when enumerated) and re-gate
        fell_back = True
        plan = _assemble(entries, "accuracy_first")
        e2e = e2e_logit_check(cfg, plan, seed=at.seed, device=at.device)

    which = "accuracy_first" if fell_back else "chosen"
    totals = {
        "baseline_us": sum(e["baseline"]["us"] for e in entries),
        "chosen_us": sum(e[which]["us"] for e in entries),
    }
    totals["speedup"] = (totals["baseline_us"] / totals["chosen_us"]
                         if totals["chosen_us"] else float("nan"))
    report = {
        "benchmark": "autotune",
        **prov,
        "arch": at.arch,
        "reduced": at.reduced,
        "seed": at.seed,
        "objective": {"mse_scale": at.mse_scale, "min_top1": at.min_top1},
        "baseline_fingerprint": baseline_plan.fingerprint,
        "plan_fingerprint": plan.fingerprint,
        "accuracy_fallback": fell_back,
        "e2e": e2e,
        "totals": totals,
        "sites": entries,
        "cache": {"dir": str(pathlib.Path(cache.root)),
                  "hits": cache.hits, "misses": cache.misses},
    }
    return AutotuneResult(plan=plan, report=report)
