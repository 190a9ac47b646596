"""`repro_torch.sfu` — the activation-approximation plan API (torch port).

  * :class:`ApproxSpec` — how one activation site is approximated;
  * :class:`ActivationPlan` + :func:`compile_plan` — per-site plans compiled
    once per model config, JSON-compatible with the JAX package's plans;
  * :class:`TableStore` + :func:`get_store` — provenance-aware table
    artifacts keyed by (fn, n_breakpoints, dtype, fit), with the uniform
    fallback, fit-on-miss and f32 / bf16 / f16 / int8 quantization;
  * :mod:`.guard` — the opt-in clamp / non-finite counters and the NaN
    fault hook the serving engine's degrade ladder reads.
"""
from . import guard
from .plan import (
    FUSED_SITES,
    SITE_MLP,
    SITE_MOE,
    SITE_SOFTMAX,
    SITE_SSM,
    ActivationPlan,
    compile_plan,
    dump_plan,
    load_plan,
    model_sites,
    plan_for,
    plan_missing_sites,
    reset_all_warnings,
    reset_fused_fallback_warnings,
    resolve_spec,
    site_key,
    warn_fused_fallback,
)
from .spec import DEFAULT_FIT, DTYPES, FIT_SGD_V1, FIT_UNIFORM, IMPLS, ApproxSpec
from .store import TABLE_DIR, TableStore, get_store, quantize_table

__all__ = [
    "ApproxSpec",
    "ActivationPlan",
    "TableStore",
    "compile_plan",
    "plan_for",
    "resolve_spec",
    "model_sites",
    "plan_missing_sites",
    "site_key",
    "dump_plan",
    "load_plan",
    "get_store",
    "quantize_table",
    "DTYPES",
    "IMPLS",
    "DEFAULT_FIT",
    "FIT_SGD_V1",
    "FIT_UNIFORM",
    "TABLE_DIR",
    "SITE_MLP",
    "SITE_MOE",
    "SITE_SSM",
    "SITE_SOFTMAX",
    "FUSED_SITES",
    "warn_fused_fallback",
    "reset_fused_fallback_warnings",
    "reset_all_warnings",
    "guard",
]
