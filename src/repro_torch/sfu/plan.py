"""`ActivationPlan`: compiled per-site approximation plans.

A plan maps site keys (``"mlp:gelu_tanh"``, ``"attn.softmax:exp"``, ...) to
:class:`ApproxSpec` records.  It is compiled once per model config by
:func:`compile_plan` and threaded through the model layers.  Plans use the
same JSON (and so the same fingerprint) as the JAX package's plans, so a
plan dumped by one package loads in the other.

Sites: ``mlp`` (dense FFN, fused: GLU epilogue), ``moe.expert``, ``ssm``
(no fused producer) and ``attn.softmax`` (PWL exp inside softmax).  A site
planned ``impl="fused"`` that cannot run fused reports it once through
:func:`warn_fused_fallback`.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import pathlib
import warnings
from typing import Callable, Iterator, Optional

from repro_torch.core import functions as F
from repro_torch.core import pwl

from .spec import DEFAULT_FIT, IMPLS, ApproxSpec
from .store import TableStore, get_store

PLAN_SCHEMA = 1

SITE_MLP = "mlp"
SITE_MOE = "moe.expert"
SITE_SSM = "ssm"
SITE_SOFTMAX = "attn.softmax"

# sites with a fused producer kernel (mlp -> GLU/linear, moe.expert ->
# per-expert GLU, attn.softmax -> PWL-exp softmax)
FUSED_SITES = (SITE_MLP, SITE_MOE, SITE_SOFTMAX)


def site_key(site: str, fn: str) -> str:
    return f"{site}:{fn}"


_FALLBACK_WARNED: set[str] = set()


def warn_fused_fallback(key: str, reason: str) -> None:
    """Warn once per site key that a fused-planned site runs unfused."""
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(
        f"activation site '{key}' is planned impl='fused' but is falling "
        f"back to the unfused PWL path: {reason}",
        stacklevel=2,
    )


def reset_fused_fallback_warnings() -> None:
    _FALLBACK_WARNED.clear()


def reset_all_warnings() -> None:
    """Reset every warn-once latch in one call: the fused-fallback warnings
    above and the guard's non-finite warnings
    (``sfu.guard.reset_guard_warnings``).  The serving engine calls it at
    the start of each ``run()``, so every session reports its own."""
    reset_fused_fallback_warnings()
    from . import guard

    guard.reset_guard_warnings()


@dataclasses.dataclass(frozen=True)
class ActivationPlan:
    """Ordered, frozen mapping of site keys to ApproxSpecs."""

    sites: tuple[tuple[str, ApproxSpec], ...] = ()

    def __iter__(self) -> Iterator[str]:
        return (k for k, _ in self.sites)

    def items(self) -> tuple[tuple[str, ApproxSpec], ...]:
        return self.sites

    def get(self, key: str, default: Optional[ApproxSpec] = None) -> Optional[ApproxSpec]:
        for k, s in self.sites:
            if k == key:
                return s
        return default

    def spec(self, key: str) -> ApproxSpec:
        s = self.get(key)
        if s is None:
            raise KeyError(
                f"plan has no site '{key}'; sites: {[k for k, _ in self.sites]}"
            )
        return s

    def act(self, key: str, store: Optional[TableStore] = None) -> Callable:
        """Elementwise activation callable for a site.  ``impl="fused"``
        resolves to the plain PWL evaluation, its unfused fallback; the fused
        dispatch itself goes through :meth:`fused_table`.  Under an open
        ``sfu.guard`` collector a table-backed impl comes wrapped in the
        guard's clamp / finite counters; otherwise (the guard off) it comes
        bare.  The layers resolve their activations inside each model call,
        so the engine's collector is open when it counts."""
        spec = self.spec(key)
        if spec.impl == "fused" and key.split(":", 1)[0] not in FUSED_SITES:
            warn_fused_fallback(
                key, "no fused producer kernel covers this site; evaluating "
                "the PWL table elementwise (impl='jnp' semantics)"
            )
        fn = resolve_spec(spec, store)
        from . import guard

        if spec.impl == "exact" or not guard.active():
            return fn
        table = (store or get_store()).get(spec)
        return guard.wrap_elementwise(key, fn, float(table.bp[0]), float(table.bp[-1]))

    def fused_table(self, key: str, store: Optional[TableStore] = None) -> Optional[pwl.PWLTable]:
        """Table for the fused-epilogue path, or None when the site is absent
        or not planned fused."""
        s = self.get(key)
        if s is None or s.impl != "fused":
            return None
        return (store or get_store()).get(s)

    def to_json(self) -> dict:
        return {
            "schema": PLAN_SCHEMA,
            "sites": [[k, s.to_json()] for k, s in self.sites],
        }

    @classmethod
    def from_json(cls, d: dict) -> "ActivationPlan":
        return cls(sites=tuple((k, ApproxSpec.from_json(s)) for k, s in d["sites"]))

    def dumps(self, indent: int = 2) -> str:
        return json.dumps(self.to_json(), indent=indent)

    @classmethod
    def loads(cls, s: str) -> "ActivationPlan":
        return cls.from_json(json.loads(s))

    @property
    def fingerprint(self) -> str:
        """Stable short id of the exact plan (the JAX package's id too)."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]


def resolve_spec(spec: ApproxSpec, store: Optional[TableStore] = None) -> Callable:
    """ApproxSpec -> elementwise callable (any shape/dtype input)."""
    if spec.impl == "exact":
        return F.get(spec.fn).fn
    table = (store or get_store()).get(spec)
    if spec.impl == "kernel":
        from repro_torch.kernels import ops as kops

        def pwl_kernel_act(x, _table=table):
            return kops.pwl_activation(x, _table)

        return pwl_kernel_act

    # "jnp", and the elementwise fallback of "fused"
    def pwl_act(x, _table=table):
        return pwl.eval_coeff(x, _table)

    return pwl_act


def model_sites(cfg) -> list[tuple[str, str]]:
    """(site, fn) pairs a config's architecture instantiates."""
    sites: list[tuple[str, str]] = []
    if getattr(cfg, "is_encoder_decoder", False):
        has_dense, has_moe, has_ssm = True, False, False
    else:
        kinds = cfg.layer_kinds
        has_dense = any(f == "dense" for _, f in kinds)
        has_moe = any(f == "moe" for _, f in kinds)
        has_ssm = any(m == "ssm" for m, _ in kinds)
    if has_dense:
        sites.append((SITE_MLP, cfg.activation))
    if has_moe:
        sites.append((SITE_MOE, cfg.activation))
    if has_ssm:
        sites.append((SITE_SSM, "silu"))
        sites.append((SITE_SSM, "softplus"))
    if getattr(cfg, "pwl_softmax", False):
        sites.append((SITE_SOFTMAX, "exp"))
    return sites


def _site_spec(cfg, site: str, fn: str, dtype: str) -> ApproxSpec:
    impl = getattr(cfg, "act_impl", "exact")
    if impl not in IMPLS:
        raise ValueError(f"unknown activation impl '{impl}'; expected one of {IMPLS}")
    if impl == "fused" and site not in FUSED_SITES:
        impl = "jnp"  # no fused producer kernel: record the unfused fallback
    return ApproxSpec(fn=fn, n_segments=cfg.act_breakpoints + 1, dtype=dtype,
                      impl=impl, fit=DEFAULT_FIT)


def compile_plan(cfg) -> ActivationPlan:
    """Compile a ModelConfig's activation knobs into an ActivationPlan.

    Precedence: ``cfg.act_plan`` as-is; else the uniform translation of
    ``act_impl`` / ``act_breakpoints`` / ``act_table_dtype``, with
    ``cfg.act_site_specs`` pins applied last-match-wins."""
    explicit = getattr(cfg, "act_plan", None)
    if explicit is not None:
        return explicit
    dtype = getattr(cfg, "act_table_dtype", "f32")
    pins = tuple(getattr(cfg, "act_site_specs", ()) or ())
    sites = []
    matched: set[str] = set()
    for site, fn in model_sites(cfg):
        key = site_key(site, fn)
        spec = _site_spec(cfg, site, fn, dtype)
        for pin_key, pin_spec in pins:
            if pin_key == key:
                spec = pin_spec
                matched.add(pin_key)
        sites.append((key, spec))
    unmatched = [k for k, _ in pins if k not in matched]
    if unmatched:
        raise ValueError(
            f"act_site_specs keys {unmatched} match no activation site this "
            f"config instantiates; sites: {[k for k, _ in sites]}"
        )
    return ActivationPlan(sites=tuple(sites))


def plan_missing_sites(cfg, plan: ActivationPlan) -> list[str]:
    """Site keys `cfg` instantiates that `plan` lacks (the softmax site is
    optional: absent means exact exp)."""
    need = {site_key(site, fn) for site, fn in model_sites(cfg) if site != SITE_SOFTMAX}
    return sorted(need - set(plan))


@functools.lru_cache(maxsize=512)
def _plan_for_cached(cfg) -> ActivationPlan:
    return compile_plan(cfg)


def plan_for(cfg) -> ActivationPlan:
    """The plan a model built from `cfg` executes (compiled once per config)."""
    explicit = getattr(cfg, "act_plan", None)
    if explicit is not None:
        return explicit
    return _plan_for_cached(cfg)


def dump_plan(plan: ActivationPlan, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(plan.dumps() + "\n")
    return path


def load_plan(path) -> ActivationPlan:
    return ActivationPlan.loads(pathlib.Path(path).read_text())
