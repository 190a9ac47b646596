"""Measurement primitives for the autotuner: accuracy, latency, provenance.

Three layers, matching the autotuner's two-part objective:

  * **per-function accuracy** — :func:`site_mse`: MSE of the candidate's
    quantized table against the exact function over its paper interval
    (``core.functions`` ``default_range``), i.e. the quantity the paper's
    Fig. 5 / Table 2 sweep.  Deterministic, never cached.
  * **site latency** — :func:`measure_site_latency`: median wall time of a
    representative workload per plan site (GLU MLP, per-expert MoE GLU,
    flash attention, elementwise SSM gate) at the target config's
    dimensions and in its dtype.
  * **end-to-end accuracy** — :func:`e2e_logit_check`: the Table-3-style
    gate on the target config — max |logit delta|, mean KL(exact || plan)
    and greedy top-1 agreement of the candidate plan vs the all-exact
    reference on the same parameters (:func:`logit_metrics`).

Workloads are built in the config's dtype: on a GPU, f32 and bf16 reach
different kernels (the GLU family's bf16 runs on the tensor cores), and a
plan is served in ``cfg.dtype``.  A fused arm calls the fused wrapper with
the candidate's table; on a CUDA tensor that launches the kernel or raises,
and :func:`measure_site_latency` checks that every timed call launched it.
On the CPU the wrappers run their plain versions, so :func:`provenance`
marks CPU numbers ``interpret_mode`` and the driver keys the cache by the
machine: they order candidates on that machine and say nothing of a GPU.
"""
from __future__ import annotations

import dataclasses
import subprocess
import time

import torch

from repro_torch.core import functions as F
from repro_torch.core import pwl
from repro_torch.sfu.plan import (
    SITE_MLP,
    SITE_MOE,
    SITE_SOFTMAX,
    resolve_spec,
)
from repro_torch.sfu.spec import ApproxSpec
from repro_torch.sfu.store import get_store

PACKAGE = "repro_torch"

_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# provenance + timing


def _power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it ("700.00 W"), or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].rsplit(",", 1)[-1].strip() if lines else None


def provenance(quick: bool = False, mesh=None, device="cuda") -> dict:
    """The provenance block every autotune report embeds.

    ``backend``/``interpret_mode`` are the load-bearing fields: off
    ``cuda`` the fused wrappers run their plain versions, so latency
    numbers are an ordering on that machine only and must never be read as
    GPU latencies.  ``device`` (``torch.cuda.get_device_name``),
    ``power_limit`` (on ``cuda``) and ``torch_version`` pin the machine,
    and ``quick`` marks CI-smoke shapes.  ``mesh`` is None: the port runs
    on one device until distribution lands.
    """
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    prov = {
        "backend": dev.type,
        "interpret_mode": not on_cuda,
        "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
        "device_count": torch.cuda.device_count() if on_cuda else 1,
        "mesh": dict(mesh) if mesh is not None else None,
        "torch_version": torch.__version__,
        "unix_time": int(time.time()),
        "quick": bool(quick),
    }
    if on_cuda:
        prov["power_limit"] = _power_limit()
    return prov


def machine_id(prov: dict) -> dict:
    """The provenance subset that keys measurements: numbers from different
    machines/topologies, or from the JAX package, must never alias in the
    MeasurementCache."""
    return {
        "backend": prov["backend"],
        "device": prov["device"],
        "device_count": prov["device_count"],
        "mesh": prov["mesh"],
        "package": PACKAGE,
    }


def time_fn(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall-time (us) of ``fn(*args)``.  With a CUDA tensor among the
    arguments the device is synchronized before the clock starts and before
    it stops."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
            sync()
        times = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            fn(*args)
            sync()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


# ---------------------------------------------------------------------------
# accuracy: per-function table MSE


def site_mse(spec: ApproxSpec) -> float:
    """MSE of the candidate's (quantized) table vs the exact function over
    its paper interval.  ``exact`` is 0 by definition.  Deterministic —
    cheap enough to recompute, so never cached."""
    if spec.impl == "exact":
        return 0.0
    fspec = F.get(spec.fn)
    lo, hi = fspec.default_range
    table = get_store().get(spec)
    return float(pwl.mse(table, fspec, lo, hi))


# ---------------------------------------------------------------------------
# latency: one representative workload per plan site


@dataclasses.dataclass(frozen=True)
class SiteWorkload:
    """The dims one site's latency is measured at.  JSON-able (cache key)."""

    site: str
    tokens: int = 1024          # flattened batch*seq rows for matmul sites
    d_model: int = 768
    d_ff: int = 3072
    n_experts: int = 0          # moe.expert only
    expert_capacity: int = 0    # moe.expert only
    seq: int = 512              # attn.softmax only
    n_heads: int = 12           # attn.softmax only
    head_dim: int = 64          # attn.softmax only
    dtype: str = "f32"          # the config's dtype: the inputs' and weights'

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def workload_for(cfg, site: str, *, quick: bool = False) -> SiteWorkload:
    """Derive the measurement workload from a model config's dimensions."""
    scale = 4 if quick else 1
    # ssm-family configs expose an mlp: site with d_ff=0 (the gate lives in
    # the block's own projections) — measure at the conventional 4x width
    d_ff = cfg.d_ff or 4 * cfg.d_model
    if site == SITE_MOE and getattr(cfg, "moe_d_ff", 0):
        d_ff = cfg.moe_d_ff
    n_exp = max(1, getattr(cfg, "n_experts", 0)) if site == SITE_MOE else 0
    return SiteWorkload(
        site=site,
        tokens=max(128, 1024 // scale),
        d_model=cfg.d_model,
        d_ff=d_ff,
        n_experts=n_exp,
        expert_capacity=max(32, 256 // scale) if site == SITE_MOE else 0,
        seq=max(128, 512 // scale),
        n_heads=cfg.n_heads,
        head_dim=cfg.resolved_head_dim,
        dtype=_DTYPE_NAMES[cfg.dtype],
    )


def workload_inputs(wl: SiteWorkload, device="cuda") -> tuple:
    """The measurement inputs of ``wl``, in its dtype on ``device``, from a
    generator seeded 0: (q, k, v) at ``attn.softmax``, (x, w_gate, w_up) at
    ``moe.expert`` and ``mlp`` (weights scaled by 0.02), (x,) elsewhere."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.to(_DTYPES[wl.dtype])

    if wl.site == SITE_SOFTMAX:
        shape = (1, wl.seq, wl.n_heads, wl.head_dim)
        return normal(*shape), normal(*shape), normal(*shape)
    if wl.site == SITE_MOE:
        E = wl.n_experts
        return (normal(E, wl.expert_capacity, wl.d_model),
                normal(E, wl.d_model, wl.d_ff, scale=0.02),
                normal(E, wl.d_model, wl.d_ff, scale=0.02))
    if wl.site == SITE_MLP:
        return (normal(wl.tokens, wl.d_model), normal(wl.d_model, wl.d_ff, scale=0.02),
                normal(wl.d_model, wl.d_ff, scale=0.02))
    return (normal(wl.tokens, wl.d_model),)


def _latency_thunk(spec: ApproxSpec, block, wl: SiteWorkload, device="cuda"):
    """Build (fn, args) for one measurement point.

    fused arms call the fused wrappers with the candidate's table (``fn.kernel``
    is the wrapper whose launch counter they advance on a GPU); jnp/exact arms
    call what the model layers dispatch for that impl: ``plain_glu`` with the
    elementwise callable from :func:`repro_torch.sfu.plan.resolve_spec` at the
    GLU sites, the masked softmax at ``attn.softmax``, the callable alone
    elsewhere.  ``block`` is always None (see :mod:`.space`).
    """
    from repro_torch.kernels import fused
    from repro_torch.models.layers import plain_glu

    args = workload_inputs(wl, device)
    site = wl.site
    kernel = {SITE_SOFTMAX: fused.fused_flash_attention, SITE_MOE: fused.fused_moe_glu,
              SITE_MLP: fused.fused_glu}.get(site)

    if spec.impl == "fused" and kernel is not None:
        table = get_store().get(spec)
        if site == SITE_SOFTMAX:
            def run_fused(q, k, v, _t=table):
                return kernel(q, k, v, table=_t, causal=True)
        else:
            def run_fused(x, wg, wu, _t=table):
                return kernel(x, wg, wu, table=_t)
        run_fused.kernel = kernel
        return run_fused, args

    act = resolve_spec(spec)
    if site == SITE_SOFTMAX:
        scale = wl.head_dim ** -0.5
        mask = torch.ones(wl.seq, wl.seq, dtype=torch.bool, device=args[0].device).tril()
        exact = spec.impl == "exact"

        def run_softmax(q, k, v):
            s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
            s = torch.where(mask, s, float("-inf"))
            if exact:
                p = torch.softmax(s, dim=-1)
            else:
                # PWL-exp softmax: shifted scores through the approx exp
                e = act(s - s.amax(dim=-1, keepdim=True))
                e = torch.where(mask, e, 0.0)
                p = e / e.sum(dim=-1, keepdim=True)
            return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)

        return run_softmax, args

    if site in (SITE_MOE, SITE_MLP):
        def run_glu(x, wg, wu):
            return plain_glu(act, x, wg, wu)

        return run_glu, args

    # ssm (and any future unfused site): elementwise gate over (tokens, d)
    return act, args


def measure_site_latency(
    spec: ApproxSpec,
    block,
    wl: SiteWorkload,
    *,
    warmup: int = 2,
    iters: int = 10,
    device="cuda",
) -> float:
    """Median wall-time (us) of one (spec, block) point at ``wl`` dims.  On
    a GPU a fused arm must launch its kernel in every call, or this raises:
    no candidate is timed on a plain version in its place."""
    fn, args = _latency_thunk(spec, block, wl, device)
    kernel = getattr(fn, "kernel", None)
    n0 = kernel.launches if kernel is not None else 0
    us = time_fn(fn, *args, warmup=warmup, iters=iters)
    if kernel is not None and torch.device(device).type == "cuda":
        launched = kernel.launches - n0
        if launched != warmup + iters:
            raise RuntimeError(
                f"{wl.site} {spec.to_json()}: {kernel.__name__} launched {launched} kernels "
                f"in {warmup + iters} calls")
    return us


# ---------------------------------------------------------------------------
# end-to-end accuracy gate (paper Table III analogue)


def logit_metrics(le: torch.Tensor, lp: torch.Tensor) -> dict:
    """The Table-3-style distribution deltas of logits ``lp`` against the
    exact ``le`` (both (..., V)), in f32: {"max_logit_delta", "mean_kl",
    "top1_agree"}."""
    le, lp = le.float(), lp.float()
    logp = torch.log_softmax(le, dim=-1)
    logq = torch.log_softmax(lp, dim=-1)
    pe = torch.softmax(le, dim=-1)
    return {
        "max_logit_delta": float((le - lp).abs().max()),
        "mean_kl": float((pe * (logp - logq)).sum(dim=-1).mean()),
        "top1_agree": float((le.argmax(dim=-1) == lp.argmax(dim=-1)).float().mean()),
    }


def e2e_logit_check(cfg, plan, *, batch: int = 4, seq: int = 32,
                    seed: int = 0, device="cuda") -> dict:
    """Run the target config exact and under ``plan`` on the SAME params
    (``Model.init(seed)`` on ``device``) and batch; report
    :func:`logit_metrics`.  The driver gates the emitted plan on
    ``top1_agree`` (greedy-decode agreement, the closest analogue of the
    paper's top-1 accuracy drop)."""
    from repro_torch.models import Model

    dev = torch.device(device)
    cfg_exact = dataclasses.replace(cfg, act_impl="exact", act_plan=None)
    cfg_plan = dataclasses.replace(cfg, act_plan=plan)
    model_e = Model(cfg_exact, device=dev)
    params = model_e.init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    extra = {}
    if getattr(cfg, "is_encoder_decoder", False):
        extra["frames"] = torch.randn(batch, cfg.encoder_seq, cfg.d_model, generator=gen,
                                      device=dev).to(cfg.dtype)
    if getattr(cfg, "n_vision_tokens", 0):
        extra["vision_embeds"] = torch.randn(batch, cfg.n_vision_tokens, cfg.d_model,
                                             generator=gen, device=dev).to(cfg.dtype)
    with torch.no_grad():
        le = model_e.forward(params, tokens, **extra)
        lp = Model(cfg_plan, device=dev).forward(params, tokens, **extra)
    return logit_metrics(le, lp)
