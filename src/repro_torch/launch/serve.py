"""Serving launcher (torch port): continuous batching over the paged KV cache.

    python -m repro_torch.launch.serve --arch repro-100m            # on cuda
    python -m repro_torch.launch.serve --arch repro-100m --reduced --device cpu

``--mode paged`` (default) drives :class:`repro_torch.serving.PagedServingEngine`:
prompts are admitted into fixed batch slots between decode steps, every
layer's GLU runs the fused PWL kernel, K/V go into the paged pools through
the in-place page-write kernels, and finished requests release their pages
at once.  ``--mode dense`` is the reference loop over a dense per-request
cache: one prefill, then one append + attend per token.  A config whose
layers have no paged layout (gemma3's sliding-window rings, mamba2's SSM
states) makes the paged cache raise ``UnsupportedCacheError``; the launcher
then says so on stderr and runs the dense loop, as the JAX launcher does.

Resilience, as in the JAX launcher: ``--policy optimistic`` admits on free
pages and recovers by recompute preemption; ``--deadline-ticks N`` gives
every request an N-decode-step budget; ``--guard`` runs the engine with the
``sfu.guard`` clamp / finite counters and the non-finite degrade re-run;
``--chaos SEED`` runs the seeded chaos session (allocator exhaustion, a NaN
at the MLP site, one deadline expiry) against a fault-free reference and
returns 1 unless every other request is token-identical and the health
summary shows the injected incidents.  A paged session that falls back
from a fused site returns 1.

The device defaults to ``cuda``.  Without a GPU the launcher raises; it runs
on the CPU (the kernels' plain versions) only with ``--device cpu``.
Weights are random, from a ``torch.Generator`` seeded 0; prompts come from
numpy's generator seeded 1.  ``--plan`` / ``--dump-plan`` read and write the activation plan
JSON, the same format as the JAX package's.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
import warnings

import numpy as np
import torch

from repro_torch import sfu
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import Model


def resolve_device(name: str) -> torch.device:
    """The device to run on; ``cuda`` without a GPU is an error, never a
    silent move to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda (the default) needs a CUDA GPU, and none is available; "
            "pass --device cpu to run the plain PyTorch versions on the CPU")
    return torch.device(name)


def refuse_encoder_decoder(cfg) -> None:
    """The launchers drive decoder-only models (the JAX package's cannot run
    an encoder-decoder either: its batches carry no frames); say so plainly."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model, which the launchers do not drive: "
            "serve it through Model.prefill(params, tokens, cache, frames=) and "
            "Model.decode_step, train it through Model.loss on a batch that carries "
            "'frames'")


def generate(model: Model, params, prompts: torch.Tensor, max_new: int = 32) -> torch.Tensor:
    """Greedy-decode ``max_new`` tokens for a batch of prompts over a dense
    per-request cache: prefill once, then one ``decode_step`` per token."""
    B, S = prompts.shape
    cache = model.make_cache(B, max_len=S + max_new)
    logits = model.prefill(params, prompts, cache)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    out = []
    for i in range(max_new):
        out.append(tok)
        logits = model.decode_step(params, tok, cache, S + i)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    return torch.cat(out, dim=1)


def _start_session(device: torch.device) -> None:
    """Wait for the init's work, and start the peak-memory count afresh."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _session_peak(device: torch.device):
    """The peak of allocated device memory since :func:`_start_session`."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="number of requests to serve")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mode", choices=("paged", "dense"), default="paged",
                    help="paged: continuous batching over the paged KV cache; "
                    "dense: static-batch dense-cache reference loop")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="[paged] concurrent batch slots (fixed decode shape)")
    ap.add_argument("--page-size", type=int, default=16, help="[paged] tokens per KV page")
    ap.add_argument("--policy", choices=("reserved", "optimistic"), default="reserved",
                    help="[paged] admission policy: reserved = worst-case page "
                    "reservation; optimistic = admit on free pages, recover by "
                    "recompute preemption")
    ap.add_argument("--guard", action="store_true",
                    help="[paged] enable sfu.guard clamp/finite counters and "
                    "non-finite degradation re-runs")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="[paged] per-request decode-step budget")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="[paged] run the seeded fault-injection session "
                    "(allocator exhaustion + NaN + one deadline expiry) "
                    "against a fault-free reference; rc!=0 on any parity or "
                    "health-summary failure")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="load an ActivationPlan JSON; default: the fused PWL plan "
                    "compiled from the arch config")
    ap.add_argument("--dump-plan", default=None, metavar="PATH",
                    help="write the activation plan this run uses as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default cuda; cpu runs the plain "
                    "versions of the kernels)")
    return ap


def _setup(args: argparse.Namespace):
    """``(cfg, model, params, prompts, device)`` as ``args`` describe them."""
    device = resolve_device(args.device)
    getter = get_reduced_config if args.reduced else get_config
    if args.plan:
        loaded = sfu.load_plan(args.plan)
        cfg = getter(args.arch, act_plan=loaded)
        missing = sfu.plan_missing_sites(cfg, loaded)
        if missing:
            raise ValueError(f"--plan {args.plan} lacks specs for activation sites "
                             f"{missing} that arch {args.arch!r} instantiates")
    else:
        cfg = getter(args.arch, act_impl="fused")
    refuse_encoder_decoder(cfg)
    plan = sfu.plan_for(cfg)
    print(f"[serve] activation plan {plan.fingerprint}: "
          f"{ {k: s.impl for k, s in plan.items()} }")
    if args.dump_plan:
        print(f"[serve] plan -> {sfu.dump_plan(plan, args.dump_plan)}")
    model = Model(cfg, device=device)
    params = model.init(seed=0)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len), dtype=np.int64
    ).astype(np.int32)
    print(f"[serve] {cfg.name} on {device}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {args.batch} requests x prompt {args.prompt_len} + "
          f"{args.max_new} new ({args.mode} mode)")
    return cfg, model, params, prompts, device


def _make_engine(model, params, args, *, policy=None, guard=None, faults=None):
    from repro_torch.serving import PagedServingEngine

    return PagedServingEngine(
        model, params, max_slots=args.max_slots, page_size=args.page_size,
        max_context=args.prompt_len + args.max_new + args.page_size,
        policy=policy if policy is not None else args.policy,
        guard=args.guard if guard is None else guard, faults=faults)


def _print_health(health: dict) -> None:
    print(f"[serve] health: policy={health['policy']} guard={health['guard']} "
          f"preemptions={health['preemptions']} "
          f"replayed_prefill_tokens={health['replayed_prefill_tokens']} "
          f"timeouts={health['timeouts']} retries={health['step_retries']} "
          f"dropped_ticks={health['dropped_ticks']} "
          f"nonfinite_logits={health['nonfinite_logits']}")
    if health["clamped"]:
        print(f"[serve] health: clamped-per-site {health['clamped']}")
    if health["nonfinite_recoveries"]:
        print(f"[serve] health: nonfinite recoveries {health['nonfinite_recoveries']}")
    for rec in health["rejected"]:
        print(f"[serve] rejected {rec['request_id']}: {rec['reason']}", file=sys.stderr)
    for inc in health["incidents"]:
        print(f"[serve] incident: {inc}")


def run(args: argparse.Namespace, session=contextlib.nullcontext) -> dict:
    """One serving session as ``args`` describe it.  Returns a summary:
    ``results`` (paged: GenResults; dense: token rows), ``tokens``,
    ``seconds``, ``tok_per_s``, ``peak_bytes`` (the session's peak of
    allocated device memory, weights included; None on the CPU), ``mode``
    (the mode that ran: ``dense`` after a fallback from paged), plus
    ``engine`` and ``prefills`` / ``decode_steps`` for the paged mode.
    ``session()`` is a context entered around the session alone, after the
    model's init (a profiler, say)."""
    cfg, model, params, prompts, device = _setup(args)
    if args.mode == "dense":
        return _serve_dense(model, params, prompts, args, device, session)

    from repro_torch.serving import GenRequest, UnsupportedCacheError

    try:
        engine = _make_engine(model, params, args)
    except UnsupportedCacheError as e:
        print(f"[serve] paged cache unsupported ({e}); running dense mode", file=sys.stderr)
        return _serve_dense(model, params, prompts, args, device, session)
    requests = [GenRequest(request_id=f"req{i}", prompt=prompts[i].tolist(),
                           max_new_tokens=args.max_new, deadline_ticks=args.deadline_ticks)
                for i in range(len(prompts))]
    with session():
        _start_session(device)
        t0 = time.perf_counter()
        results = engine.run(requests, on_result=lambda r: print(
            f"[serve]   {r.request_id}: {len(r.tokens)} tokens ({r.finish_reason}), "
            f"steps {r.admitted_at_step}-{r.finished_at_step}"))
        dt = time.perf_counter() - t0
    peak = _session_peak(device)
    health = engine.health_summary()
    by_id = {r.request_id: r for r in results}
    if "req0" in by_id:
        print("[serve] sample:", by_id["req0"].tokens[:12])
    print(f"[serve] {len(results)} requests, {engine.generated} tokens in {dt:.3f}s "
          f"({engine.generated / dt:.1f} tok/s, {engine.prefills} prefills, "
          f"{engine.decode_steps} batched decode steps, "
          f"{engine.sched.allocator.num_free} pages free at exit"
          + (f", peak device memory {peak / 1e9:.2f} GB)" if peak is not None else ")"))
    _print_health(health)
    return {"results": results, "tokens": engine.generated, "seconds": dt,
            "tok_per_s": engine.generated / dt, "engine": engine,
            "prefills": engine.prefills, "decode_steps": engine.decode_steps,
            "peak_bytes": peak, "mode": "paged"}


def _serve_dense(model: Model, params, prompts: np.ndarray, args, device, session) -> dict:
    """The dense reference loop over ``prompts`` (:func:`generate`)."""
    with session():
        _start_session(device)
        t0 = time.perf_counter()
        toks = generate(model, params, torch.from_numpy(prompts).to(device), args.max_new)
        rows = toks.cpu().tolist()
        dt = time.perf_counter() - t0
    peak = _session_peak(device)
    n = len(rows) * args.max_new
    print(f"[serve] mode: dense; generated {n} tokens in {dt:.3f}s ({n / dt:.1f} tok/s"
          + (f", peak device memory {peak / 1e9:.2f} GB)" if peak is not None else ")"))
    print("[serve] sample:", rows[0][:12])
    return {"results": rows, "tokens": n, "seconds": dt, "tok_per_s": n / dt,
            "peak_bytes": peak, "mode": "dense"}


def _serve_chaos(args: argparse.Namespace) -> int:
    """The seeded chaos session: allocator exhaustion and one NaN at the MLP
    plan site injected, one request's deadline expired; 0 only if nothing
    crashed, every other request is token-identical to a fault-free
    reference session, the health summary records the injected incidents,
    and no fused site fell back."""
    from repro_torch.serving import FaultInjector, GenRequest, chaos_specs

    cfg, model, params, prompts, _ = _setup(args)
    nan_site = sfu.site_key(sfu.SITE_MLP, cfg.activation)
    victim = f"req{len(prompts) - 1}"

    def make_requests(with_deadline: bool):
        return [GenRequest(request_id=f"req{i}", prompt=prompts[i].tolist(),
                           max_new_tokens=args.max_new,
                           deadline_ticks=2 if (with_deadline and f"req{i}" == victim) else None)
                for i in range(len(prompts))]

    # fault-free reference (same policy, guard and pages: only the faults and
    # the victim's deadline differ)
    ref_engine = _make_engine(model, params, args, policy="optimistic", guard=True)
    ref = {r.request_id: list(r.tokens) for r in ref_engine.run(make_requests(False))}

    injector = FaultInjector(chaos_specs(args.chaos, nan_site, max_step=max(2, args.max_new - 1)))
    engine = _make_engine(model, params, args, policy="optimistic", guard=True, faults=injector)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        results = engine.run(make_requests(True))
    health = engine.health_summary()
    _print_health(health)

    failures = []
    fallbacks = [str(w.message) for w in caught if "fused" in str(w.message).lower()]
    if fallbacks:
        failures.append(f"fused fallbacks during chaos session: {fallbacks}")
    by_id = {r.request_id: r for r in results}
    if set(by_id) != {f"req{i}" for i in range(len(prompts))}:
        failures.append(f"missing results: got {sorted(by_id)}")
    else:
        if by_id[victim].finish_reason != "timeout":
            failures.append(f"deadline victim {victim} finished "
                            f"{by_id[victim].finish_reason!r}, expected 'timeout'")
        for rid, res in sorted(by_id.items()):
            if rid != victim and list(res.tokens) != ref[rid]:
                failures.append(f"{rid} diverged from the fault-free run: "
                                f"{res.tokens} != {ref[rid]}")
    fired_kinds = {f["kind"] for f in health["faults_fired"]}
    if fired_kinds != {"alloc_exhaust", "nan"}:
        failures.append(f"injected faults did not all fire: {fired_kinds}")
    if health["preemptions"] < 1:
        failures.append("injected allocator exhaustion caused no preemption")
    if not health["nonfinite_recoveries"]:
        failures.append("NaN injection was not recovered by the guard")
    if health["timeouts"] < 1:
        failures.append("deadline expiry produced no timeout")
    incident_kinds = {i["kind"] for i in health["incidents"]}
    for want in ("preemption", "nan_injected", "nonfinite_output", "deadline_expired"):
        if want not in incident_kinds:
            failures.append(f"health summary missing incident kind {want!r}")

    print(f"[serve] chaos seed {args.chaos}: {len(results)} results, faults fired: "
          f"{sorted(fired_kinds)}")
    if failures:
        for msg in failures:
            print(f"[serve] CHAOS FAILURE: {msg}", file=sys.stderr)
        return 1
    print("[serve] chaos session OK: non-faulted requests token-identical, incidents recorded")
    return 0


def serve(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.chaos is not None:
        if args.mode != "paged":
            ap.error("--chaos requires --mode paged")
        return _serve_chaos(args)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        summary = run(args)
    for w in caught:  # passed on as they came
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return session_rc(summary, caught)


def session_rc(summary: dict, caught) -> int:
    """The exit code of a finished session: 1 when a paged session sampled
    non-finite logits or a fused site fell back (a fused-fallback warning
    among ``caught``), else 0."""
    if summary["mode"] != "paged":
        return 0
    health = summary["engine"].health_summary()
    rc = 0
    if health["nonfinite_logits"]:
        print(f"[serve] {health['nonfinite_logits']} steps sampled non-finite logits",
              file=sys.stderr)
        rc = 1
    fallbacks = [str(w.message) for w in caught if "fused" in str(w.message).lower()]
    print(f"[serve] fused fallbacks during session: {len(fallbacks)}")
    if fallbacks:
        # a fused plan that fell back mid-session is a regression to catch,
        # not a warning to scroll past
        for msg in fallbacks:
            print(f"[serve]   fallback: {msg}", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(serve())
