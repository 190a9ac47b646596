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
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="[paged] per-request decode-step budget")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="load an ActivationPlan JSON; default: the fused PWL plan "
                    "compiled from the arch config")
    ap.add_argument("--dump-plan", default=None, metavar="PATH",
                    help="write the activation plan this run uses as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default cuda; cpu runs the plain "
                    "versions of the kernels)")
    return ap


def run(args: argparse.Namespace, session=contextlib.nullcontext) -> dict:
    """One serving session as ``args`` describe it.  Returns a summary:
    ``results`` (paged: GenResults; dense: token rows), ``tokens``,
    ``seconds``, ``tok_per_s``, ``peak_bytes`` (the session's peak of
    allocated device memory, weights included; None on the CPU), ``mode``
    (the mode that ran: ``dense`` after a fallback from paged), plus
    ``engine`` and ``prefills`` / ``decode_steps`` for the paged mode.
    ``session()`` is a context entered around the session alone, after the
    model's init (a profiler, say)."""
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

    if args.mode == "dense":
        return _serve_dense(model, params, prompts, args, device, session)

    from repro_torch.serving import GenRequest, PagedServingEngine, UnsupportedCacheError

    try:
        engine = PagedServingEngine(
            model, params, max_slots=args.max_slots, page_size=args.page_size,
            max_context=args.prompt_len + args.max_new + args.page_size, policy=args.policy)
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
    print(f"[serve] health: policy={health['policy']} preemptions={health['preemptions']} "
          f"timeouts={health['timeouts']} retries={health['step_retries']} "
          f"nonfinite_logits={health['nonfinite_logits']}")
    for rec in health["rejected"]:
        print(f"[serve] rejected {rec['request_id']}: {rec['reason']}", file=sys.stderr)
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


def serve(argv=None) -> int:
    args = build_parser().parse_args(argv)
    summary = run(args)
    if summary["mode"] == "paged":
        health = summary["engine"].health_summary()
        if health["nonfinite_logits"]:
            print(f"[serve] {health['nonfinite_logits']} steps sampled non-finite "
                  "logits", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(serve())
