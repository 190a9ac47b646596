#!/usr/bin/env python3
"""Smoke test of the torch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and times kernel, plain version and a
   PyTorch yardstick call the port never makes;
3. serves full-width repro-100m through ``repro_torch.launch.serve`` on
   ``cuda`` (the defaults, then a larger session) and checks from the launch
   counters that every GLU, prompt write and append went through the kernels;
4. checks the port against its plain path on a small f32 input (logits, and
   paged against dense greedy tokens).

Every failed check exits non-zero.  The last two lines of standard output
are the kernels' JSON line and ``{"ok": true, "device": {...}}``; the card's
name and power limit are printed before them.  Needs a CUDA GPU and the
repository around this file; imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOP_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
K_DIM, N_DIM = 768, 3072       # repro-100m d_model, d_ff
HKV, DH, PS = 12, 64, 16       # repro-100m KV heads, head dim; serve page size


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn(i)`` call: ``reps`` calls captured into a
    CUDA graph, replayed ``iters`` times between CUDA events, so host launch
    overhead is not in the number.  ``i`` cycles so a caller can rotate its
    operands past the L2 cache."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def build_phase():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    info = _build.build()
    secs = time.perf_counter() - t0
    print(f"[smoke] built {sorted(info)} in {secs:.2f}s (wall, parallel nvcc)")
    for name, rec in sorted(info.items()):
        print(f"[smoke]   {name}: {rec['seconds']:.2f}s cached={rec['cached']}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[smoke]     ptxas {line.strip()}")
    return secs


# ---------------------------------------------------------------------------
# kernel vs plain


def glu_phase(torch):
    """The fused_glu wrapper on CUDA tensors (its kernel) vs its plain
    version at K=768, N=3072, M in {4, 32, 512}, bf16 (1e-2) and f32 with
    TF32 off (1e-4)."""
    from repro_torch import sfu
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.kernels.fused.glu import fused_glu_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    plan, tables = plan_and_operands(table)
    tables = tuple(t.to(dev) for t in tables)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    # a ragged shape first: masking of every edge (M, N and K not multiples)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(37, 65, generator=gen, device=dev).to(dtype)
        wg = (torch.randn(65, 130, generator=gen, device=dev) * 0.2).to(dtype)
        wu = (torch.randn(65, 130, generator=gen, device=dev) * 0.2).to(dtype)
        got = fused_glu(x, wg, wu, table=table)
        want = fused_glu_plain(x, wg, wu, plan, tables)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"fused_glu ragged 37x65x130 {dtype}: max err {err}")
        print(f"[smoke] fused_glu ragged M=37 K=65 N=130 {dtype}: max_abs_err {err:.3g}")

    n_copies = 8  # 8 x 9.4 MB of bf16 weights: more than the 50 MB L2
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        scale = 1.0 / math.sqrt(K_DIM)
        wgs = [(torch.randn(K_DIM, N_DIM, generator=gen, device=dev) * scale).to(dtype)
               for _ in range(n_copies)]
        wus = [(torch.randn(K_DIM, N_DIM, generator=gen, device=dev) * scale).to(dtype)
               for _ in range(n_copies)]
        wcat = [torch.cat([a, b], dim=1) for a, b in zip(wgs, wus)]
        for M in (4, 32, 512):
            x = torch.randn(M, K_DIM, generator=gen, device=dev).to(dtype)
            n0 = fused_glu.launches
            got = fused_glu(x, wgs[0], wus[0], table=table)
            check(fused_glu.launches == n0 + 1, f"fused_glu M={M} {dtype}: kernel not launched")
            want = fused_glu_plain(x, wgs[0], wus[0], plan, tables)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"fused_glu M={M} {dtype}: non-finite")
            check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                  f"fused_glu M={M} {dtype}: max err {err} > {tol}")
            k_ms = time_ms(torch, lambda i: fused_glu(x, wgs[i % n_copies], wus[i % n_copies],
                                                      table=table))
            p_ms = time_ms(torch, lambda i: fused_glu_plain(
                x, wgs[i % n_copies], wus[i % n_copies], plan, tables))
            l_ms = time_ms(torch, lambda i: torch.matmul(x, wcat[i % n_copies]))
            esize = x.element_size()
            nbytes = (M * K_DIM + 2 * K_DIM * N_DIM + M * N_DIM) * esize
            flops = 2 * 2 * M * K_DIM * N_DIM
            peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_PER_S
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
            rows[(M, dtype)] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            print(f"[smoke] fused_glu M={M} K={K_DIM} N={N_DIM} {dtype}: "
                  f"max_abs_err {err:.3g} (tol {tol}), kernel {k_ms * 1e3:.2f} us, "
                  f"plain {p_ms * 1e3:.2f} us, torch.matmul(x, [Wg|Wu]) "
                  f"{l_ms * 1e3:.2f} us, bound {rows[(M, dtype)]['bound_ms'] * 1e3:.2f} us "
                  f"({rows[(M, dtype)]['bound_by']})")
    return rows


def _fragmented_table(n_rows, n_cols, num_pages):
    from repro_torch.serving import PageAllocator

    alloc = PageAllocator(num_pages)
    rows = [[] for _ in range(n_rows)]
    for _ in range(n_cols):
        for r in rows:
            r.extend(alloc.alloc(1))
    for r in rows[::2]:
        alloc.free(r[::-1])
        r.clear()
    for _ in range(n_cols):
        for r in rows[::2]:
            r.extend(alloc.alloc(1))
    return rows


def kv_phase(torch):
    """Both page-write kernels vs their plain versions, bitwise outside the
    sentinel page, at the serve shapes (bf16 pools of one layer)."""
    from repro_torch.serving import kv_cache as KV

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    esize = 2
    out = {}

    # prefill: B=1, a 32-token bucket, pool sized as serve sizes it (4 slots x
    # 4 columns + sentinel = 17 pages), the table fragmented by LIFO reuse
    P = 17
    rows = _fragmented_table(3, 2, P)
    table = torch.tensor([rows[0]], dtype=torch.int32, device=dev)
    S = 32
    kn = torch.randn(1, S, HKV, DH, generator=gen, device=dev).to(dt)
    vn = torch.randn(1, S, HKV, DH, generator=gen, device=dev).to(dt)
    base_k = torch.randn(HKV, P, PS, DH, generator=gen, device=dev).to(dt)
    base_v = torch.randn(HKV, P, PS, DH, generator=gen, device=dev).to(dt)
    ka, va, kb, vb = base_k.clone(), base_v.clone(), base_k.clone(), base_v.clone()
    KV.write_prompt_pages_(ka, va, kn, vn, table)
    KV.write_prompt_pages_plain(kb, vb, kn, vn, table)
    torch.cuda.synchronize()
    check(torch.equal(ka[:, 1:], kb[:, 1:]) and torch.equal(va[:, 1:], vb[:, 1:]),
          "write_prompt_pages_ kernel differs from its plain version")
    check(not torch.equal(ka, base_k), "write_prompt_pages_ wrote nothing")
    flat = (table[0].long()[:, None] * PS + torch.arange(PS, device=dev)).reshape(-1)
    kn_h = kn[0].permute(1, 0, 2).contiguous()  # (Hkv, S, dh)
    k_ms = time_ms(torch, lambda i: KV.write_prompt_pages_(ka, va, kn, vn, table))
    p_ms = time_ms(torch, lambda i: KV.write_prompt_pages_plain(kb, vb, kn, vn, table))
    l_ms = time_ms(torch, lambda i: (ka.view(HKV, P * PS, DH).index_copy_(1, flat, kn_h),
                                     va.view(HKV, P * PS, DH).index_copy_(1, flat, kn_h)))
    nbytes = 2 * 2 * S * HKV * DH * esize + table.numel() * 4
    out["write_prompt_pages_"] = {
        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": 0.0,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"[smoke] write_prompt_pages_ B=1 S={S} Hkv={HKV} dh={DH} bf16: bitwise ok, "
          f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, index_copy_ "
          f"{l_ms * 1e3:.2f} us, bound {out['write_prompt_pages_']['bound_ms'] * 1e3:.3f} us")

    # decode: 4 slots, one inactive (all-sentinel row, kv_len 0), one append
    # at a page boundary, table width 4 columns
    rows = _fragmented_table(3, 3, P)
    tab = torch.zeros((4, 4), dtype=torch.int32)
    for b, r in enumerate(rows):
        tab[b, :len(r)] = torch.tensor(r)
    tab = tab.to(dev)
    kv_len = torch.tensor([PS + 3, 2 * PS, PS - 1, 0], dtype=torch.int32, device=dev)
    kn = torch.randn(4, 1, HKV, DH, generator=gen, device=dev).to(dt)
    vn = torch.randn(4, 1, HKV, DH, generator=gen, device=dev).to(dt)
    ka, va, kb, vb = base_k.clone(), base_v.clone(), base_k.clone(), base_v.clone()
    KV.append_kv_(ka, va, kn, vn, tab, kv_len)
    KV.append_kv_plain(kb, vb, kn, vn, tab, kv_len)
    torch.cuda.synchronize()
    check(torch.equal(ka[:, 1:], kb[:, 1:]) and torch.equal(va[:, 1:], vb[:, 1:]),
          "append_kv_ kernel differs from its plain version")
    changed = (ka != base_k).any(dim=3).any(dim=0)[1:]
    check(int(changed.sum()) == 3, f"append_kv_ changed {int(changed.sum())} rows, want 3")
    lens = kv_len.long()
    pidx = torch.gather(tab.long(), 1, (lens // PS)[:, None])[:, 0]
    flat = pidx * PS + lens % PS
    kn_h = kn[:, 0].permute(1, 0, 2).contiguous()  # (Hkv, B, dh)
    k_ms = time_ms(torch, lambda i: KV.append_kv_(ka, va, kn, vn, tab, kv_len))
    p_ms = time_ms(torch, lambda i: KV.append_kv_plain(kb, vb, kn, vn, tab, kv_len))
    l_ms = time_ms(torch, lambda i: (ka.view(HKV, P * PS, DH).index_copy_(1, flat, kn_h),
                                     va.view(HKV, P * PS, DH).index_copy_(1, flat, kn_h)))
    nbytes = 2 * 2 * 4 * HKV * DH * esize + 4 * 4 + 4 * 4
    out["append_kv_"] = {
        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": 0.0,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"[smoke] append_kv_ B=4 Hkv={HKV} dh={DH} bf16: bitwise ok, kernel "
          f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, index_copy_ "
          f"{l_ms * 1e3:.2f} us, bound {out['append_kv_']['bound_ms'] * 1e3:.4f} us")
    return out


# ---------------------------------------------------------------------------
# main path


def reset_counters():
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.serving.kv_cache import append_kv_, write_prompt_pages_

    for fn in (fused_glu, write_prompt_pages_, append_kv_):
        fn.launches = 0


def read_counters() -> dict:
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.serving.kv_cache import append_kv_, write_prompt_pages_

    return {"fused_glu": fused_glu.launches,
            "write_prompt_pages_": write_prompt_pages_.launches,
            "append_kv_": append_kv_.launches}


def serve_phase(torch, argv: list[str]) -> dict:
    """One full-width session through the serve entry point; returns the
    launch counts of exactly that session."""
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    check(args.device == "cuda", "serve must default to cuda")
    reset_counters()
    summary = serve.run(args)
    torch.cuda.synchronize()
    counts = read_counters()
    eng = summary["engine"]
    n_layers = eng.model.cfg.n_layers
    check(eng.model.cfg.d_model == 768 and n_layers == 12, "not full-width repro-100m")
    check(len(summary["results"]) == args.batch, "a request is missing")
    for r in summary["results"]:
        check(len(r.tokens) == args.max_new and r.finish_reason == "length",
              f"{r.request_id}: {len(r.tokens)} tokens ({r.finish_reason})")
    check(eng.health_summary()["nonfinite_logits"] == 0, "non-finite logits")
    pf, ds = summary["prefills"], summary["decode_steps"]
    check(counts["fused_glu"] == n_layers * (pf + ds),
          f"fused_glu launches {counts['fused_glu']} != {n_layers} x ({pf} + {ds})")
    check(counts["write_prompt_pages_"] == n_layers * pf,
          f"write_prompt_pages_ launches {counts['write_prompt_pages_']} != {n_layers} x {pf}")
    check(counts["append_kv_"] == n_layers * ds,
          f"append_kv_ launches {counts['append_kv_']} != {n_layers} x {ds}")
    print(f"[smoke] serve {' '.join(argv) or '(defaults)'}: {summary['tokens']} tokens, "
          f"{summary['tok_per_s']:.1f} tok/s, {pf} prefills, {ds} decode steps, "
          f"launches {counts}")
    return counts


def reference_phase(torch):
    """The port on the card against its plain path on the CPU, reduced
    repro-100m in f32 (TF32 off): logits at 1e-4, and paged greedy tokens
    equal to the dense loop's on the card."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.serving import GenRequest, PagedServingEngine

    cfg = get_reduced_config("repro-100m", act_impl="fused", dtype=torch.float32)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(seed=0)

    def to_dev(t):
        if torch.is_tensor(t):
            return t.cuda()
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        return [to_dev(v) for v in t]

    gparams = to_dev(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(2))
    want = cpu.forward(params, toks)
    got = gpu.forward(gparams, toks.cuda()).cpu()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4), f"reduced logits err {err}")
    reqs = [GenRequest(f"r{i}", toks[i, : 9 + 13 * i].tolist(), 6) for i in range(2)]
    eng = PagedServingEngine(gpu, gparams, max_slots=2, page_size=16, max_context=64)
    paged = {r.request_id: r.tokens for r in eng.run(reqs)}
    dense = {r.request_id: generate(gpu, gparams, torch.tensor([r.prompt], device="cuda"),
                                    r.max_new_tokens)[0].tolist() for r in reqs}
    check(paged == dense, f"paged {paged} != dense {dense}")
    print(f"[smoke] reduced f32: cuda vs cpu logits max_abs_err {err:.3g}; paged == dense "
          "greedy tokens on cuda")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(f"[smoke] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    try:
        build_s = build_phase()
        glu = glu_phase(torch)
        kv = kv_phase(torch)
        main_counts = serve_phase(torch, [])
        serve_phase(torch, ["--batch", "8", "--prompt-len", "256", "--max-new", "32"])
        reference_phase(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for name, n in main_counts.items():
        if n == 0:
            print(f"chip_smoke: FAILED: {name} never launched on the main path",
                  file=sys.stderr)
            return 1

    g = glu[(4, torch.bfloat16)]
    kernels = [
        {"name": "fused_glu", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/glu.py:30",
         "shape": f"M=4 K={K_DIM} N={N_DIM} bf16 (decode step)",
         "launches": main_counts["fused_glu"], **g},
        {"name": "write_prompt_pages_", "route": "cuda",
         "source": "src/repro_torch/csrc/kv_cache.cu",
         "replaces": "src/repro/serving/kv_cache.py:129",
         "shape": f"B=1 S=32 Hkv={HKV} dh={DH} bf16",
         "launches": main_counts["write_prompt_pages_"], **kv["write_prompt_pages_"]},
        {"name": "append_kv_", "route": "cuda", "source": "src/repro_torch/csrc/kv_cache.cu",
         "replaces": "src/repro/serving/kv_cache.py:212",
         "shape": f"B=4 Hkv={HKV} dh={DH} bf16",
         "launches": main_counts["append_kv_"], **kv["append_kv_"]},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(f"[smoke] total {time.perf_counter() - t_start:.1f}s (build {build_s:.1f}s)")
    print(card_line())
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
