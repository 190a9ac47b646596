"""Autotune launcher (torch port): search the per-site approximation space
for one arch and emit a ``--plan``-consumable ActivationPlan JSON.

    python -m repro_torch.launch.autotune --arch repro-100m \\
        --out plan.json --report report.json                     # on cuda
    python -m repro_torch.launch.autotune --reduced --quick --device cpu

The emitted ``--out`` file is a plain ActivationPlan (exactly what
``serve --dump-plan`` writes, and the JAX package's format) and feeds
straight into the launchers::

    python -m repro_torch.launch.serve --arch repro-100m --plan plan.json
    python -m repro_torch.launch.train --arch repro-100m --plan plan.json

``--report`` captures everything the plan schema cannot: raw per-candidate
measurements, provenance (backend, device name and power limit,
interpret mode — on the CPU the fused wrappers run their plain versions, so
the latencies order candidates on that machine only), cache hit rates, and
the end-to-end gate.

The device defaults to ``cuda``; without a GPU the launcher raises, and it
measures on the CPU only with ``--device cpu``.

Exit codes: 0 = plan emitted and e2e gate passed; 2 = gate failed even
after the accuracy-first fallback (the plan is still written, for triage).
An arm that fails (a kernel that does not launch) raises.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch import sfu
from repro_torch.launch.serve import resolve_device
from repro_torch.sfu.autotune import DEFAULT_CACHE_DIR, AutotuneConfig, autotune


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="per-site (segments x dtype x impl) plan search")
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="search the reduced (CI-sized) config")
    ap.add_argument("--quick", action="store_true",
                    help="restricted sweep + smaller workloads (CI smoke)")
    ap.add_argument("--out", default="plan.json", metavar="PATH",
                    help="where to write the winning ActivationPlan JSON")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="also write the full search report "
                    "(measurements, provenance)")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                    help="MeasurementCache directory (re-runs are "
                    "incremental; warm cache => deterministic plan)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mse-scale", type=float, default=1.0,
                    help="accuracy budget = baseline site MSE * this")
    ap.add_argument("--min-top1", type=float, default=0.98,
                    help="e2e gate: greedy top-1 agreement vs exact")
    ap.add_argument("--pwl-softmax", action="store_true", default=None,
                    help="force the attn.softmax:exp site into the search "
                    "(default: the arch's own setting)")
    ap.add_argument("--device", default="cuda",
                    help="where to measure: cuda (default; raises without a GPU) or cpu "
                    "(the kernels' plain versions)")
    return ap


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    at = AutotuneConfig(
        arch=args.arch, reduced=args.reduced, quick=args.quick,
        seed=args.seed, mse_scale=args.mse_scale, min_top1=args.min_top1,
        cache_dir=args.cache_dir, pwl_softmax=args.pwl_softmax, device=str(device),
    )
    res = autotune(at)
    rpt = res.report

    card = (f" ({rpt['device']}, {rpt['power_limit']})" if rpt["backend"] == "cuda"
            else "")
    print(f"[autotune] {args.arch} ({'reduced' if args.reduced else 'full'}"
          f"{', quick' if args.quick else ''}) on {rpt['backend']}{card}"
          f"{' [interpret mode]' if rpt['interpret_mode'] else ''}")
    which = "accuracy_first" if rpt["accuracy_fallback"] else "chosen"
    for e in rpt["sites"]:
        c, b = e[which], e["baseline"]
        spec = c["spec"]
        print(f"[autotune]   {e['site']}: {spec['impl']}/"
              f"{spec['n_segments'] - 1}bp/{spec['dtype']}  "
              f"{c['us']:.1f}us (baseline {b['us']:.1f}us)  "
              f"mse {c['mse']:.3e} (budget {e['budget_mse']:.3e})")
    t = rpt["totals"]
    print(f"[autotune] total {t['chosen_us']:.1f}us vs baseline "
          f"{t['baseline_us']:.1f}us ({t['speedup']:.2f}x); e2e top1 "
          f"{rpt['e2e']['top1_agree']:.4f}, kl {rpt['e2e']['mean_kl']:.3e}, max logit "
          f"delta {rpt['e2e']['max_logit_delta']:.3e}"
          f"{' [accuracy fallback]' if rpt['accuracy_fallback'] else ''}")
    print(f"[autotune] cache {rpt['cache']['dir']}: {rpt['cache']['hits']} hits, "
          f"{rpt['cache']['misses']} misses")
    print(f"[autotune] plan {res.plan.fingerprint} -> "
          f"{sfu.dump_plan(res.plan, args.out)}")
    if args.report:
        p = pathlib.Path(args.report)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(rpt, indent=2) + "\n")
        print(f"[autotune] report -> {p}")

    if rpt["e2e"]["top1_agree"] < args.min_top1:
        print(f"[autotune] FAIL: e2e top-1 agreement "
              f"{rpt['e2e']['top1_agree']:.4f} < {args.min_top1} even after "
              "accuracy-first fallback", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(run())
