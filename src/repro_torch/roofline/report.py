"""Render EXPERIMENTS.md roofline/dry-run tables from experiments/dryrun/*.json.

The port's own copy of ``repro/roofline/report.py``: the same three tables
from the same row keys (``launch/dryrun.py`` writes them).  A port row's
``compile s`` is 0 (nothing compiles) and its XLA-CPU bound 0.0 (the meta
device has no memory analysis); ``peak_analytic_gb`` carries the peak.

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun]
"""
from __future__ import annotations

import argparse
import json
import pathlib


def load(dirpath):
    rows = []
    for p in sorted(pathlib.Path(dirpath).glob("*.json")):
        rows.append(json.loads(p.read_text()))
    return rows


def fmt_ms(v):
    return f"{v:,.1f}"


def dryrun_table(rows, mesh: str) -> str:
    out = [
        "| arch | shape | status | compile s | peak (analytic / XLA-CPU UB) GiB | collectives (AG/AR/RS/A2A/CP) GiB |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r.get("status") != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['status'][:60]} | — | — | — |"
            )
            continue
        c = r["collectives"]
        gib = lambda k: c.get(k, 0) / 2**30
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['t_compile_s']} | "
            f"{r.get('peak_analytic_gb', 0):.1f} / {r['peak_mem_gb']:.1f} | "
            f"{gib('all-gather'):.1f}/{gib('all-reduce'):.1f}/{gib('reduce-scatter'):.1f}/"
            f"{gib('all-to-all'):.1f}/{gib('collective-permute'):.1f} |"
        )
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = [
        "| arch | shape | t_comp ms | t_mem ms | t_coll ms | bound | useful | MFU@bound |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != "16x16" or r.get("status") != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(r['t_compute_ms'])} | "
            f"{fmt_ms(r['t_memory_ms'])} | {fmt_ms(r['t_collective_ms'])} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.2f} | {r['mfu_at_bound']:.3f} |"
        )
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    args = ap.parse_args()
    rows = load(args.dir)
    print("### Single-pod (16x16 = 256 chips)\n")
    print(dryrun_table(rows, "16x16"))
    print("\n### Multi-pod (2x16x16 = 512 chips)\n")
    print(dryrun_table(rows, "2x16x16"))
    print("\n### Roofline (single-pod)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
