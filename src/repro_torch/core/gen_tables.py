"""Generate fitted PWL table artifacts for the TableStore.

Usage:  PYTHONPATH=src python -m repro_torch.core.gen_tables [--fast]
            [--functions ...] [--breakpoints ...] [--device cuda|cpu] [--root DIR]

Fits ``<fn>_<n>bp.npz`` for the activation functions the model zoo uses, at
the paper's evaluated breakpoint counts, on ``--device`` (``cuda`` by
default), and writes them through ``repro_torch.sfu.TableStore.put`` into
``--root``, so each one embeds a JSON provenance record (fit config, error
metrics, library version, creation time) beside its coefficient arrays.
The default root is the port's shipped artifact directory, whose files are
byte-identical copies of the JAX package's: writing there replaces them.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch.sfu import DEFAULT_FIT, TABLE_DIR, TableStore

from . import fit

FUNCTIONS = ["gelu", "gelu_tanh", "silu", "sigmoid", "tanh", "exp", "softplus", "hardswish"]
BREAKPOINTS = [8, 16, 32, 64]


def fit_config(fast: bool) -> fit.FitConfig:
    """``--fast`` (CI) or the full configuration."""
    if fast:
        return fit.FitConfig(max_steps=1000, max_rounds=2, init="curvature")
    return fit.FitConfig(max_steps=4000, max_rounds=6, init="curvature")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="fewer steps/rounds (CI)")
    ap.add_argument("--functions", nargs="*", default=FUNCTIONS)
    ap.add_argument("--breakpoints", nargs="*", type=int, default=BREAKPOINTS)
    ap.add_argument("--device", default="cuda", help="where the fits run (cuda or cpu)")
    ap.add_argument("--root", default=str(TABLE_DIR),
                    help="artifact directory (default: the shipped artifacts)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    store = TableStore(root=args.root)
    cfg = fit_config(args.fast)
    for name in args.functions:
        for n in args.breakpoints:
            t0 = time.time()
            r = fit.fit(name, n, cfg=cfg, device=args.device)
            out = store.put(
                r.table,
                fit=DEFAULT_FIT,
                mse=r.mse,
                mae=r.mae,
                extra={
                    "range": list(r.range),
                    "fit_config": dataclasses.asdict(cfg),
                    "generator": "repro_torch.core.gen_tables",
                },
            )
            print(
                f"{name:10s} {n:3d}bp  mse={r.mse:.3e} mae={r.mae:.3e} "
                f"({time.time()-t0:.1f}s) -> {out.name}",
                flush=True,
            )


if __name__ == "__main__":
    sys.exit(main())
