"""Readings that set a cell's limits: the program's, the control's and the
planted faults', on the chip at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 --seconds 10

For each seed it runs the cell as ``run.py`` does (a short window), with
a ``control`` record that the cell's driver fills in its check, and
prints one JSON line: the numbers the program gives against the plain
reference, and the same numbers for

* the control: the reference computed in float8 (``precision="fp8"``)
  put in the program's place; for a served model, at each served position
  the token the float8 reference puts first, its gap below the float32
  reference's best;
* for a training cell, the fault "half of the batch left out, the mean
  taken over the rest" (the reference on the first half of every batch in
  the program's place).  "A step that returns its state unchanged" reads
  1 on ``change_gap`` by its definition and needs no run.

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT]
sys.path[:0] = [str(ROOT.parent / "src"), str(ROOT.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    from portbench import run

    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        cell = run.load_cell(bench, ROOT, args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), t)
        out = {"workload": args.workload, "seed": seed}
        res = run.run_cell(cell, bench, control=out)
        out.update(correct=res["correct"], metrics=res["metrics"],
                   seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
