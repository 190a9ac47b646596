"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything
about it is found by name: ``configs`` gives the configuration's file (with
its plan beside it), ``portbench/traffic/<traffic>.json`` the mix, whose
``kind`` names the driver ``portbench/drivers/<kind>.py``,
``portbench/limits/<workload>.json`` the limits of the comparison, and
``portbench/metrics/<metric>.py`` the reader of each metric; the
configuration's ``family`` names its plain reference,
``portbench/reference/<family>.py``.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window.  The last line of standard output is the result, one JSON
object; the numbers compared with the reference are the last lines of
standard error and the result's last key.

The program is the PyTorch port under ``src/repro_torch``.  A run needs as
many CUDA devices as the cell asks for, and never falls back to the CPU;
it refuses to report if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
# modules are imported as portbench.<name>, never from the script's folder
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    tables: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    root: pathlib.Path
    t_start: float
    chips: int = 1


def load_cell(bench: dict, root: pathlib.Path, workload: str, seed: int, seconds: float,
              trace: bool, device, t_start: float) -> Cell:
    from portbench.reference.pwl import load_table

    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root.parent / entry["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((root / "limits" / f"{workload}.json").read_text())
    tables = {fn: load_table(root / path) for fn, path in config["tables"].items()}
    return Cell(name=workload, config=config, traffic=traffic, limits=limits, tables=tables,
                seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device,
                root=root, t_start=t_start, chips=int(wl["chips"]))


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with the trace its per-layer metrics (those listing it, or with no
    list those that move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(root: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: Cell, bench: dict, control: dict | None = None) -> dict:
    """Drive the cell, read its metrics, and judge its outputs; with
    ``control``, the driver's check also records the control's readings
    there."""
    import torch

    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    obs = driver.run(cell, control=control)
    ctx = dict(obs, cell=cell)
    metrics = {}
    for m in cell_metrics(bench, cell.name, cell.trace):
        value = reader(cell.root, m["name"])(ctx)
        if value is None:
            if not cell.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = cell.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(obs["peak_bytes"])}
    checks = obs["checks"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(obs["attempted"]),
              "failed": int(obs["failed"]), "metrics": metrics, "device": device}
    tr = obs.get("trace")
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if forbidden_modules():
        print(f"portbench: {forbidden_modules()} loaded at start", file=sys.stderr)
        return 4
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    bench_path = REPO / "BENCHMARK.json"
    if not bench_path.exists():
        print(f"portbench: no {bench_path}", file=sys.stderr)
        return 2
    bench = json.loads(bench_path.read_text())
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    import torch

    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(bench, ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    result = run_cell(cell, bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
