"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta device.

The port's counterpart of ``repro/launch/dryrun.py``.  For each cell it
proves the sharding config is coherent at production scale (every
placement, redistribution and per-shard body of the sharded step runs at
full width on the 16 x 16 or 2 x 16 x 16 mesh) and extracts the roofline
terms:

  * a fake process group of 512 ranks (``init_process_group("fake")``;
    this process is rank 0), ``launch/mesh.py``'s production mesh over it,
    and every parameter, batch and cache a meta DTensor placed as the
    sharded step places it (``launch/steps.py:build_step``): nothing is
    allocated, nothing is sent and no card is needed, as JAX compiles for
    512 fake host devices;
  * the step traced once by ``roofline/collectives.py:trace``: rank 0's
    FLOPs (``FlopCounterMode``'s formulas on its local shapes, the fused
    kernels' meta ops among them), its collectives by kind and output bytes,
    its transcendentals and its unfused op traffic;
  * rank 0's bytes of a prefill or decode cell's dense cache, its blocks as
    the cell rules place them (``cache_bytes_per_device``, a key JAX's row
    lacks);
  * the analytic terms of ``roofline/model.py`` (model FLOPs, HBM traffic,
    peak memory, active parameters) and ``RooflineReport`` at the H100's
    peaks.

Known differences from the JAX package's dry run:

  * FLOPs come from ``FlopCounterMode``'s formulas over the traced ops, not
    from the compiled HLO's ``cost_analysis``;
  * nothing compiles: ``t_lower_s`` is the trace's seconds, ``t_compile_s``
    is 0;
  * there is no XLA-CPU memory upper bound: ``peak_mem_bytes`` is 0 and
    ``memory_analysis`` says "unavailable: meta device", as JAX's row reads
    on a backend without ``memory_analysis``; ``peak_analytic_gb`` carries
    the analytic peak;
  * depth is counted directly: every layer runs (the port has no scan), so
    the full-depth trace is the count, with no shallow probes to
    extrapolate from (JAX's ``cost_analysis`` counts a scan body once);
    train cells are traced at one microbatch, as JAX's probes are, and
    ``raw_scan_once`` repeats the same counts;
  * the mesh is a CPU ``DeviceMesh``, on which DTensor makes a
    shard-to-shard redistribution an all-gather and a chunk (an all-to-all
    on a ``cuda`` mesh), and the port's prefill gathers its logits whole on
    every rank (one all-gather a step).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-2.7b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod-only|--singlepod-only]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun

Results land in experiments/dryrun/<arch>__<shape>__<mesh>.json;
``python -m repro_torch.roofline.report --dir ...`` renders them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import json
import pathlib
import sys
import time
import traceback

import torch.distributed as dist

from repro_torch import sfu
from repro_torch.configs import REFUSED, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import auto_microbatches, build_step, cache_bytes_per_device
from repro_torch.models import SHAPE_CELLS
from repro_torch.roofline import collectives
from repro_torch.roofline.model import (
    RooflineReport,
    active_params,
    analytic_memory_traffic,
    analytic_peak_memory,
    model_flops_decode,
    model_flops_train,
    total_params,
)

# the JAX package's architectures, its --all sweep; --arch also takes the
# port's repro-100m
ARCH_IDS = [
    "internvl2-1b",
    "qwen2.5-32b",
    "stablelm-1.6b",
    "olmo-1b",
    "gemma3-1b",
    "olmoe-1b-7b",
    "phi3.5-moe-42b-a6.6b",
    "whisper-small",
    "mamba2-2.7b",
    "jamba-v0.1-52b",
]
EXTRA_ARCHS = ["repro-100m"]

# long_500k requires sub-quadratic attention: skip pure full-attention archs
# (DESIGN.md Sec. 5) — recorded as explicit SKIP rows, not silently dropped.
LONG_OK = {"mamba2-2.7b", "jamba-v0.1-52b", "gemma3-1b"}

WORLD = 512  # the fake group's ranks: the 2 x 16 x 16 mesh, the 16 x 16 on its first 256


def cell_is_skipped(arch: str, shape: str) -> bool:
    return shape == "long_500k" and arch not in LONG_OK


def dryrun_config(arch: str, **overrides):
    """The full-width config of ``arch``.  jamba and phi3.5, which
    ``get_config`` refuses (their weights pass one card), come from their
    modules: the meta device allocates nothing."""
    if arch in REFUSED:
        name = arch.replace("-", "_").replace(".", "_")
        cfg = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
        return dataclasses.replace(cfg, **overrides) if overrides else cfg
    return get_config(arch, **overrides)


@contextlib.contextmanager
def fake_process_group(world: int = WORLD):
    """A fake process group of ``world`` ranks, this process rank 0, for the
    block; destroyed at its end.  With a group already up, that one."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _plan_missing_cached(arch: str, plan) -> tuple[str, ...]:
    return tuple(sfu.plan_missing_sites(dryrun_config(arch), plan))


def plan_missing_sites(arch: str, plan) -> list[str]:
    """Arch-id wrapper over :func:`sfu.plan_missing_sites`, cached on
    (arch, plan)."""
    return list(_plan_missing_cached(arch, plan))


def _metrics(rec) -> dict:
    return {"flops": float(rec.flops), "bytes": float(rec.bytes),
            "transcendentals": float(rec.transcendentals),
            "coll": collectives.collective_bytes(rec)}


def trace_cell(cfg, mesh, cell, microbatches=None):
    """``(record, seconds)`` of one traced step of ``cell`` (build and run
    on meta operands)."""
    t0 = time.time()
    step, operands = build_step(cfg, mesh, cell, microbatches=microbatches)
    with collectives.trace() as rec:
        step(*operands)
    return rec, time.time() - t0


def run_cell(arch: str, shape: str, multi_pod: bool, act_impl: str = "jnp",
             plan=None, overrides: dict | None = None) -> dict:
    """One cell's row (the JAX package's keys).  Runs under a process group
    of at least the mesh's ranks, or brings up and tears down its own
    (:func:`fake_process_group`)."""
    cell = SHAPE_CELLS[shape]
    over = dict(overrides or {})
    if plan is not None:
        missing = plan_missing_sites(arch, plan)
        if missing:
            raise ValueError(
                f"plan {plan.fingerprint} has no spec for activation sites "
                f"{missing} that arch '{arch}' instantiates (plan sites: "
                f"{[k for k in plan]}) — dump a plan from this arch's "
                "config instead"
            )
        over["act_plan"] = plan
        act_impl = f"plan:{plan.fingerprint}"  # provenance tag for the row
        cfg = dryrun_config(arch, **over)
    else:
        cfg = dryrun_config(arch, act_impl=act_impl, **over)
    if cfg.force_dp_only is None:
        # pinned from the full config, as JAX pins it for its shallow probes
        cfg = dataclasses.replace(
            cfg, force_dp_only=bool(total_params(cfg) < 2.5e9 and cfg.n_experts == 0))
    with fake_process_group():
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        chips = mesh.size()
        mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        mb = auto_microbatches(cfg, cell, mesh) if cell.kind == "train" else None
        # one microbatch, full depth: the whole step's counts
        rec, t_lower = trace_cell(cfg, mesh, cell, microbatches=1 if mb else None)
        cache_bytes = cache_bytes_per_device(cfg, mesh, cell)
    m = _metrics(rec)
    coll = m["coll"]

    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        mflops = model_flops_train(cfg, tokens)        # 6*N*D (fwd+bwd)
    elif cell.kind == "prefill":
        mflops = model_flops_train(cfg, tokens) / 3.0  # forward only = 2ND
    else:
        mflops = model_flops_decode(cfg, cell.global_batch, cell.seq_len)

    mem_bytes = analytic_memory_traffic(cfg, cell, mesh_shape)
    # per-device link traffic (JAX's ring estimates): all-gather/all-to-all/
    # permute ~ output bytes; all-reduce ~ 2x (RS+AG phases); reduce-scatter's
    # *output* is the scattered shard, so scale by the typical (data) axis.
    dp_axis = mesh_shape.get("data", 1)
    coll_dev = (
        coll.get("all-gather", 0)
        + coll.get("all-to-all", 0)
        + coll.get("collective-permute", 0)
        + 2 * coll.get("all-reduce", 0)
        + dp_axis * coll.get("reduce-scatter", 0)
    )
    report = RooflineReport(
        name=f"{arch}__{shape}__{'multi' if multi_pod else 'single'}",
        chips=chips,
        hlo_flops=m["flops"],
        hlo_bytes=mem_bytes,
        coll_bytes=float(coll_dev),
        model_flops=mflops,
        peak_mem_bytes=0.0,
    )
    row = report.row()
    row.update(
        arch=arch,
        shape=shape,
        mesh="2x16x16" if multi_pod else "16x16",
        act_impl=act_impl,
        act_plan=sfu.plan_for(cfg).to_json(),
        act_plan_fingerprint=sfu.plan_for(cfg).fingerprint,
        status="ok",
        t_lower_s=round(t_lower, 1),
        t_compile_s=0.0,
        transcendentals=m["transcendentals"],
        collectives=coll,
        collective_counts=collectives.collective_counts(rec),
        op_histogram=collectives.op_histogram(rec),
        active_params=active_params(cfg),
        memory_analysis="unavailable: meta device",
        peak_analytic_gb=analytic_peak_memory(cfg, cell, mesh_shape, mb or 1) / 2**30,
        hlo_bytes_per_device=m["bytes"],
        cache_bytes_per_device=cache_bytes,
        raw_scan_once=m,  # no scan: the same full-depth counts
    )
    return row


def sweep(args) -> list[tuple[str, str, bool]]:
    """The (arch, shape, multi_pod) cells of the parsed arguments, in the
    JAX package's order."""
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPE_CELLS) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True]
    if args.multipod_only:
        meshes = [True]
    if args.singlepod_only:
        meshes = [False]
    return [(a, s, mp) for a in archs for s in shapes for mp in meshes]


def _skip_row(arch, shape, mp, status):
    return {"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
            "status": status}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + EXTRA_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPE_CELLS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--singlepod-only", action="store_true")
    ap.add_argument(
        "--plan", default=None, metavar="PATH",
        help="trace every cell against this ActivationPlan JSON "
        "(repro_torch.sfu); default: the jnp PWL plan from each arch config",
    )
    ap.add_argument("--out", default="experiments/dryrun")
    # removed flag, kept as a hard error with a pointer, as in the JAX package
    ap.add_argument("--act-impl", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.act_impl is not None:
        ap.error(
            "--act-impl was removed: pass --plan <plan.json> instead "
            "(see docs/plans.md)"
        )
    plan = sfu.load_plan(args.plan) if args.plan else None

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = sweep(args)

    failures = 0
    with fake_process_group():
        for arch, shape, mp in cells:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            path = outdir / f"{tag}.json"
            if cell_is_skipped(arch, shape):
                row = _skip_row(arch, shape, mp,
                                "SKIP (full attention at 500k — DESIGN.md Sec. 5)")
                path.write_text(json.dumps(row, indent=2))
                print(f"[skip] {tag}", flush=True)
                continue
            if plan is not None and plan_missing_sites(arch, plan):
                # one plan JSON cannot cover heterogeneous archs: an explicit skip
                row = _skip_row(arch, shape, mp,
                                f"SKIP (plan {plan.fingerprint} lacks sites "
                                f"{plan_missing_sites(arch, plan)} for this arch)")
                path.write_text(json.dumps(row, indent=2))
                print(f"[skip] {tag} (plan/arch site mismatch)", flush=True)
                continue
            try:
                row = run_cell(arch, shape, mp, plan=plan)
                path.write_text(json.dumps(row, indent=2, default=str))
                print(
                    f"[ok]   {tag}  trace={row['t_lower_s']}s  "
                    f"bottleneck={row['bottleneck']}  "
                    f"t=(c {row['t_compute_ms']:.1f} | m {row['t_memory_ms']:.1f} "
                    f"| x {row['t_collective_ms']:.2f}) ms  "
                    f"peak(analytic)={row['peak_analytic_gb']:.2f} GiB",
                    flush=True,
                )
            except Exception as e:
                failures += 1
                row = _skip_row(arch, shape, mp, f"FAIL: {e}")
                row["traceback"] = traceback.format_exc()[-3000:]
                path.write_text(json.dumps(row, indent=2))
                print(f"[FAIL] {tag}: {str(e)[:300]}", flush=True)
    print(f"done: {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
