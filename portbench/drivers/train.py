"""Pretraining steps of the port's train step.

Set-up makes the float32 masters from the seed, the AdamW state
(``optim.adamw.init_state``) and the step of ``launch.steps.
build_train_step`` (in place, one microbatch, the mix's remat),
and draws every batch of the run on the device.  It drives that one state
through the first ``check.ref_steps`` steps, through the same call and the
same feed as the window, and reads what the comparison needs from it: each
step's loss, the gradient per leaf as AdamW took it in step 1 (its first
moment over 1 - b1) and each leaf's change after the last of those steps
(the masters less the seed's initial values, drawn again).  The window
then runs more steps of the same state on fresh batches until
``--seconds`` have passed, each step's end read by its loss.

Afterwards the peak memory is read, the state is freed, and the plain
reference trains from the same initial masters on the same batches.
With ``control``, the same check also reads the float8 control and the
fault "half of the batch left out, the mean taken over the rest" (the
reference on the first half of every batch in the program's place)
against the same reference run (``portbench/control.py``).
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import program, reference, traffic, weights
from portbench.tracing import Tracer


def run(cell, control: dict | None = None) -> dict:
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    opt = tr["optimizer"]
    n_ref = int(tr["check"]["ref_steps"])
    mcfg = program.model_config(cell, remat=bool(tr["remat"]))
    masters = weights.make(cfg, cell.seed, dev, master=True)
    program.check_layout(mcfg, masters)
    paths = weights.leaf_paths(cfg)
    opt_cfg = adamw.AdamWConfig(**opt)
    step_fn = build_train_step(mcfg, dev, opt_cfg=opt_cfg, microbatches=1, in_place=True)
    state = adamw.init_state(masters)
    n_batches = n_ref + int(math.ceil(cell.seconds / float(tr["min_step_s"]))) + 1
    data = traffic.train_batches(tr, cell.seed, cfg["vocab_size"], n_batches, dev)

    def batch(i):
        return {"tokens": data[i, :, :-1].contiguous(), "targets": data[i, :, 1:].contiguous()}

    losses, first_grad, global_norm = [], None, None
    for i in range(n_ref):
        state, m = step_fn(state, batch(i))
        losses.append(float(m["loss"]))
        if i == 0:
            global_norm = float(m["grad_norm"])
            first_grad = [float(weights.get(state["mu"], p).double().norm()) / (1.0 - opt["b1"])
                          for p in paths]
    change = []
    for path, p0 in weights.iter_leaves(cfg, cell.seed, dev, master=True):
        if path in paths:
            change.append(float((weights.get(state["params"], path) - p0).double().norm()))
        del p0
    sync(dev)

    tracer = Tracer() if cell.trace else None
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    steps, failed, k = 0, 0, n_ref
    while True:
        if k >= n_batches:
            raise RuntimeError(f"the window outran its {n_batches} batches")
        state, m = step_fn(state, batch(k))
        loss = float(m["loss"])  # the step's end
        k += 1
        steps += 1
        failed += 0 if math.isfinite(loss) else 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    t1 = time.perf_counter()
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del state, step_fn, masters, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    prog = {"losses": losses, "grad": first_grad, "change": change, "global_norm": global_norm}
    t_ref = time.perf_counter()
    checks = check(cell, data[:n_ref], paths, prog, control)
    print(f"[portbench] set-up {t0 - cell.t_start:.1f} s, window {t1 - t0:.1f} s, {steps} steps; "
          f"reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return {
        "setup_s": t0 - cell.t_start,
        "window_s": t1 - t0,
        "attempted": steps,
        "failed": failed,
        "train_tokens": steps * int(tr["batch"]) * int(tr["seq"]),
        "peak_bytes": peak,
        "checks": checks,
        "trace": tracer.reduce() if tracer is not None else None,
    }


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reference_run(cell, data, paths, precision: str = "f32") -> dict:
    """The reference's losses, first gradient per leaf and change per leaf
    after ``len(data)`` steps from the seed's initial masters."""
    cfg, dev = cell.config, cell.device
    params = weights.make(cfg, cell.seed, dev, master=True)
    leaves = [weights.get(params, p) for p in paths]
    batches = [(d[:, :-1], d[:, 1:]) for d in data]
    out = reference.family(cfg).train(cfg, cell.tables, params, leaves, batches,
                                      cell.traffic["optimizer"], precision=precision)
    change = []
    for path, p0 in weights.iter_leaves(cfg, cell.seed, dev, master=True):
        if path in paths:
            change.append(float((weights.get(params, path) - p0).double().norm()))
    return {"losses": out["losses"], "grad": out["first_grad"]["leaf_norms"], "change": change,
            "global_norm": out["first_grad"]["global_norm"]}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the largest relative loss gap over the
    steps; the relative gap of step 1's global gradient norm before
    clipping (AdamW's input); and by the worst leaf the gap between the
    program's and the reference's first-gradient norms (as AdamW took them,
    clipped), and change norms, each over the larger of that leaf's
    reference norm and the median leaf's.  Leaves whose reference gradient
    is under a thousandth of the median leaf's are left out of both."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gnorm = abs(prog["global_norm"] - ref["global_norm"]) / ref["global_norm"]
    g_ref = np.asarray(ref["grad"])
    keep = g_ref >= 1e-3 * np.median(g_ref)

    def worst(a, b):
        a, b = np.asarray(a)[keep], np.asarray(b)[keep]
        den = np.maximum(np.abs(b), np.median(np.abs(b)))
        return float(np.max(np.abs(a - b) / den))

    return {"loss_gap": loss, "gnorm_gap": gnorm, "grad_gap": worst(prog["grad"], ref["grad"]),
            "change_gap": worst(prog["change"], ref["change"])}


def judge(cell, got: dict) -> dict:
    """The numbers that the cell's limits name, each beside its limit; the
    others are printed and not compared."""
    for k, v in got.items():
        if k not in cell.limits:
            print(f"[portbench] {k} {v!r} (not compared)", file=sys.stderr)
    return {k: {"value": v, "limit": float(cell.limits[k])} for k, v in got.items()
            if k in cell.limits}


def check(cell, data, paths, prog: dict, control: dict | None = None) -> dict:
    ref = reference_run(cell, data, paths)
    got = gaps(prog, ref)
    if control is not None:
        ctrl = gaps(reference_run(cell, data, paths, precision="fp8"), ref)
        half = gaps(reference_run(cell, data[:, : data.shape[1] // 2], paths), ref)
        control.update(program=got, control=ctrl, half_batch=half,
                       ref_global_norm=ref["global_norm"], ref_losses=ref["losses"],
                       program_losses=prog["losses"])
    for i, path in enumerate(paths):
        print(f"[portbench] leaf {'/'.join(map(str, path))}: first gradient {prog['grad'][i]!r} "
              f"(reference {ref['grad'][i]!r}), change {prog['change'][i]!r} "
              f"(reference {ref['change'][i]!r})", file=sys.stderr)
    return judge(cell, got)
