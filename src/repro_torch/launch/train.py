"""Training launcher (torch port): config -> train loop with checkpoint/restart,
preemption handling and straggler monitoring, on one device.

    python -m repro_torch.launch.train --arch repro-100m --steps 200 \\
        --batch 8 --seq 512 --ckpt-dir /tmp/ckpt --plan plan.json     # on cuda
    python -m repro_torch.launch.train --plan plan.json --batch 1 --seq 4096
    python -m repro_torch.launch.train --reduced --device cpu --steps 4
    python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced --plan plan.json
    python -m repro_torch.launch.train --arch mamba2-2.7b --plan plan.json   # 2.70 B, on cuda
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu --reduced \
        --model-parallel 2                                  # a (2, 2) mesh on gloo

The flags are the JAX launcher's (``repro/launch/train.py``), plus
``--device``: ``cuda`` by default, which raises without a GPU; ``cpu`` runs
the plain PyTorch versions of the kernels.  The default plan is the
config's own (exact activations, no kernels); ``--plan`` loads a plan JSON,
under which the sites planned ``impl="fused"`` run the hand-written kernels
forward and backward (with the softmax site fused, attention takes the row
softmax kernels while B*H*S*S fits the dense cap, and the flash kernels past
it, as at ``--batch 1 --seq 4096``; an MoE arch runs its experts in the
per-expert GLU kernels, and the log adds the load-balancing loss, of which
0.01 is in the loss).  Weights are the f32 masters of a
``torch.Generator`` seeded 0; batches come from the seeded synthetic stream
of :mod:`repro_torch.data.pipeline`.

The AdamW update writes into the state's own tensors (one copy of the
state: f32 masters, two moments and the gradients of mamba2-2.7b's 2.70 B
parameters take 43 GB), and a SIGTERM waits for the step to end.

Under ``torchrun`` (a process group of W ranks), ``--model-parallel N``
trains on ``make_host_mesh(model=N)``, a (W // N, N) mesh with the
backend ``nccl`` on ``cuda`` and ``gloo`` on ``--device cpu``: the state
is sharded by the cell rules of the ``--batch`` x ``--seq`` step
(``steps.make_cell_rules``), every rank draws the same batch and keeps its
rows, rank 0 prints and saves whole tensors (every rank gathers them), and
a resume reads them on every rank and places them again.  Without a
process group, ``--model-parallel`` must be 1 (one device).

Exit code: 0 when the last loss is below the first, 2 otherwise, 17 after
a checkpoint-and-exit for a persistent straggler.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import sfu, tree
from repro_torch.checkpoint.manager import CheckpointManager, install_sigterm_save
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, IteratorState, PrefetchIterator, SyntheticLMData
from repro_torch.distributed.monitor import StepMonitor
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import refuse_encoder_decoder, resolve_device
from repro_torch.launch.steps import build_train_step, shard_state
from repro_torch.models import Model, ShapeCell
from repro_torch.optim import adamw


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CI)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="load an ActivationPlan JSON; default: the arch config's own plan")
    ap.add_argument("--dump-plan", default=None, metavar="PATH",
                    help="write the exact activation plan this run uses as JSON")
    ap.add_argument("--impl-bwd", default=None, choices=["fused", "recompute"],
                    help="backward of the fused activation sites: 'fused' (the backward "
                    "kernels, the default) or 'recompute' (plain recomputation, the "
                    "oracle and escape hatch)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default cuda; cpu runs the plain "
                    "versions of the kernels)")
    # removed flags, kept as hard errors with a pointer, as in the JAX launcher
    ap.add_argument("--act-impl", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--act-breakpoints", default=None, help=argparse.SUPPRESS)
    return ap


def resolve_config(args: argparse.Namespace):
    """The model config ``args`` ask for: the arch (reduced or not), the
    ``--plan`` it loads (every site the arch instantiates must be in it) and
    the ``--impl-bwd`` it pins.  Refuses, before any step, an
    encoder-decoder arch and a plan with an ``impl="kernel"`` site (no
    backward)."""
    getter = get_reduced_config if args.reduced else get_config
    if args.plan:
        loaded = sfu.load_plan(args.plan)
        cfg = getter(args.arch, act_plan=loaded)
        missing = sfu.plan_missing_sites(cfg, loaded)
        if missing:
            raise ValueError(f"--plan {args.plan} lacks specs for activation sites "
                             f"{missing} that arch {args.arch!r} instantiates")
    else:
        cfg = getter(args.arch)
    refuse_encoder_decoder(cfg)
    kernel_sites = [k for k, s in sfu.plan_for(cfg).items() if s.impl == "kernel"]
    if kernel_sites:
        raise ValueError(
            f"sites {kernel_sites} are planned impl='kernel', the standalone PWL kernel, "
            "which has no backward (nor has the JAX kernel): plan them 'fused' or 'jnp' "
            "to train")
    if args.impl_bwd is not None:
        cfg = dataclasses.replace(cfg, act_impl_bwd=args.impl_bwd)
    return cfg


@contextlib.contextmanager
def _sigterm_deferred():
    """A SIGTERM that arrives while the state is half updated is held, and
    raised again (to the save handler) once the step is whole."""
    caught = []
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: caught.append(signum))
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)
        if caught:
            signal.raise_signal(signal.SIGTERM)


def run(args: argparse.Namespace) -> dict:
    """One training run as ``args`` describe it.  Returns ``rc`` (the exit
    code), ``losses`` and ``grad_norms`` (this run's steps, the gradient's
    global norm before clipping), ``step_seconds`` (host time per
    step, each ended by reading the loss), ``tokens_per_step`` and ``state``
    (the AdamW state after the last step).

    A checkpoint is labelled with the number of steps done, and a resume
    starts at that step, so it redoes none (the JAX launcher labels its
    periodic saves one step short)."""
    device = resolve_device(args.device)
    mesh = _init_mesh(args, device)
    rank0 = mesh is None or dist.get_rank() == 0
    log = print if rank0 else _quiet  # one log: rank 0's
    cfg = resolve_config(args)
    plan = sfu.plan_for(cfg)
    log(f"[train] activation plan {plan.fingerprint}: "
        f"{ {k: s.impl for k, s in plan.items()} }", flush=True)
    log(f"[train] fused backward impl: {cfg.act_impl_bwd or 'fused (ambient default)'}",
        flush=True)
    if args.dump_plan:
        log(f"[train] plan -> {sfu.dump_plan(plan, args.dump_plan)}", flush=True)
    log(f"[train] {cfg.name} on {device}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"batch {args.batch} x seq {args.seq}, remat {cfg.remat}", flush=True)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5))
    # the update writes into the state's tensors (one copy of the state),
    # so SIGTERM waits for the step to end (below): its save sees one state
    cell = ShapeCell("train", args.seq, args.batch, "train") if mesh is not None else None
    step_fn = build_train_step(cfg, device, opt_cfg=opt_cfg, microbatches=1, in_place=True,
                               mesh=mesh, cell=cell)
    if mesh is not None:
        log(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
            f"{dist.get_backend()}", flush=True)

    model = Model(cfg, device=device)
    data = SyntheticLMData(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))

    # every rank reads checkpoints, rank 0 writes them
    ckpt_cls = CheckpointManager if rank0 else _ReadOnlyCheckpoints
    ckpt = ckpt_cls(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    it_state = None
    state = adamw.init_state(model.init(seed=0, master=True))
    if ckpt and ckpt.latest_step() is not None:
        state, extra_meta = ckpt.restore(like=state, device=device)
        start_step = int(extra_meta.get("step", 0))
        if "iterator" in extra_meta:
            it_state = IteratorState.from_dict(extra_meta["iterator"])
        log(f"[train] resumed from step {start_step}", flush=True)
    if mesh is not None:
        state = shard_state(cfg, state, step_fn.rules)

    it = PrefetchIterator(data, state=it_state)
    monitor = StepMonitor()
    live = {"state": state, "step": start_step}

    def save(step: int) -> None:
        state = live["state"]
        if mesh is not None:  # every rank gathers, rank 0 writes whole tensors
            state = tree.unflatten(state, [t.full_tensor() if is_dtensor(t) else t
                                           for t in tree.leaves(state)])
            if not rank0:
                return
        ckpt.save(step, state, extra={"step": step, "iterator": it.state.to_dict()})

    def emergency_save():
        if ckpt:
            save(live["step"])
            log("[train] SIGTERM: checkpoint saved", flush=True)

    prev_handler = install_sigterm_save(emergency_save)

    losses, grad_norms, step_seconds = [], [], []
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
            t0 = time.perf_counter()
            monitor.start_step()
            with _sigterm_deferred():
                live["state"], metrics = step_fn(live["state"], batch)
                live["step"] = step + 1
            loss = float(metrics["loss"])  # waits for the step
            monitor.end_step(step)
            step_seconds.append(time.perf_counter() - t0)
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                aux = f" aux={float(metrics['aux']):.4f}" if cfg.n_experts else ""
                log(f"[train] step={step} loss={loss:.4f}{aux} lr={float(metrics['lr']):.2e} "
                    f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
            if ckpt and step > 0 and step % args.ckpt_every == 0:
                save(step + 1)  # labelled with the steps done, so a resume redoes none
            if monitor.should_evict:
                log("[train] persistent straggler: checkpoint + exit for reschedule",
                    flush=True)
                emergency_save()
                return {"rc": 17, "losses": losses, "grad_norms": grad_norms,
                        "step_seconds": step_seconds,
                        "tokens_per_step": args.batch * args.seq, "state": live["state"]}
        if ckpt:
            save(args.steps)
    finally:
        it.close()
        signal.signal(signal.SIGTERM, prev_handler)
    if losses:
        log(f"[train] done. first loss {losses[0]:.4f} -> last {losses[-1]:.4f}",
            flush=True)
    rc = 0 if losses and losses[-1] < losses[0] else 2
    return {"rc": rc, "losses": losses, "grad_norms": grad_norms, "step_seconds": step_seconds,
            "tokens_per_step": args.batch * args.seq, "state": live["state"]}


def _quiet(*args, **kw) -> None:
    """The print of ranks other than 0."""


class _ReadOnlyCheckpoints(CheckpointManager):
    """A rank other than 0 finds and reads checkpoints, never writes them."""

    def save(self, step, state, extra=None):
        return None


def _init_mesh(args: argparse.Namespace, device: torch.device):
    """The training mesh when the launcher runs under ``torchrun`` (a
    WORLD_SIZE in the environment): the process group (``nccl`` on cuda,
    ``gloo`` on cpu) and ``make_host_mesh(model=--model-parallel)``.  None
    on one device, where ``--model-parallel`` must be 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and not dist.is_initialized():
        if args.model_parallel != 1:
            raise ValueError(
                f"--model-parallel {args.model_parallel} needs a process group of several "
                "ranks: run under torchrun --nproc-per-node W -m repro_torch.launch.train")
        return None
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if dist.get_world_size() % args.model_parallel:
        raise ValueError(f"--model-parallel {args.model_parallel} does not divide the "
                         f"world of {dist.get_world_size()} ranks")
    return make_host_mesh(model=args.model_parallel, device_type=device.type)


def train(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.act_impl is not None or args.act_breakpoints is not None:
        ap.error("--act-impl/--act-breakpoints were removed: pass --plan <plan.json> "
                 "instead (dump one with --dump-plan)")
    try:
        return run(args)["rc"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(train())
