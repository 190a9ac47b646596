"""Training launcher (torch port): config -> train loop with checkpoint/restart,
preemption handling and straggler monitoring, on one device.

    python -m repro_torch.launch.train --arch repro-100m --steps 200 \\
        --batch 8 --seq 512 --ckpt-dir /tmp/ckpt --plan plan.json     # on cuda
    python -m repro_torch.launch.train --plan plan.json --batch 1 --seq 4096
    python -m repro_torch.launch.train --reduced --device cpu --steps 4
    python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced --plan plan.json

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

Exit code: 0 when the last loss is below the first, 2 otherwise, 17 after
a checkpoint-and-exit for a persistent straggler.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import torch

from repro_torch import sfu
from repro_torch.checkpoint.manager import CheckpointManager, install_sigterm_save
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, IteratorState, PrefetchIterator, SyntheticLMData
from repro_torch.distributed.monitor import StepMonitor
from repro_torch.launch.serve import refuse_encoder_decoder, resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model
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


def run(args: argparse.Namespace) -> dict:
    """One training run as ``args`` describe it.  Returns ``rc`` (the exit
    code), ``losses`` (this run's steps), ``step_seconds`` (host time per
    step, each ended by reading the loss) and ``tokens_per_step``.

    A checkpoint is labelled with the number of steps done, and a resume
    starts at that step, so it redoes none (the JAX launcher labels its
    periodic saves one step short)."""
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel other than 1 needs the distribution entry of the ROADMAP "
            "(the mesh and sharding are not ported yet)")
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    plan = sfu.plan_for(cfg)
    print(f"[train] activation plan {plan.fingerprint}: "
          f"{ {k: s.impl for k, s in plan.items()} }", flush=True)
    print(f"[train] fused backward impl: {cfg.act_impl_bwd or 'fused (ambient default)'}",
          flush=True)
    if args.dump_plan:
        print(f"[train] plan -> {sfu.dump_plan(plan, args.dump_plan)}", flush=True)
    print(f"[train] {cfg.name} on {device}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"batch {args.batch} x seq {args.seq}, remat {cfg.remat}", flush=True)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5))
    step_fn = build_train_step(cfg, device, opt_cfg=opt_cfg, microbatches=1)

    model = Model(cfg, device=device)
    data = SyntheticLMData(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    it_state = None
    state = adamw.init_state(model.init(seed=0, master=True))
    if ckpt and ckpt.latest_step() is not None:
        state, extra_meta = ckpt.restore(like=state, device=device)
        start_step = int(extra_meta.get("step", 0))
        if "iterator" in extra_meta:
            it_state = IteratorState.from_dict(extra_meta["iterator"])
        print(f"[train] resumed from step {start_step}", flush=True)

    it = PrefetchIterator(data, state=it_state)
    monitor = StepMonitor()
    live = {"state": state, "step": start_step}

    def save(step: int) -> None:
        ckpt.save(step, live["state"], extra={"step": step, "iterator": it.state.to_dict()})

    def emergency_save():
        if ckpt:
            save(live["step"])
            print("[train] SIGTERM: checkpoint saved", flush=True)

    prev_handler = install_sigterm_save(emergency_save)

    losses, step_seconds = [], []
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
            t0 = time.perf_counter()
            monitor.start_step()
            live["state"], metrics = step_fn(live["state"], batch)
            loss = float(metrics["loss"])  # waits for the step
            monitor.end_step(step)
            step_seconds.append(time.perf_counter() - t0)
            live["step"] = step + 1
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                aux = f" aux={float(metrics['aux']):.4f}" if cfg.n_experts else ""
                print(f"[train] step={step} loss={loss:.4f}{aux} lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
            if ckpt and step > 0 and step % args.ckpt_every == 0:
                save(step + 1)  # labelled with the steps done, so a resume redoes none
            if monitor.should_evict:
                print("[train] persistent straggler: checkpoint + exit for reschedule",
                      flush=True)
                emergency_save()
                return {"rc": 17, "losses": losses, "step_seconds": step_seconds,
                        "tokens_per_step": args.batch * args.seq}
        if ckpt:
            save(args.steps)
    finally:
        it.close()
        signal.signal(signal.SIGTERM, prev_handler)
    if losses:
        print(f"[train] done. first loss {losses[0]:.4f} -> last {losses[-1]:.4f}",
              flush=True)
    rc = 0 if losses and losses[-1] < losses[0] else 2
    return {"rc": rc, "losses": losses, "step_seconds": step_seconds,
            "tokens_per_step": args.batch * args.seq}


def train(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.act_impl is not None or args.act_breakpoints is not None:
        ap.error("--act-impl/--act-breakpoints were removed: pass --plan <plan.json> "
                 "instead (dump one with --dump-plan)")
    return run(args)["rc"]


if __name__ == "__main__":
    sys.exit(train())
