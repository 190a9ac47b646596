"""Ablation: train the same model with exact vs PWL activations and compare
loss trajectories (the paper's Table III claim, that the approximation is
about lossless, checked in training, which is stricter than the paper's
inference-only evaluation).  The port of examples/ablation_pwl_vs_exact.py.

    PYTHONPATH=src python examples_torch/ablation_pwl_vs_exact.py [--steps 60]
        [--device cpu]

Reduced repro-100m at 8 x 256 on one device (the JAX example's host mesh is
one device on a CPU host or a one-card machine), AdamW at lr 1e-3 with 5
warmup steps.  Runs on ``cuda`` (without a GPU it raises) unless given
``--device cpu``.
"""
import argparse

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model
from repro_torch.optim import adamw


def run(act_impl: str, steps: int, n_bp: int = 32, params=None, device="cuda") -> list:
    """The per-step losses of ``steps`` train steps of reduced repro-100m
    under ``act_impl`` from ``params`` (f32 masters; default the seed-0
    init)."""
    device = resolve_device(str(device))
    cfg = get_reduced_config("repro-100m", act_impl=act_impl, act_breakpoints=n_bp)
    opt = adamw.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=5)
    step_fn = build_train_step(cfg, device, opt_cfg=opt, microbatches=1)
    if params is None:
        params = Model(cfg, device=device).init(seed=0, master=True)
    state = adamw.init_state(params)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=8))
    losses = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    exact = run("exact", args.steps, device=args.device)
    approx = run("jnp", args.steps, device=args.device)
    print(f"{'step':>6} {'exact':>9} {'pwl':>9} {'delta':>9}")
    for i in range(0, args.steps, max(args.steps // 10, 1)):
        print(f"{i:>6} {exact[i]:>9.4f} {approx[i]:>9.4f} {approx[i]-exact[i]:>+9.4f}")
    print(f"final: exact={exact[-1]:.4f} pwl={approx[-1]:.4f} "
          f"delta={approx[-1]-exact[-1]:+.4f}")
    return exact, approx


if __name__ == "__main__":
    main()
