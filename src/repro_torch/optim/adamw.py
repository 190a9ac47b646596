"""AdamW over parameter trees, with schedules and global-norm clipping.

A hand port of ``repro/optim/adamw.py``, not ``torch.optim.AdamW``: the
update differs from PyTorch's.  Weight decay is decoupled and applies to
every leaf of two or more dimensions (matrices, and the per-layer stacked
norm scales, as in the JAX package), gradients are clipped by their global
norm first, and the warmup-cosine schedule is taken at ``step + 1`` in f32.

The state mirrors the parameter tree: ``{"params", "mu", "nu", "step"}``
with f32 masters and moments, and ``step`` an int32 scalar tensor on the
parameters' device.  :func:`apply_updates` returns a new state whose
tensors replace the old ones (the old state is not modified), as the
JAX package's pure update does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


def make_schedule(cfg: AdamWConfig) -> Callable:
    """``step`` (an integer tensor) -> the learning rate, an f32 tensor."""
    def sched(step):
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            decay = 1.0
        else:
            t = torch.clamp((step - cfg.warmup_steps)
                            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
            if cfg.schedule == "cosine":
                decay = 0.5 * (1 + torch.cos(math.pi * t))
            else:
                decay = 1.0 - t
        return cfg.lr * warm * decay

    return sched


def init_state(params) -> dict:
    zeros = [torch.zeros_like(p) for p in tree.leaves(params)]
    return {
        "params": params,
        "mu": tree.unflatten(params, zeros),
        "nu": tree.unflatten(params, [torch.zeros_like(z) for z in zeros]),
        "step": torch.zeros((), dtype=torch.int32, device=zeros[0].device),
    }


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.leaves(grads)))


def apply_updates(state: dict, grads, cfg: AdamWConfig) -> tuple[dict, dict]:
    """One AdamW step.  Returns (new_state, metrics) with metrics ``lr``
    and ``grad_norm`` as f32 scalar tensors."""
    step = state["step"] + 1
    lr = make_schedule(cfg)(step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(tree.leaves(state["params"]), tree.leaves(grads),
                            tree.leaves(state["mu"]), tree.leaves(state["nu"])):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * u).to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    params = state["params"]
    new_state = {
        "params": tree.unflatten(params, new_p),
        "mu": tree.unflatten(params, new_mu),
        "nu": tree.unflatten(params, new_nu),
        "step": step,
    }
    return new_state, {"lr": lr, "grad_norm": gnorm}
