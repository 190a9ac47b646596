"""The train step (torch port of ``repro/launch/steps.py:build_train_step``).

``build_train_step(cfg, device, opt_cfg, microbatches)`` returns
``step(state, batch) -> (state, metrics)``: the loss and its gradient by
autograd (with K > 1 microbatches, f32 gradients summed over the K slices
of the batch and divided by K, as the JAX package's scan does), then one
AdamW update.  ``cfg.act_impl_bwd`` pins the backward of every fused site
for the whole step (forward, the backward and the recomputation of
``cfg.remat`` inside it); None keeps the ambient default.

One device, no mesh: the sharding rules and ``auto_microbatches`` wait for
the distribution entry of the ROADMAP.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.kernels import fused
from repro_torch.models import Model
from repro_torch.optim import adamw


def _split(batch: dict, k: int) -> list[dict]:
    """``batch`` cut into ``k`` equal slices along the batch axis."""
    B = next(iter(batch.values())).shape[0]
    if B % k:
        raise ValueError(f"batch {B} does not split into {k} microbatches")
    return [{name: v.reshape(k, B // k, *v.shape[1:])[i] for name, v in batch.items()}
            for i in range(k)]


def build_train_step(cfg, device, opt_cfg: Optional[adamw.AdamWConfig] = None,
                     microbatches: int = 1):
    model = Model(cfg, device=device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    impl_bwd = cfg.act_impl_bwd
    if impl_bwd is not None:
        impl_bwd = fused.resolve_impl_bwd(impl_bwd)  # validate at build

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, metrics = model.loss(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state, batch):
        bwd_ctx = (fused.use_impl_bwd(impl_bwd) if impl_bwd is not None
                   else contextlib.nullcontext())
        with bwd_ctx:
            if microbatches <= 1:
                loss, metrics, grads = value_and_grad(state["params"], batch)
            else:
                gacc, loss = None, 0.0
                for mb in _split(batch, microbatches):
                    l, metrics, g = value_and_grad(state["params"], mb)
                    g = [x.to(torch.float32) for x in g]
                    gacc = g if gacc is None else [a + b for a, b in zip(gacc, g)]
                    loss = loss + l
                grads = [g / microbatches for g in gacc]
                loss = loss / microbatches
            with torch.no_grad():
                new_state, opt_metrics = adamw.apply_updates(
                    state, tree.unflatten(state["params"], grads), opt_cfg)
        return new_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step
