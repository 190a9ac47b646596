"""Data-parallel trainer with int8 error-feedback gradient compression
(``repro_torch/distributed/compression.py``), the cross-pod (DCI) sync
tier: the port of examples/train_compressed.py, one process per rank.

    # CPU, two ranks on gloo
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        examples_torch/train_compressed.py --device cpu [--steps 30]
    # GPU, one rank per card on NCCL
    PYTHONPATH=src torchrun --standalone --nproc-per-node 1 examples_torch/train_compressed.py

Each rank takes its 2 rows of the global batch of 2 x world (seq 128),
takes its gradient, syncs it through ``compressed_grad_sync`` and applies
the same AdamW update; the logged loss is the mean over the ranks.
Compression always runs: the JAX example's ``--compress``, which changes
nothing there, is refused here (argparse's exit code 2).
"""
import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.distributed import compression
from repro_torch.launch.serve import resolve_device
from repro_torch.models import Model
from repro_torch.optim import adamw


def main(argv=None, params=None) -> list:
    """Train; returns the per-step losses.  Under ``torchrun`` it brings up
    the process group (gloo on ``--device cpu``, NCCL on ``cuda``) and
    tears it down; in a process group already up it runs there.
    ``params`` are the initial f32 masters (default the seed-0 init)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    own_group = not dist.is_initialized()
    if own_group:
        if "RANK" not in os.environ:
            raise SystemExit("run under torchrun (see the module docstring)")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return _train(args, device, params)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, device, params) -> list:
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = get_reduced_config("repro-100m", act_impl="jnp")
    model = Model(cfg, device=device)
    B = 2 * world
    if params is None:
        params = model.init(seed=0, master=True)
    state = adamw.init_state(params)
    residuals = compression.init_residuals(params)
    opt = adamw.AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=3)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=B))
    losses = []
    for step in range(args.steps):
        # this rank's rows of the global batch
        batch = {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(device)
                 for k, v in data.batch_at(step).items()}
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(state["params"])]
        loss, _ = model.loss(tree.unflatten(state["params"], leaves), batch)
        grads = tree.unflatten(state["params"], list(torch.autograd.grad(loss, leaves)))
        # int8 error-feedback all-reduce across the ranks
        grads, residuals = compression.compressed_grad_sync(grads, residuals)
        with torch.no_grad():
            state, _ = adamw.apply_updates(state, grads, opt)
        loss = loss.detach().clone()
        dist.all_reduce(loss)
        losses.append(float(loss) / world)
        if step % 10 == 0 and rank == 0:
            print(f"[dp-compressed] step={step} loss={losses[-1]:.4f}", flush=True)
    if rank == 0:
        print(f"[dp-compressed] {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "compressed training must reduce loss"
    return losses


if __name__ == "__main__":
    main()
