"""Does ``gloo`` take CUDA tensors for every collective the sharded step issues?

    python3 mesh_probe.py [--world 2] [--timeout 120]

For each collective, starts ``--world`` ranks on the one card
(``torch.cuda.set_device(0)`` in each; NCCL refuses two ranks on one
device), joined by a ``gloo`` process group that rendezvous through a file
in a temporary directory (fresh processes for each, since a collective
that crashes its ranks ends them), and tries on CUDA tensors each collective that ``torch.distributed.tensor.debug.
CommDebugMode`` counts in the port's 2x2 train step on the CPU:
``c10d.allreduce_`` (SUM and MAX, the local bodies' sums and maxima), and
the functional ``all_gather_into_tensor``, ``all_reduce`` and
``reduce_scatter_tensor`` (DTensor's redistributions), in f32 and bf16,
then a DTensor redistribution on a ``cuda`` mesh.  Prints one line per
collective, ``ok``, its error, or the signal that ended a rank, and the
card's name and power limit; the
last line is a JSON object of the results.  Exit code 0 when every
collective ran and agreed with its value on the host, 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

CHILD = "--child"
DTENSOR = "DTensor Shard->Replicate on a cuda mesh"
COLLECTIVES = [f"{op} {dt}" for dt in ("float32", "bfloat16") for op in (
    "c10d.allreduce_ SUM", "c10d.allreduce_ MAX", "c10d_functional.all_reduce",
    "c10d_functional.all_gather_into_tensor", "c10d_functional.reduce_scatter_tensor")] \
    + [DTENSOR]


def _child(rank: int, world: int, init: str, out: str, only: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    print(f"[probe rank {rank}] torch {torch.__version__}, joining", flush=True)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    print(f"[probe rank {rank}] joined", flush=True)
    dev = torch.device("cuda", 0)
    results = {}

    def attempt(name, fn, want):
        if name != only:
            return
        print(f"[probe rank {rank}] {name} ...", flush=True)
        try:
            got = fn()
            torch.cuda.synchronize()
            ok = got.device.type == "cuda" and torch.equal(got.cpu(), want)
            results[name] = "ok" if ok else f"wrong value on {got.device}"
        except Exception as e:  # the finding: which collective gloo refuses on CUDA
            results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        print(f"[probe rank {rank}] {name}: {results[name]}", flush=True)

    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).removeprefix("torch.")
        x = torch.full((4, 8), float(rank + 1), dtype=dt)
        total = sum(float(r + 1) for r in range(world))

        def allreduce(op):
            y = x.clone().to(dev)
            dist.all_reduce(y, op=op)
            return y

        attempt(f"c10d.allreduce_ SUM {tag}", lambda: allreduce(dist.ReduceOp.SUM),
                torch.full((4, 8), total, dtype=dt))
        attempt(f"c10d.allreduce_ MAX {tag}", lambda: allreduce(dist.ReduceOp.MAX),
                torch.full((4, 8), float(world), dtype=dt))
        group = dist.group.WORLD.group_name
        attempt(f"c10d_functional.all_reduce {tag}",
                lambda: fc.wait_tensor(fc.all_reduce(x.clone().to(dev), "sum", group)),
                torch.full((4, 8), total, dtype=dt))
        attempt(f"c10d_functional.all_gather_into_tensor {tag}",
                lambda: fc.wait_tensor(fc.all_gather_tensor(x.clone().to(dev), 0, group)),
                torch.cat([torch.full((4, 8), float(r + 1), dtype=dt) for r in range(world)]))
        attempt(f"c10d_functional.reduce_scatter_tensor {tag}",
                lambda: fc.wait_tensor(fc.reduce_scatter_tensor(
                    torch.full((4 * world, 8), float(rank + 1), dtype=dt, device=dev), "sum", 0,
                    group)),
                torch.full((4, 8), total, dtype=dt))
    if only == DTENSOR:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        def redistribute():
            mesh = init_device_mesh("cuda", (world,))
            full = torch.arange(world * 32, dtype=torch.float32).reshape(world * 8, 4)
            d = distribute_tensor(full.to(dev), mesh, [Shard(0)])
            return d.redistribute(mesh, [Replicate()]).to_local()

        attempt(DTENSOR, redistribute,
                torch.arange(world * 32, dtype=torch.float32).reshape(world * 8, 4))
    dist.destroy_process_group()
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(results, f)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == CHILD:
        _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"[probe] card: {card}; gloo, {args.world} ranks on cuda:0, one process group "
          "a collective", flush=True)
    results = {name: _run(name, args.world, args.timeout) for name in COLLECTIVES}
    for name, res in results.items():
        print(f"[probe] {name}: " + "; ".join(f"rank {r} {v}" for r, v in enumerate(res)),
              flush=True)
    ok = all(v == "ok" for res in results.values() for v in res)
    print(json.dumps({"all_ok": ok, "world": args.world, "card": card, "results": results}))
    return 0 if ok else 1


def _run(name: str, world: int, timeout: float) -> list:
    """Each rank's result of one collective, in processes of its own: a
    rank that dies (a segfault in the transport) reports its signal."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, CHILD, str(r), str(world),
                                   os.path.join(tmp, "rendezvous"), tmp, name],
                                  stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        errs = []
        for p in procs:
            try:
                errs.append(p.communicate(timeout=timeout)[1])
            except subprocess.TimeoutExpired:
                p.kill()
                errs.append(p.communicate()[1] + f"\ntimed out after {timeout} s")
        out = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.json")
            res = json.load(open(path)).get(name) if os.path.exists(path) else None
            if p.returncode:
                tail = " ".join(errs[r].strip().splitlines()[-1:])[:200]
                res = f"process ended with {p.returncode}" + (f" ({tail})" if tail else "")
            out.append(res or "no result")
        return out


if __name__ == "__main__":
    sys.exit(main())
