"""Multi-rank runs for the port's mesh tests: ``run_ranks`` starts one
process per rank on the CPU (``gloo``), which rendezvous through a file
under the test's ``tmp_path`` (never a fixed port: test workers run side
by side), call one function of ``tests/torch_mesh_workers.py`` and save
what it returns; each run has a timeout of its own, after which every rank
is killed."""
import os
import pathlib
import subprocess
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"

_CHILD = r"""
import sys, importlib.util, torch, torch.distributed as dist
path, fn, rank, world, init, out = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
spec = importlib.util.spec_from_file_location("torch_mesh_workers", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
try:
    res = getattr(mod, fn)(rank, world, *sys.argv[7:])
    torch.save(res, f"{out}/rank{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def run_ranks(fn: str, tmp_path, *args, world: int = 4, timeout: float = 240):
    """Run ``torch_mesh_workers.<fn>(rank, world, *args)`` on ``world``
    ranks; returns each rank's result.  Raises with every rank's stderr
    tail if one fails or the run outlasts ``timeout`` seconds."""
    out = pathlib.Path(tmp_path) / f"ranks_{fn}"
    out.mkdir(parents=True, exist_ok=True)
    init = out / "rendezvous"
    if init.exists():  # a stale rendezvous file would hang the new run
        init.unlink()
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(HERE / "torch_mesh_workers.py"),
                               fn, str(r), str(world), str(init), str(out), *map(str, args)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    failed = None
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        failed = f"timed out after {timeout} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = f"exit codes {[p.returncode for p in procs]}"
    if failed:
        tails = []
        for r, f in enumerate(logs):
            f.seek(0)
            tails.append(f"--- rank {r} ---\n" + f.read()[-4000:])
        raise RuntimeError(f"{fn} on {world} ranks: {failed}\n" + "\n".join(tails))
    for f in logs:
        f.close()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
