"""Time the flash attention kernels of two checkouts in turns on one card.

    python3 ab_flash.py OTHER_CHECKOUT [PHASE ...]

runs the flash phases of ``chip_smoke.py`` (by default ``flash_phase``,
``flash_bwd_phase`` and ``dh256_phase``) from OTHER_CHECKOUT (A) and from
this checkout (B) in the order A, B, B, A, each in a process of its own that
imports that checkout's ``src`` and builds its kernels into that checkout's
``src/repro_torch/csrc/_build``.  Each run also digests (sha256) the f32
flash forward outputs, row max and gradients of fixed inputs, so the two
checkouts' f32 kernels can be held bitwise to each other.  Prints each run's
timed rows (kernel ms per call, as ``chip_smoke.time_ms`` measures them),
then one JSON line with every run's rows and digests; a run that fails
prints the end of its output.  Needs a GPU.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
DEFAULT_PHASES = ("flash_phase", "flash_bwd_phase", "dh256_phase")

# f32 cases whose outputs are digested: (name, B, S, T, H, Hkv, dh, kwargs)
F32_CASES = [
    ("S=T=3000 causal H=4", 1, 3000, 3000, 4, 4, 64, {"causal": True}),
    ("S=T=3000 causal window 512 H=4", 1, 3000, 3000, 4, 4, 64,
     {"causal": True, "window": 512}),
    ("G=2 S=T=1000 causal H=12 Hkv=6", 1, 1000, 1000, 12, 6, 64, {"causal": True}),
    ("G=2 S=300 T=700 kv_valid_len {0, 513} H=4 Hkv=2", 2, 300, 700, 4, 2, 64,
     {"causal": False, "kv_valid_len": [0, 513]}),
    ("S=300 T=700 causal q_offset 400 H=4", 1, 300, 700, 4, 4, 64,
     {"causal": True, "q_offset": 400}),
    ("dh=256 S=T=700 causal window 128 H=4 Hkv=1", 1, 700, 700, 4, 1, 256,
     {"causal": True, "window": 128}),
]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: pathlib.Path, phases) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused import attention as A

    _build.build(("attention", "attention_bwd"))
    rows = {}
    for ph in phases:
        out = getattr(cs, ph)(torch)
        rows.update({f"{ph}: {k}": v["ms"] for k, v in out.items()
                     if isinstance(v, dict) and "ms" in v})
    _, plan, tables = cs._exp_table(torch)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    digests = {}
    for name, B, S, T, H, hkv, dh, kw in F32_CASES:
        kw = {"window": None, "q_offset": 0, "kv_valid_len": None, **kw}
        if kw["kv_valid_len"] is not None:
            kw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"], device="cuda")
        q, dout = (torch.randn(B, S, H, dh, generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn(B, T, hkv, dh, generator=gen, device="cuda") for _ in range(2))
        out, m = A._launch(q, k, v, plan, tables, kw["causal"], kw["window"], kw["q_offset"],
                           kw["kv_valid_len"], True)
        grads = A.fused_flash_attention_bwd(q, k, v, dout, m, plan, tables, **kw)
        torch.cuda.synchronize()
        digests[name] = _digest([out, m, *grads])
    return {"rows": rows, "digests": digests, "card": cs.card_line()}


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        print("AB_RESULT " + json.dumps(worker(pathlib.Path(argv[1]), argv[2:])))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = pathlib.Path(argv[0]).resolve()
    phases = argv[1:] or list(DEFAULT_PHASES)
    runs = []
    for i, (tag, tree) in enumerate((("A", other), ("B", ROOT), ("B", ROOT), ("A", other))):
        proc = subprocess.run([sys.executable, str(ROOT / "ab_flash.py"), "--worker", str(tree),
                               *phases], capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            print(f"ab_flash: run {i} ({tag}, {tree}) failed with rc {proc.returncode}",
                  file=sys.stderr)
            return 1
        res = json.loads(next(line for line in proc.stdout.splitlines()
                              if line.startswith("AB_RESULT "))[len("AB_RESULT "):])
        runs.append({"tag": tag, "tree": str(tree), **res})
        print(f"[ab] run {i} {tag} ({tree}) on {res['card']}")
        for name, ms in res["rows"].items():
            print(f"[ab]   {name}: {ms * 1e3:.1f} us")
    same = all(runs[0]["digests"][n] == r["digests"][n] for r in runs for n in runs[0]["digests"])
    print(f"[ab] f32 flash outputs, row max and gradients bitwise equal across all runs: {same}")
    print(json.dumps({"runs": runs, "f32_bitwise_equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
