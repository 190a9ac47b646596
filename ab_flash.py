"""Time the kernels of two checkouts in turns on one card.

    python3 ab_flash.py OTHER_CHECKOUT [PHASE ...]

Runs phases of ``chip_smoke.py`` (by default the flash phases
``flash_phase``, ``flash_bwd_phase`` and ``dh256_phase``; also
``glu_phase``, ``glu_bwd_phase``, ``moe_phase``, ``moe_bwd_phase``,
``linear_phase``, ``linear_bwd_phase`` and ``decode_phase``) from
OTHER_CHECKOUT (A) and from this checkout (B) in the order A, B, B, A, each
in a process of its own that imports that checkout's ``src`` and
``chip_smoke.py`` and builds its kernels into that checkout's
``src/repro_torch/csrc/_build``.  Each run also digests (sha256) the
outputs of fixed inputs that the two checkouts must give bitwise alike:
the f32 flash forward outputs, row max and gradients; the f32 GLU, MoE GLU
and linear layer, forward and backward; the paged decode's f32 and bf16
outputs.  Prints each run's timed rows (kernel ms per call, as
``chip_smoke.time_ms`` measures them), then one JSON line with every run's
rows and digests; a run that fails prints the end of its output.  Needs a
GPU.
"""
from __future__ import annotations

import hashlib
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
DEFAULT_PHASES = ("flash_phase", "flash_bwd_phase", "dh256_phase")

# f32 flash cases whose outputs are digested: (name, B, S, T, H, Hkv, dh, kwargs)
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

# f32 GLU-family shapes whose outputs are digested: (E, M, K, N); E = 0 is
# the dense GLU.  Every tile configuration of the f32 kernel, ragged edges.
GLU_CASES = [(0, 4, 768, 3072), (0, 37, 65, 130), (0, 512, 768, 3072), (3, 37, 65, 130),
             (4, 640, 256, 512)]
LINEAR_CASES = [(4, 768, 3072), (37, 65, 130), (600, 768, 3072)]

# paged decode cases whose f32 and bf16 outputs are digested: (name, kv_len,
# n_cols, Hkv, G, pages, pages_per_split, dh), 16-key pages
DECODE_CASES = [
    ("B=4 kv_len {19,32,15,0}", [19, 32, 15, 0], 4, 12, 1, 17, None, 64),
    ("one request at 4104 keys", [4104, 0, 37, 2050], 258, 12, 1, 1033, None, 64),
    ("G=2 Hkv=6, 2 pages a split", [19, 32, 15, 0], 4, 6, 2, 17, 2, 64),
    ("dh=128 Hkv=16", [19, 32, 15, 0], 4, 16, 1, 17, None, 128),
    ("gemma3-1b dh=256 G=4", [19, 32, 15, 2100], 132, 1, 4, 529, None, 256),
    ("G=4 dh=128, 5 pages a split", [700, 1, 333, 0], 44, 2, 4, 181, 5, 128),
]


def _digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def flash_digests(torch, cs) -> dict:
    from repro_torch.kernels.fused import attention as A

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
        digests[f"flash {name}"] = _digest([out, m, *grads])
    return digests


def glu_digests(torch) -> dict:
    """The f32 GLU, MoE GLU and linear layer, forward and backward, through
    their wrappers on fixed normal inputs."""
    from repro_torch import sfu
    from repro_torch.kernels.fused import fused_glu, fused_linear, fused_moe_glu
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.kernels.fused.glu import fused_glu_bwd
    from repro_torch.kernels.fused.linear import fused_linear_bwd

    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    plan, tables = plan_and_operands(table)
    tables = tuple(t.cuda() for t in tables)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    digests = {}
    for E, M, K, N in GLU_CASES:
        lead = (E,) if E else ()
        x = torch.randn(*lead, M, K, generator=gen, device="cuda")
        wg, wu = (torch.randn(*lead, K, N, generator=gen, device="cuda") / math.sqrt(K)
                  for _ in range(2))
        g = torch.randn(*lead, M, N, generator=gen, device="cuda")
        fwd = (fused_moe_glu if E else fused_glu)(x, wg, wu, table=table)
        bwd = fused_glu_bwd(x, wg, wu, g, plan, tables)
        torch.cuda.synchronize()
        digests[f"glu f32 E={E} M={M} K={K} N={N}"] = _digest([fwd, *bwd])
    for M, K, N in LINEAR_CASES:
        x = torch.randn(M, K, generator=gen, device="cuda")
        w = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        b = torch.randn(N, generator=gen, device="cuda") * 0.1
        g = torch.randn(M, N, generator=gen, device="cuda")
        outs = [fused_linear(x, w, bias, table=table) for bias in (b, None)]
        outs += [fused_linear_bwd(x, w, bias, g, plan, tables) for bias in (b, None)]
        torch.cuda.synchronize()
        digests[f"linear f32 M={M} K={K} N={N}"] = _digest(outs)
    return digests


def decode_digests(torch, cs) -> dict:
    """The paged decode's outputs in f32, in bf16 and with f32 queries on
    bf16 pools, on fragmented page tables."""
    from repro_torch.kernels.fused import paged_flash_decode

    table = cs._exp_table(torch)[0]
    gen = torch.Generator(device="cuda").manual_seed(2468)
    digests = {}
    for name, kv_len, n_cols, hkv, G, P, pps, dh in DECODE_CASES:
        tab = torch.zeros((len(kv_len), n_cols), dtype=torch.int32)
        for b, r in enumerate(cs._fragmented_table(len(kv_len), n_cols, P)):
            tab[b, :len(r)] = torch.tensor(r)
        tab = tab.cuda()
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        q = torch.randn(len(kv_len), 1, hkv * G, dh, generator=gen, device="cuda")
        kp, vp = (torch.randn(hkv, P, cs.PS, dh, generator=gen, device="cuda")
                  for _ in range(2))
        for tag, qd, kvd in (("f32", torch.float32, torch.float32),
                             ("bf16", torch.bfloat16, torch.bfloat16),
                             ("f32 q, bf16 pools", torch.float32, torch.bfloat16)):
            out = paged_flash_decode(q.to(qd), kp.to(kvd), vp.to(kvd), tab, lens, table=table,
                                     pages_per_split=pps)
            torch.cuda.synchronize()
            digests[f"decode {name} {tag}"] = _digest([out])
    return digests


def worker(tree: pathlib.Path, phases) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for ph in phases:
        out = getattr(cs, ph)(torch)
        rows.update({f"{ph}: {k}": v["ms"] for k, v in out.items()
                     if isinstance(v, dict) and "ms" in v})
    digests = {**flash_digests(torch, cs), **glu_digests(torch), **decode_digests(torch, cs)}
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
    differ = sorted(n for n in runs[0]["digests"]
                    if any(r["digests"].get(n) != runs[0]["digests"][n] for r in runs))
    for n in differ:
        print(f"[ab] differs: {n}: " + ", ".join(r["digests"].get(n, "-") for r in runs))
    same = not differ
    print(f"[ab] f32 flash, f32 GLU family and f32/bf16 decode outputs bitwise equal across "
          f"all runs: {same}")
    print(json.dumps({"runs": runs, "bitwise_equal": same, "differ": differ}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
