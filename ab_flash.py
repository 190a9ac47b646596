"""Time the kernels of two checkouts in turns on one card, and diagnose the
held-out training gate across GLU summation orders.

    python3 ab_flash.py [--no-tc] OTHER_CHECKOUT [PHASE ...]
    python3 ab_flash.py --gate OTHER_CHECKOUT [RUN ...]
    python3 ab_flash.py --decode-configs

The first form runs phases of ``chip_smoke.py`` (by default the flash
phases ``flash_phase``, ``flash_bwd_phase`` and ``dh256_phase``; also
``glu_phase``, ``glu_bwd_phase``, ``moe_phase``, ``moe_bwd_phase``,
``linear_phase``, ``linear_bwd_phase``, ``decode_phase``, ``softmax_phase``
``softmax_bwd_phase``, ``norm_phase`` and ``pwl_act_phase``; and this
file's ``decode_rows``, which times the same inputs through the public
wrappers in both checkouts, and ``session_digests``, which digests
full-width paged prefill and decode calls of repro-100m and olmoe-1b-7b
under two plans: logits, tokens and pools) from
OTHER_CHECKOUT (A) and from this checkout (B) in the order A, B, B, A, each
in a process of its own that imports that checkout's ``src`` and
``chip_smoke.py`` and builds its kernels into that checkout's
``src/repro_torch/csrc/_build``.  Each run also digests (sha256) the
outputs of fixed inputs that the two checkouts must give bitwise alike:
the f32 flash forward outputs, row max and gradients; the f32 GLU, MoE GLU
and linear layer, forward and backward; the paged decode's f32 and bf16
outputs; the row softmax's f32 forward and backward outputs on rows up to
1024 wide; the fused RMSNorm's forward output, dx and ds at
``norm_phase``'s shapes under each of its epilogues; both standalone PWL
kernels' outputs.  Then B runs
once more for each tensor-core configuration of ``csrc/glu.cu``, forced by
the compile-time define ``GLU_TC_FORCE`` in a build directory of its own:
the bf16 GLU-family digests, at every M ("tc ..." keys), must be equal in
every B run and every forced configuration (one summation order whatever
the tile; where A's differ, the line is printed once, as the intended
change of an A whose order differs), and each forced run times the bf16
GLU family at the model paths' shapes (``tc_rows``); ``--no-tc`` leaves
the forced runs out, for a change that does not touch ``csrc/glu.cu``.  Prints each run's timed rows (kernel us per
call, as ``chip_smoke.time_ms`` measures them), then one JSON line with
every run's rows and digests; a run that fails prints the end of its
output.

The second form trains full-width repro-100m under the fused-softmax plan
as ``chip_smoke.py``'s gates do (by default 20 steps at 8 x 512, and 20
and 60 steps at 1 x 4096 through the flash kernels; any run of
``GATE_RUNS`` by name), from init seeds 0 and 1, under four GLU summation
orders, each in a process of its own: (a) OTHER_CHECKOUT's kernel; (b) the
plain GLU (``fused_glu_plain`` / ``fused_glu_bwd_plain``, cuBLAS's order,
put in place of the kernel launch in that process only); (c)
OTHER_CHECKOUT's CUDA-core kernel with its Small configuration forced at
every M (a copy of its ``glu.cu`` whose ``SMALL_M`` is the define
``GLU_SMALL_M``, built in a directory of its own); (d) this checkout's
kernel.  For each it prints the held-out loss at init, after the steps,
and the drop: on the batch ``chip_smoke.HELD_OUT_STEP`` and on the mean
over it and the 7 after it (whole, and on their first 512 positions),
evaluated in bf16 as the run computes and in f32 from the f32 masters as
``chip_smoke._held_out_gate`` does; and, on the 1 x 4096 model's 12 GLU
inputs at init, max |order - plain| / max |plain| per layer of the forward
output and of dzg, dzu under a fixed g; the last line is all of it as
JSON.

The third form times this checkout's bf16 GLU family at M <= 16 (the dense
GLU at M = 4, 8 and 16, the linear layer at M = 4, the MoE GLU at olmoe's
C = 1, full and with every other bucket empty, and C = 5) under Small and
each decode configuration of ``csrc/glu.cu`` and the variants of them in
``DECODE_VARIANTS`` (each forced by ``GLU_TC_FORCE``, a variant by a
one-line hook of its ``using`` line, all built at once), in one process,
and holds their outputs bitwise equal.  Needs a GPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
DEFAULT_PHASES = ("flash_phase", "flash_bwd_phase", "dh256_phase")
N_TC_CONFIGS = 5  # csrc/glu.cu tc::pick: Wide, Mid, Small, Decode, DecodeWide

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

# GLU-family shapes whose outputs are digested: (E, M, K, N); E = 0 is the
# dense GLU.  Every tile configuration of the f32 kernel, ragged edges; in
# bf16 every tensor-core configuration (M = 4 the decode configuration).
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

# the gate diagnostic's GLU orders: (label, tree "other" or "this", mode)
GATE_ORDERS = [("a: OTHER kernel", "other", "kernel"), ("b: plain (cuBLAS)", "other", "plain"),
               ("c: OTHER Small forced", "other", "small"), ("d: this kernel", "this", "kernel")]
GATE_SEEDS = (0, 1)
# runs the gate diagnostic may take: name -> (batch, seq, steps, lr); the
# first two are chip_smoke.py's gates
GATE_RUNS = {"8x512": (8, 512, 20, 3e-4), "1x4096": (1, 4096, 20, 3e-4),
             "1x4096 60 steps": (1, 4096, 60, 3e-4), "1x4096 lr 1e-3": (1, 4096, 20, 1e-3),
             "1x4096 lr 1e-3 40 steps": (1, 4096, 40, 1e-3), "2x4096": (2, 4096, 20, 3e-4)}
GATE_DEFAULT = ("8x512", "1x4096", "1x4096 60 steps")
GATE_STEPS = 20
GATE_BATCHES = 8  # the held-out batch and the 7 after it, for their mean


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
    """The GLU, MoE GLU and linear layer, forward and backward, through
    their wrappers on fixed normal inputs, in f32 and in bf16.  The bf16
    digests (the tensor-core kernel, at every M) are keyed "tc ..."."""
    from repro_torch import sfu
    from repro_torch.kernels.fused import fused_glu, fused_linear, fused_moe_glu
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.kernels.fused.glu import fused_glu_bwd
    from repro_torch.kernels.fused.linear import fused_linear_bwd

    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    plan, tables = plan_and_operands(table)
    tables = tuple(t.cuda() for t in tables)
    digests = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        gen = torch.Generator(device="cuda").manual_seed(4321)

        def key(M, name):
            return f"{'tc ' if tag == 'bf16' else ''}{name}"

        for E, M, K, N in GLU_CASES:
            lead = (E,) if E else ()
            x = torch.randn(*lead, M, K, generator=gen, device="cuda").to(dtype)
            wg, wu = ((torch.randn(*lead, K, N, generator=gen, device="cuda") / math.sqrt(K))
                      .to(dtype) for _ in range(2))
            g = torch.randn(*lead, M, N, generator=gen, device="cuda").to(dtype)
            fwd = (fused_moe_glu if E else fused_glu)(x, wg, wu, table=table)
            bwd = fused_glu_bwd(x, wg, wu, g, plan, tables)
            torch.cuda.synchronize()
            digests[key(M, f"glu {tag} E={E} M={M} K={K} N={N}")] = _digest([fwd, *bwd])
        for M, K, N in LINEAR_CASES:
            x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).to(dtype)
            b = (torch.randn(N, generator=gen, device="cuda") * 0.1).to(dtype)
            g = torch.randn(M, N, generator=gen, device="cuda").to(dtype)
            outs = [fused_linear(x, w, bias, table=table) for bias in (b, None)]
            outs += [fused_linear_bwd(x, w, bias, g, plan, tables) for bias in (b, None)]
            torch.cuda.synchronize()
            digests[key(M, f"linear {tag} M={M} K={K} N={N}")] = _digest(outs)
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


# standalone PWL cases whose outputs are digested: (name, elements, dtype,
# offset): the offset view starts one element past a 16-byte boundary
PWL_CASES = [("4096 x 3072 + 3 bf16", 4096 * 3072 + 3, "bfloat16", 0),
             ("offset view 4097 bf16", 4097, "bfloat16", 1),
             ("offset view 4099 f32", 4099, "float32", 1),
             ("4096 x 768 f16", 4096 * 768, "float16", 0)]


def pwl_digests(torch, cs) -> dict:
    """Both standalone PWL kernels (``ops.pwl_activation`` under the
    32-breakpoint gelu_tanh table, ``ops.pwl_activation_uniform`` under the
    32-breakpoint uniform sigmoid table) on ``PWL_CASES``."""
    from repro_torch import sfu
    from repro_torch.core import functions as F
    from repro_torch.core.pwl import make_uniform_table
    from repro_torch.kernels import ops

    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    spec = F.get("sigmoid")
    ut = make_uniform_table(spec, 32)
    gen = torch.Generator(device="cuda").manual_seed(97)
    digests = {}
    for name, n, dtype, offset in PWL_CASES:
        x = (torch.randn(n + offset, generator=gen, device="cuda") * 5.0).to(
            getattr(torch, dtype))[offset:]
        y = ops.pwl_activation(x, table)
        u = ops.pwl_activation_uniform(x, ut.m, ut.q, *spec.default_range)
        torch.cuda.synchronize()
        digests[f"pwl {name}"] = _digest([y, u])
    return digests


def decode_rows(torch, cs) -> dict:
    """Device time of the shapes this slice redesigned, through the public
    wrappers, on the same inputs in both checkouts: the bf16 GLU (gelu_tanh)
    and linear layer (gelu, bias) at M = 4 (K = 768, N = 3072; 8 and 12
    weight copies in turn, past the L2 cache), the MoE GLU (silu) at olmoe's
    E = 64, C = 1 with every bucket full and with every other bucket zeroed,
    and both standalone PWL kernels at 4096 x 3072 bf16.  Returns
    ``{name: {"ms": ...}}`` as a phase does."""
    from repro_torch.core import functions as F
    from repro_torch.core.pwl import make_uniform_table
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import fused_glu, fused_linear, fused_moe_glu

    gen = torch.Generator(device="cuda").manual_seed(98)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    rows = {}
    K, N = cs.K_DIM, cs.N_DIM
    glu_t = cs._table(torch, "gelu_tanh")[0]
    wgs = [rnd(K, N, scale=K ** -0.5) for _ in range(8)]
    wus = [rnd(K, N, scale=K ** -0.5) for _ in range(8)]
    x = rnd(4, K)
    rows["glu M=4"] = cs.time_ms(torch, lambda i: fused_glu(x, wgs[i % 8], wus[i % 8],
                                                            table=glu_t))
    del wgs, wus
    lin_t = cs._table(torch, "gelu")[0]
    ws = [rnd(K, N, scale=K ** -0.5) for _ in range(12)]
    b = rnd(N, scale=0.1)
    rows["linear M=4"] = cs.time_ms(torch, lambda i: fused_linear(x, ws[i % 12], b,
                                                                  table=lin_t))
    del ws
    moe_t = cs._table(torch, "silu")[0]
    E, K, N = cs.MOE_E, cs.MOE_K, cs.MOE_N
    wg, wu = rnd(E, K, N, scale=K ** -0.5), rnd(E, K, N, scale=K ** -0.5)
    xm = rnd(E, 1, K)
    xz = xm.clone()
    xz[1::2] = 0.0
    for name, xx in (("moe C=1 full", xm), ("moe C=1 every other bucket empty", xz)):
        rows[name] = cs.time_ms(torch, lambda i: fused_moe_glu(xx, wg, wu, table=moe_t),
                                reps=10, iters=3)
    del wg, wu
    table = cs._table(torch, "gelu_tanh")[0]
    spec = F.get("sigmoid")
    ut = make_uniform_table(spec, 32)
    um, uq = ut.m.cuda(), ut.q.cuda()
    xp = rnd(cs.TRAIN_TOKENS, cs.N_DIM, scale=4.0)
    rows["pwl non-uniform 4096 x 3072"] = cs.time_ms(torch, lambda i: ops.pwl_activation(xp, table))
    rows["pwl uniform 4096 x 3072"] = cs.time_ms(
        torch, lambda i: ops.pwl_activation_uniform(xp, um, uq, *spec.default_range))
    return {k: {"ms": v} for k, v in rows.items()}


SESSION_ARCHS = ("repro-100m", "olmoe-1b-7b")
SESSION_REQUESTS, SESSION_PROMPT, SESSION_STEPS = 4, 32, 8


def session_digests(torch, cs) -> dict:
    """Digests of full-width paged model calls, which the page writes and the
    rotation of q and k run in: for repro-100m and olmoe-1b-7b (seed-0
    weights) under the default plan and the plan with the softmax site
    fused, 4 requests of 32 prompt tokens (numpy seed 1), each prefilled on
    its own as the engine does, then 8 batched decode steps of the greedy
    tokens.  One digest of every call's f32 logits, the tokens and every
    layer's pools after the last step; through ``Model`` alone, so the
    parent checkout runs it as it is.  Returns ``{name: {"digest": ...}}``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    dev = torch.device("cuda")
    ps, pages_each = cs.PS, -(-(SESSION_PROMPT + SESSION_STEPS) // cs.PS)
    out = {}
    for arch in SESSION_ARCHS:
        params = None
        for plan, pwl_softmax in (("default", False), ("fused softmax", True)):
            model = Model(get_config(arch, act_impl="fused", pwl_softmax=pwl_softmax),
                          device=dev)
            params = params if params is not None else model.init(seed=0)
            prompts = np.random.default_rng(1).integers(
                0, model.cfg.vocab_size, (SESSION_REQUESTS, SESSION_PROMPT)).astype(np.int32)
            cache = model.make_paged_cache(1 + SESSION_REQUESTS * pages_each, ps)
            table = 1 + np.arange(SESSION_REQUESTS * pages_each, dtype=np.int32).reshape(
                SESSION_REQUESTS, pages_each)[:, ::-1].copy()  # each row's pages descending

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            logits, tokens = [], []
            with torch.no_grad():
                for b in range(SESSION_REQUESTS):
                    logits.append(model.prefill_paged(
                        params, t(prompts[b:b + 1]), cache,
                        t(table[b:b + 1, :SESSION_PROMPT // ps]),
                        t(np.asarray([SESSION_PROMPT], np.int32))))
                cur = torch.cat([lg[:, 0].argmax(-1) for lg in logits]).to(torch.int32)
                kv_len = np.full(SESSION_REQUESTS, SESSION_PROMPT, np.int32)
                for _ in range(SESSION_STEPS):
                    tokens.append(cur)
                    logits.append(model.decode_step_paged(params, cur[:, None], cache, t(table),
                                                          t(kv_len)))
                    cur = logits[-1][:, 0].argmax(-1).to(torch.int32)
                    kv_len += 1
            torch.cuda.synchronize()
            pools = [c[k] for c in cache for k in ("k_pages", "v_pages")]
            out[f"{arch} {plan}"] = {"digest": _digest([*logits, *tokens, cur, *pools])}
            del model, cache, pools, logits
        del params
        torch.cuda.empty_cache()
    return out


LOCAL_PHASES = {"decode_rows": decode_rows, "session_digests": session_digests}


# row-softmax cases whose f32 forward and backward outputs are digested: the
# narrow rows (N <= 1024, one warp a row), whose sums keep one order. (name,
# score shape, kwargs); "lens" a prefix mask per leading index, "ties" the
# row max tied three ways
SOFTMAX_CASES = [
    ("train 8x12x512 rows x 512 causal", (8, 1, 12, 512, 512), {"causal": True}),
    ("prefill 12x32 rows x 32 causal", (1, 1, 12, 32, 32), {"causal": True}),
    ("dense decode 48 x 48 mask", (4, 12, 1, 48), {"lens": [48, 33, 1, 0]}),
    ("512 x 512 three-way ties", (512, 512), {"ties": True}),
]


def softmax_digests(torch, cs) -> dict:
    """The row softmax's f32 outputs, forward (``fused_pwl_softmax``) and
    backward (``fused_pwl_softmax_bwd``), under the fused-softmax plan's exp
    table, on ``SOFTMAX_CASES``."""
    from repro_torch.kernels.fused import fused_pwl_softmax
    from repro_torch.kernels.fused.softmax import fused_pwl_softmax_bwd

    table, plan, tables = cs._exp_table(torch)
    gen = torch.Generator(device="cuda").manual_seed(1357)
    digests = {}
    for name, shape, kw in SOFTMAX_CASES:
        x = torch.randn(shape, generator=gen, device="cuda") * 3.0
        g = torch.randn(shape, generator=gen, device="cuda")
        N = shape[-1]
        if kw.get("ties"):
            x[..., :3] = x.amax(dim=-1, keepdim=True) + 1.0
        fkw, mask2, causal = {}, None, bool(kw.get("causal"))
        if "lens" in kw:
            lens = torch.tensor(kw["lens"], device="cuda")
            fkw["mask"] = (torch.arange(N, device="cuda")[None, :] < lens[:, None])[:, None, None]
            mask2 = torch.broadcast_to(fkw["mask"], shape).reshape(-1, N).to(torch.float32)
        y = fused_pwl_softmax(x, table=table, causal=causal, **fkw)
        dx = fused_pwl_softmax_bwd(x.reshape(-1, N), mask2, g.reshape(-1, N), plan, tables,
                                   shape[-2] if causal else 1, causal)
        torch.cuda.synchronize()
        digests[f"softmax {name}"] = _digest([y, dx])
    return digests


# fused RMSNorm cases whose forward output, dx and ds are digested under
# every epilogue: chip_smoke.norm_phase's shapes (name, M, D, bf16?)
NORM_CASES = [("4096 x 768 bf16", 4096, 768, True), ("4096 x 2048 bf16", 4096, 2048, True),
              ("4096 x 5120 bf16", 4096, 5120, True), ("33 x 40 f32", 33, 40, False),
              ("21 x 48 f32", 21, 48, False), ("37 x 3000 f32", 37, 3000, False)]
NORM_EPILOGUES = ("identity", "gelu PWL f32", "gelu PWL bf16", "gelu PWL int8", "exact gelu",
                  "silu PWL f32 64", "exact silu")


def _norm_kwargs(ep: str) -> dict:
    """``table=`` or ``act=`` of a named epilogue: "identity", "exact <fn>" or
    "<fn> PWL <format> [<breakpoints>]" (32 breakpoints unless named)."""
    from repro_torch import sfu

    if ep == "identity":
        return {}
    if ep.startswith("exact "):
        return {"act": ep.split()[1]}
    fn, _, fmt, *n = ep.split()
    return {"table": sfu.get_store().get(fn=fn, n_breakpoints=int(n[0]) if n else 32,
                                         dtype=fmt)}


def norm_digests(torch) -> dict:
    """The fused RMSNorm's forward output (``fused_rmsnorm``) and backward
    ``(dx, ds)`` (``fused_rmsnorm_bwd``) on ``NORM_CASES`` under each of
    ``NORM_EPILOGUES``."""
    from repro_torch.kernels.fused import fused_rmsnorm
    from repro_torch.kernels.fused.epilogue import device_operands
    from repro_torch.kernels.fused.norm import fused_rmsnorm_bwd

    gen = torch.Generator(device="cuda").manual_seed(2468)
    digests = {}
    for name, M, D, bf16 in NORM_CASES:
        dtype = torch.bfloat16 if bf16 else torch.float32
        x = (torch.randn(M, D, generator=gen, device="cuda") * 3.0).to(dtype)
        s = torch.randn(D, generator=gen, device="cuda") * 0.3
        g = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
        for ep in NORM_EPILOGUES:
            kw = _norm_kwargs(ep)
            kplan, ktables = device_operands(kw.get("table"), kw.get("act"), "cuda")
            y = fused_rmsnorm(x, s, **kw)
            dx, ds = fused_rmsnorm_bwd(x, s, g, kplan, ktables)
            torch.cuda.synchronize()
            digests[f"rmsnorm {name} {ep}"] = _digest([y, dx, ds])
    return digests


def tc_rows(torch, cs) -> dict:
    """Device time (ms a call) of the bf16 GLU family at the model paths'
    shapes: the GLU forward at a decode step (M = 4), a prefill (M = 32,
    128, 512) and a train step (4096) and its backward there; the linear
    layer at whisper's decode (4), prefill (128), encoder (6000) and
    training encoder backward (12000); the MoE GLU at olmoe's C = 1, 5, 40,
    640 and its backward at 640."""
    from repro_torch.kernels.fused import fused_glu, fused_linear, fused_moe_glu
    from repro_torch.kernels.fused.glu import fused_glu_bwd
    from repro_torch.kernels.fused.linear import fused_linear_bwd

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(99)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf)

    rows = {}
    glu_t, glu_plan, glu_tabs = cs._table(torch, "gelu_tanh")
    K, N = cs.K_DIM, cs.N_DIM
    wg, wu = rnd(K, N, scale=K ** -0.5), rnd(K, N, scale=K ** -0.5)
    for M in (4, 32, 128, 512, cs.TRAIN_TOKENS):
        x = rnd(M, K)
        rows[f"glu fwd M={M}"] = cs.time_ms(torch, lambda i: fused_glu(x, wg, wu, table=glu_t),
                                            reps=5, iters=4)
    g = rnd(cs.TRAIN_TOKENS, N)
    rows[f"glu bwd M={cs.TRAIN_TOKENS}"] = cs.time_ms(
        torch, lambda i: fused_glu_bwd(x, wg, wu, g, glu_plan, glu_tabs), reps=5, iters=4)
    lin_t, lin_plan, lin_tabs = cs._table(torch, "gelu")
    w, b = rnd(K, N, scale=K ** -0.5), rnd(N, scale=0.1)
    for M in (4, 128, cs.WHISPER_ENC_M):
        x = rnd(M, K)
        rows[f"linear fwd M={M}"] = cs.time_ms(
            torch, lambda i: fused_linear(x, w, b, table=lin_t), reps=5, iters=4)
    M = cs.WHISPER_TRAIN_BATCH * cs.WHISPER_FRAMES
    x, g = rnd(M, K), rnd(M, N)
    rows[f"linear bwd M={M}"] = cs.time_ms(
        torch, lambda i: fused_linear_bwd(x, w, b, g, lin_plan, lin_tabs), reps=3, iters=3)
    moe_t, moe_plan, moe_tabs = cs._table(torch, "silu")
    E, K, N = cs.MOE_E, cs.MOE_K, cs.MOE_N
    wg, wu = rnd(E, K, N, scale=K ** -0.5), rnd(E, K, N, scale=K ** -0.5)
    for C in (1, 5, 40, cs.MOE_TRAIN_C):
        x = rnd(E, C, K)
        rows[f"moe fwd C={C}"] = cs.time_ms(
            torch, lambda i: fused_moe_glu(x, wg, wu, table=moe_t), reps=3, iters=3)
    g = rnd(E, cs.MOE_TRAIN_C, N)
    rows[f"moe bwd C={cs.MOE_TRAIN_C}"] = cs.time_ms(
        torch, lambda i: fused_glu_bwd(x, wg, wu, g, moe_plan, moe_tabs, counter=fused_moe_glu),
        reps=3, iters=3)
    return rows


def forced_build(_build, tree: pathlib.Path, name: str, define: str, hook=None) -> None:
    """Point ``_build`` at a copy of ``tree``'s CUDA sources in a directory of
    its own, compiled with ``-D<define>``; ``hook`` (old, new) is a one-line
    substitution made in the copy of ``glu.cu`` first, so that a constant of
    the checkout's source reads the define."""
    src = tree / "src" / "repro_torch" / "csrc"
    dst = src / "_build" / f"forced-{name}"
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    for p in [*src.glob("*.cu"), *src.glob("*.cuh")]:
        text = p.read_text()
        if hook is not None and p.name == "glu.cu":
            if hook[0] not in text:
                raise RuntimeError(f"{p}: no line {hook[0]!r} to hook")
            text = text.replace(hook[0], hook[1])
        (dst / p.name).write_text(text)
    _build.CSRC = dst
    _build.BUILD_DIR = dst / "_build"
    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, f"-D{define}")


# --decode-configs: the decode configurations' lines in csrc/glu.cu, and
# variants of them (label, GLU_TC_FORCE value, the configuration's template
# arguments in place of that line's, or None for the source's own)
DECODE_LINES = {3: "using Decode = TcCfg<16, 32, 1, 2, 256, 3, NW, true, 8>;",
                4: "using DecodeWide = TcCfg<16, 128, 1, 4, 128, 3, NW, true, 16>;"}
DECODE_VARIANTS = [
    ("Small: 32 x 32, 4 warps, 4 x 64-deep", 2, None),
    ("16 x 32, 2 warps, 6 x 64-deep", 3, "16, 32, 1, 2, 64, 6, NW, true"),
    ("16 x 32, 2 warps, 10 x 64-deep", 3, "16, 32, 1, 2, 64, 10, NW, true"),
    ("16 x 32, 2 warps, 3 x 256-deep", 3, "16, 32, 1, 2, 256, 3, NW, true"),
    ("Decode: 16 x 32, 8 warps, 3 x 256-deep", 3, None),
    ("16 x 32, 16 warps, 3 x 256-deep", 3, "16, 32, 1, 2, 256, 3, NW, true, 16"),
    ("16 x 16, 8 warps, 3 x 256-deep", 3, "16, 16, 1, 1, 256, 3, NW, true, 8"),
    ("16 x 64, 8 warps, 5 x 128-deep", 3, "16, 64, 1, 4, 128, 5, NW, true, 8"),
    ("DecodeWide: 16 x 128, 16 warps, 3 x 128-deep", 4, None),
    ("16 x 128, 16 warps, 3 x 128-deep, no skip", 4, "16, 128, 1, 4, 128, 3, NW, false, 16"),
    ("16 x 256, 8 warps, 3 x 64-deep", 4, "16, 256, 1, 4, 64, 3, NW, true, 8"),
]


def decode_config_rows(torch, cs):
    """Device time (ms a call) of the bf16 GLU family at M <= 16, and a
    digest of its outputs: the dense GLU (gelu_tanh) at M = 4, 8 and 16 (8
    weight copies in turn), the linear layer (gelu, bias) at M = 4 (12
    copies), the MoE GLU (silu) at olmoe's C = 1, every bucket full and
    every other one empty, and C = 5."""
    from repro_torch.kernels.fused import fused_glu, fused_linear, fused_moe_glu

    gen = torch.Generator(device="cuda").manual_seed(96)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    rows, outs = {}, []
    K, N = cs.K_DIM, cs.N_DIM
    glu_t = cs._table(torch, "gelu_tanh")[0]
    wgs = [rnd(K, N, scale=K ** -0.5) for _ in range(8)]
    wus = [rnd(K, N, scale=K ** -0.5) for _ in range(8)]
    for M in (4, 8, 16):
        x = rnd(M, K)
        outs.append(fused_glu(x, wgs[0], wus[0], table=glu_t))
        rows[f"glu M={M}"] = cs.time_ms(torch, lambda i: fused_glu(x, wgs[i % 8], wus[i % 8],
                                                                   table=glu_t))
    del wgs, wus
    lin_t = cs._table(torch, "gelu")[0]
    ws = [rnd(K, N, scale=K ** -0.5) for _ in range(12)]
    b, x = rnd(N, scale=0.1), rnd(4, K)
    outs.append(fused_linear(x, ws[0], b, table=lin_t))
    rows["linear M=4"] = cs.time_ms(torch, lambda i: fused_linear(x, ws[i % 12], b,
                                                                  table=lin_t))
    del ws
    moe_t = cs._table(torch, "silu")[0]
    E, K, N = cs.MOE_E, cs.MOE_K, cs.MOE_N
    wg, wu = rnd(E, K, N, scale=K ** -0.5), rnd(E, K, N, scale=K ** -0.5)
    x1 = rnd(E, 1, K)
    xz = x1.clone()
    xz[1::2] = 0.0
    for name, xx in (("moe C=1 full", x1), ("moe C=1 every other bucket empty", xz),
                     ("moe C=5", rnd(E, 5, K))):
        outs.append(fused_moe_glu(xx, wg, wu, table=moe_t))
        rows[name] = cs.time_ms(torch, lambda i: fused_moe_glu(xx, wg, wu, table=moe_t),
                                reps=10, iters=3)
    torch.cuda.synchronize()
    return rows, _digest(outs)


def decode_configs() -> int:
    """``decode_config_rows`` under each of ``DECODE_VARIANTS``; prints a row
    a configuration and the JSON of all; 1 if their outputs differ."""
    torch, cs, _build = _import_tree(ROOT)
    flags, builds = _build.NVCC_FLAGS, []
    for i, (_, force, args) in enumerate(DECODE_VARIANTS):
        hook = None
        if args is not None:
            line = DECODE_LINES[force]
            hook = (line, f"{line.split(' = ')[0]} = TcCfg<{args}>;")
        forced_build(_build, ROOT, f"decode{i}", f"GLU_TC_FORCE={force}", hook)
        out = _build.lib_path("glu")
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out),
               str(_build.CSRC / "glu.cu")]
        builds.append((_build.CSRC, _build.NVCC_FLAGS,
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)))
        _build.NVCC_FLAGS = flags
    for _, _, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            return 1
    results = []
    for (label, force, _), (csrc, nvcc_flags, _) in zip(DECODE_VARIANTS, builds):
        _build.CSRC, _build.BUILD_DIR, _build.NVCC_FLAGS = csrc, csrc / "_build", nvcc_flags
        _build._LOADED.pop("glu", None)
        _build._SIGNED.difference_update({k for k in _build._SIGNED if k[0] == "glu"})
        rows, digest = decode_config_rows(torch, cs)
        results.append({"config": label, "force": force, "rows": rows, "digest": digest})
        print(f"[decode] {label}: " + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in rows.items()))
    same = len({r["digest"] for r in results}) == 1
    print(f"[decode] on {cs.card_line()}; outputs bitwise equal across configurations: {same}")
    print(json.dumps({"decode_configs": results, "bitwise_equal": same}))
    return 0 if same else 1


def _import_tree(tree: pathlib.Path):
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    return torch, cs, _build


def worker(tree: pathlib.Path, force: int | None, phases) -> dict:
    """``phases`` and every digest on ``tree``'s kernels; with ``force`` the
    GLU library alone, built with ``GLU_TC_FORCE=force``: its digests and
    ``tc_rows``."""
    torch, cs, _build = _import_tree(tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    if force is not None:
        forced_build(_build, tree, f"tc{force}", f"GLU_TC_FORCE={force}")
        _build.build(("glu",))
        rows = {f"tc: {k}": v for k, v in tc_rows(torch, cs).items()}
        return {"rows": rows, "digests": glu_digests(torch), "card": cs.card_line()}
    _build.build()
    rows, phase_digests = {}, {}
    for ph in phases:
        out = LOCAL_PHASES[ph](torch, cs) if ph in LOCAL_PHASES else getattr(cs, ph)(torch)
        rows.update({f"{ph}: {k}": v["ms"] for k, v in out.items()
                     if isinstance(v, dict) and "ms" in v})
        rows.update({f"{ph}: {k} {part}": v[part]["ms"] for k, v in out.items()  # norm_phase
                     for part in ("fwd", "bwd") if isinstance(v, dict) and part in v})
        phase_digests.update({f"{ph}: {k}": v["digest"] for k, v in out.items()
                              if isinstance(v, dict) and "digest" in v})
    digests = {**flash_digests(torch, cs), **glu_digests(torch), **decode_digests(torch, cs),
               **softmax_digests(torch, cs), **norm_digests(torch), **pwl_digests(torch, cs),
               **phase_digests}
    return {"rows": rows, "digests": digests, "card": cs.card_line()}


# ---------------------------------------------------------------------------
# the held-out gate across GLU summation orders


def _use_plain_glu():
    """The plain GLU in place of the kernel launches, in this process only."""
    from repro_torch.kernels.fused import glu as G

    G._launch_forward = lambda what, x, wg, wu, plan, tables: G.fused_glu_plain(
        x, wg, wu, plan, tables)
    G._launch_backward = lambda what, x, wg, wu, g, plan, tables: G.fused_glu_bwd_plain(
        x, wg, wu, g, plan, tables)


def _glu_gaps(torch, model, params, batch) -> list:
    """The 12 GLU inputs of one forward pass, and per layer max |order -
    plain| / max |plain| of the output and of dzg, dzu under a fixed g."""
    from repro_torch.kernels.fused import glu as G

    seen, launch = [], G._launch_forward

    def capture(what, x, wg, wu, plan, tables):
        if x.dim() == 2:  # the dense call, not its one-expert form
            seen.append((x.clone(), wg, wu, plan, tables))
        return launch(what, x, wg, wu, plan, tables)

    G._launch_forward = capture
    try:
        with torch.no_grad():
            model.loss(params, batch)
    finally:
        G._launch_forward = launch
    gen = torch.Generator(device="cuda").manual_seed(7)

    def gap(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    out = []
    for x, wg, wu, plan, tables in seen:
        g = torch.randn(x.shape[0], wg.shape[1], generator=gen, device="cuda").to(x.dtype)
        y = launch("fused_glu", x, wg, wu, plan, tables)
        dzg, dzu = G._launch_backward("fused_glu", x, wg, wu, g, plan, tables)
        pdzg, pdzu = G.fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
        out.append([gap(y, G.fused_glu_plain(x, wg, wu, plan, tables)), gap(dzg, pdzg),
                    gap(dzu, pdzu)])
    return out


def _gate_run(torch, cs, plan: str, B: int, S: int, seed: int, gaps: bool,
              steps: int = GATE_STEPS, lr: float = 3e-4) -> dict:
    """``chip_smoke``'s training gate as ``launch.train.run`` trains: the
    held-out losses at init and after ``steps`` steps from init seed
    ``seed``, on the held-out batch and the 7 after it, and on their first
    512 positions (a causal model's loss there does not see the rest)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    args = train.build_parser().parse_args(
        ["--arch", "repro-100m", "--steps", str(steps), "--plan", plan, "--batch", str(B),
         "--seq", str(S), "--lr", str(lr)])
    cfg = train.resolve_config(args)
    model = Model(cfg, device="cuda")
    state = adamw.init_state(model.init(seed=seed, master=True))
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))

    def batch_at(step):
        return {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(step).items()}

    held = [batch_at(cs.HELD_OUT_STEP + i) for i in range(GATE_BATCHES)]

    def losses(params, n=S):
        with torch.no_grad():
            return [float(model.loss(params, {k: v[:, :n] for k, v in b.items()})[0])
                    for b in held]

    model32 = Model(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")

    def losses32(params):
        with torch.no_grad():
            return [float(model32.loss(params, b)[0]) for b in held]

    init, init512 = losses(state["params"]), losses(state["params"], 512)
    init32 = losses32(state["params"])
    layer_gaps = _glu_gaps(torch, model, state["params"], held[0]) if gaps else None
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=steps,
                                warmup_steps=max(steps // 20, 5))
    step_fn = build_train_step(cfg, "cuda", opt_cfg=opt_cfg, microbatches=1)
    step_losses = []
    for step in range(steps):
        state, metrics = step_fn(state, batch_at(step))
        step_losses.append(float(metrics["loss"]))
    after, after512 = losses(state["params"]), losses(state["params"], 512)
    after32 = losses32(state["params"])
    return {"steps": steps, "step_losses": step_losses, "init": init[0], "after": after[0], "drop": init[0] - after[0],
            "init_mean": statistics.fmean(init), "after_mean": statistics.fmean(after),
            "drop_mean": statistics.fmean(init) - statistics.fmean(after),
            "drops": [a - b for a, b in zip(init, after)],
            "drop_mean_512": statistics.fmean(init512) - statistics.fmean(after512),
            "init32": init32[0], "drop32": init32[0] - after32[0],
            "init32_mean": statistics.fmean(init32),
            "drop32_mean": statistics.fmean(init32) - statistics.fmean(after32),
            "first_loss": step_losses[0], "last_loss": step_losses[-1], "gaps": layer_gaps}


def gate_worker(tree: pathlib.Path, mode: str, seed: int, runs) -> dict:
    torch, cs, _build = _import_tree(tree)
    if mode == "small":
        forced_build(_build, tree, "small-m", "GLU_SMALL_M=1000000",
                     hook=("SMALL_M = 64;", "SMALL_M = GLU_SMALL_M;"))
    _build.build(("glu", "softmax", "attention", "attention_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "plain":
        _use_plain_glu()
    with tempfile.TemporaryDirectory() as tmp:
        plan = cs.dump_plan(pathlib.Path(tmp) / "plan.json")
        res = {name: _gate_run(torch, cs, plan, *GATE_RUNS[name][:2], seed,
                               gaps=name == "1x4096", steps=GATE_RUNS[name][2],
                               lr=GATE_RUNS[name][3]) for name in runs}
    return {"runs": res, "card": cs.card_line()}


def _run_worker(argv, cwd) -> dict | None:
    proc = subprocess.run([sys.executable, str(ROOT / "ab_flash.py"), *argv],
                          capture_output=True, text=True, cwd=cwd)
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
        print(f"ab_flash: {' '.join(argv)} failed with rc {proc.returncode}", file=sys.stderr)
        return None
    return json.loads(next(line for line in proc.stdout.splitlines()
                           if line.startswith("AB_RESULT "))[len("AB_RESULT "):])


def gate_main(other: pathlib.Path, runs) -> int:
    results, failed = [], []
    for seed in GATE_SEEDS:
        for label, which, mode in GATE_ORDERS:
            tree = other if which == "other" else ROOT
            res = _run_worker(["--gate-worker", str(tree), mode, str(seed), *runs], tree)
            if res is None:
                failed.append(f"seed {seed} {label}")
                continue
            results.append({"order": label, "seed": seed, **res})
            print(f"[gate] seed {seed} {label} on {res['card']}")
            for name, r in res["runs"].items():
                print(f"[gate]   {name}: held-out loss at init {r['init']:.6f}, after "
                      f"{r['steps']} steps {r['after']:.6f}, drop {r['drop']:.6f}; over "
                      f"{GATE_BATCHES} batches {r['init_mean']:.6f} -> {r['after_mean']:.6f}, "
                      f"drop {r['drop_mean']:.6f} (each "
                      + " ".join(f"{d:.4f}" for d in r["drops"])
                      + f"; first 512 positions {r['drop_mean_512']:.6f}); step loss "
                      f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}; evaluated in f32: init "
                      f"{r['init32']:.6f}, drop {r['drop32']:.6f}, over {GATE_BATCHES} "
                      f"batches init {r['init32_mean']:.6f}, drop {r['drop32_mean']:.6f}")
                if r["gaps"]:
                    worst = [max(col) for col in zip(*r["gaps"])]
                    print(f"[gate]   {name} GLU gaps to plain, worst layer: out {worst[0]:.3g}, "
                          f"dzg {worst[1]:.3g}, dzu {worst[2]:.3g}; per layer out "
                          + " ".join(f"{g[0]:.2g}" for g in r["gaps"]))
    for name in runs:
        for seed in GATE_SEEDS:
            rs = [r for r in results if r["seed"] == seed]
            if not rs:
                continue
            inits = [r["runs"][name]["init"] for r in rs]
            drops = [r["runs"][name]["drop"] for r in rs]
            means = [r["runs"][name]["drop_mean"] for r in rs]
            m32 = [r["runs"][name]["drop32_mean"] for r in rs]
            i32 = [r["runs"][name]["init32"] for r in rs]
            print(f"[gate] {name} seed {seed}: init spread {max(inits) - min(inits):.6f}, drops "
                  + ", ".join(f"{d:.6f}" for d in drops) + f"; over {GATE_BATCHES} batches "
                  + ", ".join(f"{d:.6f}" for d in means) + f"; f32 init spread "
                  f"{max(i32) - min(i32):.6f}, f32 drops over {GATE_BATCHES} batches "
                  + ", ".join(f"{d:.6f}" for d in m32))
    print(json.dumps({"gate": results, "failed": failed}))
    return 1 if failed else 0


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        force = int(argv[3]) if argv[2:3] == ["--force-tc"] else None
        print("AB_RESULT " + json.dumps(worker(pathlib.Path(argv[1]), force,
                                               [] if force is not None else argv[2:])))
        return 0
    if argv == ["--decode-configs"]:
        return decode_configs()
    if argv[:1] == ["--gate-worker"]:
        print("AB_RESULT " + json.dumps(gate_worker(pathlib.Path(argv[1]), argv[2],
                                                    int(argv[3]), argv[4:])))
        return 0
    if argv[:1] == ["--gate"] and len(argv) >= 2:
        runs = argv[2:] or list(GATE_DEFAULT)
        unknown = [r for r in runs if r not in GATE_RUNS]
        if unknown:
            print(f"unknown runs {unknown}; known: {list(GATE_RUNS)}", file=sys.stderr)
            return 2
        return gate_main(pathlib.Path(argv[1]).resolve(), runs)
    no_tc = argv[:1] == ["--no-tc"]
    argv = argv[1:] if no_tc else argv
    if not argv or argv[0].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    other = pathlib.Path(argv[0]).resolve()
    phases = argv[1:] or list(DEFAULT_PHASES)
    runs = []
    plan = [("A", other, None), ("B", ROOT, None), ("B", ROOT, None), ("A", other, None)]
    plan += [] if no_tc else [(f"B tc{i}", ROOT, i) for i in range(N_TC_CONFIGS)]
    for i, (tag, tree, force) in enumerate(plan):
        argv_w = ["--worker", str(tree), *(["--force-tc", str(force)] if force is not None
                                           else phases)]
        res = _run_worker(argv_w, tree)
        if res is None:
            return 1
        runs.append({"tag": tag, "tree": str(tree), **res})
        print(f"[ab] run {i} {tag} ({tree}) on {res['card']}")
        for name, ms in res["rows"].items():
            print(f"[ab]   {name}: {ms * 1e3:.1f} us")
    b_runs = [r for r in runs if r["tag"].startswith("B")]
    names = sorted({n for r in runs for n in r["digests"]})
    differ = []
    for n in names:
        among = b_runs if n.startswith("tc ") else [r for r in runs if n in r["digests"]]
        vals = [r["digests"].get(n) for r in among]
        if len(set(vals)) != 1:
            differ.append(n)
            print(f"[ab] differs: {n}: " + ", ".join(f"{r['tag']} {v}"
                                                     for r, v in zip(among, vals)))
        elif n.startswith("tc "):
            other = {r["digests"].get(n) for r in runs if r["tag"] == "A"}
            if other != set(vals):
                print(f"[ab] other order in A (not a failure): {n}: A {sorted(other)}, "
                      f"B {vals[0]}")
    same = not differ
    print(f"[ab] f32 flash, f32 GLU family, f32/bf16 decode, f32 row softmax (N <= 1024), "
          f"RMSNorm (forward, dx, ds), standalone PWL outputs and the phases' digests bitwise "
          f"equal across all runs, and the bf16 GLU family across this checkout's runs"
          + ("" if no_tc else f" and its {N_TC_CONFIGS} forced tensor-core configurations")
          + f": {same}")
    print(json.dumps({"runs": runs, "bitwise_equal": same, "differ": differ}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
