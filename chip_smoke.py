#!/usr/bin/env python3
"""Smoke test of the torch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the serving and training paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all eight started
   together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving and training paths give it (the backward kernels of
   the GLU, the MoE GLU, the row softmax and the flash attention included;
   the MoE GLU at olmoe-1b-7b's experts and the bucket capacities of its
   calls; the dense GLU, and the MoE GLU at one expert, bitwise the outputs
   recorded in ``GLU_DIGESTS``; the page writes and the paged decode
   also at olmoe's 16 KV heads of dim 128), and times kernel, plain version
   and a PyTorch yardstick call the port never makes;
3. serves full-width repro-100m through ``repro_torch.launch.serve`` on
   ``cuda``: under the default plan (the defaults, then a larger session),
   and under a dumped plan with the ``attn.softmax:exp`` site fused (the
   defaults, a 4096-token prompt bucket, and the dense loop), and checks from
   the launch counters, reset before and read after each session, that every
   GLU, page write, softmax, paged decode and flash forward of that session
   went through its kernel; then serves full-width olmoe-1b-7b (16 MoE
   layers, 64 experts top 8, seed-0 weights) three times: the defaults and
   ``--batch 8 --prompt-len 256 --max-new 32`` under the default plan, and
   the defaults under a dumped plan with the softmax site fused, checking
   that every layer of every model call ran the MoE GLU kernel and no dense
   GLU;
4. trains full-width repro-100m through ``repro_torch.launch.train`` under
   the dumped plan (20 steps with checkpoints, then a resume), and checks
   that the loss fell (the launcher's rc, and the f32 mean loss of 8
   held-out batches at the step-20 checkpoint) and that every GLU and row
   softmax, forward and backward, went through its kernel (24 forwards and
   12 backwards of each per step under remat); then 60 steps at batch
   1 x 4096, past the dense cap, with the same checks on the GLU and the
   flash attention (24 flash forwards and 12 flash backward calls per step,
   no row softmax; the held-out gate on average over this run and the same
   run with the plain GLU); and
   trains reduced olmoe-1b-7b 20 steps under its fused plan (2 MoE GLU
   forwards and 2 backwards a step);
5. checks the gradients: one full-width olmoe-1b-7b MoE layer on 8 x 512
   tokens under the MoE GLU's backward kernel against plain recomputation; a full-width batch of 8 x 512 and one of 1 x 4096
   under the backward kernels against plain recomputation on the card (with
   remat off against on in f32, and a rounding yardstick in bf16), and
   reduced f32 on the card against the CPU;
6. checks the port on the card against its plain path on the CPU in f32:
   reduced olmoe-1b-7b (logits, loss, nll, aux, every gradient, paged
   prefill and decode logits) and reduced repro-100m under both plans
   (logits, and paged against dense greedy tokens);
7. slice 5: holds the standalone PWL kernels (``csrc/pwl_act.cu``, the
   non-uniform decode and the uniform baseline) bitwise against their plain
   versions, and the GLU and the row softmax with a bf16 table bitwise
   against their plain versions on the table's native operands; serves
   repro-100m under an ``impl="kernel"`` plan (the standalone kernel on
   every GLU gate, 12 launches a model call) and under a fused-softmax plan
   with bf16 tables;
8. slice 6: holds the fused linear layer (forward and backward, in
   ``csrc/glu.cu``) against its plain version at whisper-small's shapes;
   serves full-width whisper-small through ``Model.prefill(frames=)`` and
   ``decode_step`` (the linear and row-softmax kernels in every layer),
   trains it 4 steps at 8 x 448 over 1500 frames (the encoder past the
   dense cap: the flash kernels, non-causal), holds its full-width
   gradients (backward kernels against plain recomputation) and reduced
   whisper on the card against the CPU;
9. slice 7: holds the fused RMSNorm (``csrc/norm.cu``, forward and
   backward) against its plain versions at repro-100m's training rows and
   olmoe's and qwen2.5-32b's widths in bf16 and at odd widths in f32, with
   identity, PWL (f32, bf16, int8 tables) and exact epilogues, and drives it
   once through its autograd (no model calls it; redesigned in slice 12:
   rows in registers, up to 4096 wide over 1-4 warps forward and 1024 wide
   backward, the breakpoint search); holds every kernel that takes an
   epilogue plan under exact (``act=``) and identity plans, forward and
   backward, on grids that hit the kinks, and drives each through its
   public entry point; holds the flash forward and backward at head dim
   256 (gemma3-1b's attention, causal with and without its 512 window) and
   the split-KV decode at dh 256;
10. slice 8: prints each kernel's registers and spills and the tensor-core
   (HMMA) instructions of the flash kernels' SASS; holds the flash kernels'
   bf16 tensor-core design against the plain versions on every mask
   (GQA, the 512 window, ``kv_valid_len`` with 0, ``q_offset``, T of 700,
   1500 and 3000, whisper's non-causal encoder, dh 64, 80, 128, 208 and
   256), the row max bitwise on integer grids, and on random bf16 inputs
   checks that the backward's stats kernel finds every live row's forward
   row max again (its raw tie count at least 1);
11. slice 9: prints the HMMA count of the GLU library's SASS too; the paged
   decode's long splits run as three kernels over all of a split's pages
   (``decode_phase`` and ``dh256_phase`` hold them).  ``ab_flash.py`` times
   the kernels of two checkouts in turns and holds their outputs bitwise;
12. slice 10: the GLU family's bf16 kernel (the GLU, the MoE GLU and the
   linear layer, forward and backward) runs on the tensor cores above
   M = 4, so the build fails if the GLU library's SASS has no HMMA
   instruction; its bf16 backward checks on normal inputs hold the
   gradients at 1e-2 outside the order band of a breakpoint, and every slope
   that is not the plain version's within that band, a neighbouring
   segment's (``_order_band``).  ``ab_flash.py --gate`` runs the two
   training gates under several GLU summation orders;
13. slice 11: the row softmax, forward and backward, decodes by the
   breakpoint search, skips masked scores, and splits rows wider than 1024
   over a thread-block cluster; its phases add whisper's decode
   cross-attention (48 rows of 1500, timed), odd widths 1025 and 4097
   under causal + window, and a backward over 48 rows of 32768 with
   three-way ties and wholly masked rows (their dx the plain version's,
   NaN and all);
14. slice 13: the bf16 GLU family's decode steps and short prefills (M <=
   16, the MoE's C <= 16) run the tensor-core kernel's decode
   configurations, so no bf16 CUDA-core GLU kernel is built (checked in
   the SASS), and ``glu_decode_phase`` holds the rows of every such launch
   bitwise the same rows of an M = 32 launch (every epilogue kind, both
   directions, a ragged shape); ``moe_skip_phase`` holds the empty-bucket
   skip at olmoe's E = 64, C = 1 and times it; the olmoe default session
   prints its mean count of non-empty buckets a decode step; the standalone
   PWL kernels (16-byte vectors, the breakpoint search) stay bitwise their
   plain versions, ragged and offset inputs included;
15. slice 14: the paged model calls rotate q and k in their page writes
   (``rope_write_prompt_pages_``, ``rope_append_kv_``: one launch a layer,
   the rotary tables computed once a call); ``kv_phase`` holds them bitwise
   against their plain versions and against the chain they replaced (q,
   the prefill's k, the pools outside page 0) at repro-100m's and olmoe's
   decode and 32-token prefill and at a 2 x 4096 prefill, timed beside that
   chain, and untimed with GQA at head dim 256, f32 pools, strided q/k/v and
   misaligned rows; every paged session launches them once a layer a call
   and the writes without the rotation never;
16. slice 15, the dense architectures (no new kernel): holds the GLU and
   its backward at the five new K x N (olmo-1b, stablelm-1.6b,
   qwen2.5-32b, gemma3-1b, internvl2-1b) at M = 4, 32 and 4096, the page
   writes and the split-KV decode at G = 5 and 7, the flash kernels at
   gemma3-1b's 1 x 4096 training shape with its 512 window, and the row
   softmax forward and backward on 4 x 4096 rows of 4096, causal and
   windowed; draws qwen2.5-32b's 32.76 B parameters on the card and prints
   the peak; serves olmo-1b, stablelm-1.6b, internvl2-1b and qwen2.5-32b
   at the defaults (qwen also under its fused-softmax plan: the split-KV
   decode at G = 5; internvl too: G = 7), gemma3-1b at the defaults (serve
   falls back to its dense loop with a line on stderr) and in the dense
   loop at 4 x 2048 + 16 under its fused-softmax plan (local layers on the
   flash kernel with the window, global ones on the row softmax, decode on
   the 512-slot rings); runs internvl2-1b's vision prefix through
   ``Model.prefill``, ``decode_step`` and ``Model.loss``; trains olmo-1b
   at 8 x 512 and resumes it (losses bit for bit the straight run's) and
   gemma3-1b at 1 x 4096 (held by the held-out gate); and holds the
   reduced archs on the card against the CPU;
17. slice 16, the Mamba2 SSM layer (no new kernel; ``models/ssm.py`` is
   PyTorch ops, as the JAX block is ``jnp``): holds the standalone PWL
   kernel at mamba2-2.7b's dt shapes (softplus, f32, 4 x 32 / 1 / 300 x
   80) and on an empty tensor (no launch counted); serves full-width
   mamba2-2.7b three times (paged asked for: serve falls back to its dense
   loop; the defaults and a 300-token prompt with no kernel launched, the
   empty FFN's GLU launching nothing, and the defaults with ``ssm:softplus``
   on the standalone kernel, 64 launches a model call); trains it at 8 x
   512 (every gradient norm finite) and, cut to 2 layers at full width so
   that the script writes under 45 GiB to disk, resumes it (losses bit for
   bit);
   and holds reduced mamba2-2.7b and jamba-v0.1-52b on the card against the
   CPU (jamba's dense loop: 4 GLUs, 4 MoE GLUs and one row softmax a call);
18. slice 17, the paper's SGD table fit (``core/fit.py``, no new kernel):
   runs the Fig. 2 fit (gelu, 5 breakpoints on [-2, 2]) twice on the card,
   bitwise alike and within 5% of the CPU's MSE, and prints its time and
   Adam steps; re-fits four shipped pairs through ``gen_tables --fast
   --device cuda --root DIR`` to at most 1.1x their MSE; fits gelu_tanh at
   24 breakpoints on a store's miss and holds that table through the fused
   GLU kernel at M = 4 and 4096; and serves repro-100m under a plan with a
   uniform table and under one at 25 segments (the store's uniform
   fallback, one warning), every GLU on the kernel;
19. slice 18, tables past 64 breakpoints and the guard: every table
   kernel's wide instantiation (tables read from device memory, the search
   over padded breakpoints; the same library as the shared-memory one);
   ``wide_table_phase`` holds every kernel family at 65 and 128
   breakpoints against its plain version, the wide instantiation bitwise
   the shared-memory one at 32, and the GLU digests again; serves
   repro-100m under a 129-segment plan (``mlp`` and ``attn.softmax``
   fused, on the wide kernels); ``guard_phase`` profiles the default
   session guard off (launches a call and tokens the parent's) and on,
   runs ``serve --guard`` and ``serve --chaos 0`` (rc 0, tokens those of
   the fault-free run), and injects a NaN at repro-100m's MLP site and at
   olmoe-1b-7b's expert site (with a kernel failure and a dropped tick),
   each recovered by the degraded re-run, whose GLU is held within
   rounding of the kernel's and whose token changes to the band that one
   ulp at the site opens;
20. slice 19, the per-site plan autotuner and the analytic roofline (no new
   kernel): ``autotune_phase`` holds every fused candidate of each run's
   sweep (the GLU, the MoE GLU and the flash forward with tables of 8, 16,
   32 and 64 breakpoints in f32, bf16, f16 and int8) against its plain
   version at the workload's shape, then runs ``python -m
   repro_torch.launch.autotune`` (in this process) for full-width
   repro-100m with the softmax site (the full sweep, on a fresh cache,
   then again on the warm one: the same plan bytes, no miss), olmoe-1b-7b
   and mamba2-2.7b (``--quick``; ``ssm:silu`` stays exact), each rc 0 with
   every site's choice within its accuracy budget and no slower than the
   baseline, and a report naming the card and its power limit; then
   serves repro-100m under the emitted plan (serve's exit code 0, each
   site's kernels launched where the plan says ``fused`` and not
   elsewhere).  ``roofline_lines`` prints ``repro_torch.roofline``'s model
   FLOPs and ``mfu`` of the 8 x 512 and 1 x 4096 training steps timed
   above, and the default serve session's memory-bound decode time;
21. slice 21, the SSM and encoder-decoder caches under a mesh and the dry
   run (no new kernel): ``shard_shapes_phase`` adds the kernels their
   per-shard bodies launch at a 2 x 2 rank's block of the decode cell
   (mamba2-2.7b's dt softplus on the standalone PWL kernel at 40 of 80
   heads, bitwise; whisper-small's self- and cross-attention row softmax
   at 6 of 12 KV heads); ``dryrun_phase`` runs ``python -m
   repro_torch.launch.dryrun`` in subprocesses on a fake 512-rank process
   group and the meta device, started after the build at the lowest CPU
   priority so that they run beside the kernel phases (repro-100m's four
   shapes on both meshes, mamba2-2.7b, whisper-small, full-width
   jamba-v0.1-52b and qwen2.5-32b's training cell on 2 x 16 x 16), holds
   every row ``ok`` or JAX's SKIP row and the pinned collective counts,
   and prints the report's tables.

Every failed check exits non-zero.  The last two lines of standard output
are the kernels' JSON line and ``{"ok": true, "device": {...}}``; the card's
name and power limit are printed before them.  Needs a CUDA GPU and the
repository around this file; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOP_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
SMS = 132                      # H100 SXM streaming multiprocessors
SM_CLOCK_HZ = 1.98e9           # H100 SXM boost clock (NVIDIA data sheet)
SEARCH_SHARED_LOADS = 6        # shared loads of one breakpoint-search decode
SEARCH_OPS = 9                 # operations of one search decode: 7 compares, a table read, fmaf
K_DIM, N_DIM = 768, 3072       # repro-100m d_model, d_ff
HKV, DH, PS = 12, 64, 16       # repro-100m KV heads, head dim; serve page size
N_LAYERS = 12                  # repro-100m layers
EXP_BP = 32                    # breakpoints of the fused-softmax plan's exp table
TRAIN_BATCH, TRAIN_SEQ = 8, 512  # the train launcher's defaults
TRAIN_TOKENS = TRAIN_BATCH * TRAIN_SEQ
TRAIN_SOFTMAX = f"train {TRAIN_BATCH}x{HKV}x{TRAIN_SEQ} rows x {TRAIN_SEQ} causal"
LONG_BATCH, LONG_SEQ = 1, 4096   # long-context training: 12 x 4096^2 scores, 1.5 x the dense cap
MOE_E, MOE_K, MOE_N = 64, 2048, 1024  # olmoe-1b-7b experts, d_model, expert d_ff
MOE_LAYERS, MOE_HKV, MOE_DH = 16, 16, 128  # olmoe-1b-7b layers, KV heads, head dim
# bucket capacity max(1, int(1.25 T 8 / 64)) of olmoe's calls over T tokens
MOE_CAPACITIES = {1: "decode, 4 slots", 5: "prefill of 32", 40: "prefill of 256",
                  640: "train 8 x 512"}
MOE_TRAIN_C = 640
GEMMA_H, GEMMA_HKV, GEMMA_DH, GEMMA_WINDOW = 4, 1, 256, 512  # gemma3-1b's attention
GEMMA_TRAIN_SEQ = 4096  # gemma3-1b trains at 1 x 4096: 4 x 4096^2 scores fit the dense cap
GEMMA_TRAIN_SOFTMAX = f"gemma3-1b train {GEMMA_H}x{GEMMA_TRAIN_SEQ} rows x {GEMMA_TRAIN_SEQ} causal"
GEMMA_TRAIN_FLASH = f"S=T={GEMMA_TRAIN_SEQ} causal window {GEMMA_WINDOW}"
DECODE_G5 = "qwen2.5-32b G=5 Hkv=8 dh=128 B=4 kv_len {19,32,15,0}"
DECODE_G7 = "internvl2-1b G=7 Hkv=2 dh=64 B=4 kv_len {19,32,15,0}"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn(i)`` call: ``reps`` calls captured into a
    CUDA graph, replayed ``iters`` times between CUDA events, so host launch
    overhead is not in the number.  ``i`` cycles so a caller can rotate its
    operands past the L2 cache."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
        return [n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                for n in out]
    except (OSError, subprocess.SubprocessError):
        return names


def build_phase():
    """Build every CUDA library; print each kernel's registers and spills
    (ptxas) and the count of tensor-core instructions (HMMA) in the SASS
    (``cuobjdump``) of each flash kernel and, summed, of the GLU library,
    which must have some (its bf16 kernel runs on the tensor cores)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    info = _build.build()
    secs = time.perf_counter() - t0
    print(f"[smoke] built {sorted(info)} in {secs:.2f}s (wall, parallel nvcc)")
    for name, rec in sorted(info.items()):
        print(f"[smoke]   {name}: {rec['seconds']:.2f}s cached={rec['cached']}")
        entries, fn, spill = [], None, ""
        for line in rec["log"].splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and fn is not None:
                entries.append((fn, line.split("Used")[1].split(",")[0].strip(), spill))
                fn, spill = None, ""
        for (raw, regs, spill), short in zip(entries, _demangle([e[0] for e in entries])):
            print(f"[smoke]     ptxas {short}: {regs}; {spill}")
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    for name in ("attention", "attention_bwd", "glu"):
        if not cuobjdump.exists():
            print(f"[smoke]   SASS of {name}: cuobjdump not found")
            break
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True, timeout=300).stdout
        funcs = [f.split("\n", 1) for f in sass.split("Function : ")[1:]]
        if name == "glu":  # one line for all of its instantiations
            hmma = sum(body.count('HMMA') for _, body in funcs)
            names = _demangle([f[0].strip() for f in funcs])
            core_bf16 = [n for n in names if "glu_pwl_kernel" in n and "bfloat16" in n]
            print(f"[smoke]   SASS glu: {len(funcs)} kernels, {hmma} HMMA instructions, "
                  f"{len(core_bf16)} bf16 CUDA-core kernels")
            check(hmma > 0, "the GLU library's SASS has no tensor-core (HMMA) instruction")
            check(not core_bf16, f"bf16 CUDA-core GLU kernels in the library: {core_bf16}")
            continue
        shorts = _demangle([f[0].strip() for f in funcs])
        for short, (_, body) in zip(shorts, funcs):
            print(f"[smoke]   SASS {short}: {body.count('HMMA')} HMMA instructions")
    return secs


# ---------------------------------------------------------------------------
# kernel vs plain


def glu_phase(torch):
    """The fused_glu wrapper on CUDA tensors (its kernel) vs its plain
    version at K=768, N=3072, M in {4, 32, 512}, bf16 (1e-2) and f32 with
    TF32 off (1e-4)."""
    from repro_torch import sfu
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.kernels.fused.glu import fused_glu_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    plan, tables = plan_and_operands(table)
    tables = tuple(t.to(dev) for t in tables)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    # a ragged shape first: masking of every edge (M, N and K not multiples)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(37, 65, generator=gen, device=dev).to(dtype)
        wg = (torch.randn(65, 130, generator=gen, device=dev) * 0.2).to(dtype)
        wu = (torch.randn(65, 130, generator=gen, device=dev) * 0.2).to(dtype)
        got = fused_glu(x, wg, wu, table=table)
        want = fused_glu_plain(x, wg, wu, plan, tables)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"fused_glu ragged 37x65x130 {dtype}: max err {err}")
        print(f"[smoke] fused_glu ragged M=37 K=65 N=130 {dtype}: max_abs_err {err:.3g}")

    n_copies = 8  # 8 x 9.4 MB of bf16 weights: more than the 50 MB L2
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        scale = 1.0 / math.sqrt(K_DIM)
        wgs = [(torch.randn(K_DIM, N_DIM, generator=gen, device=dev) * scale).to(dtype)
               for _ in range(n_copies)]
        wus = [(torch.randn(K_DIM, N_DIM, generator=gen, device=dev) * scale).to(dtype)
               for _ in range(n_copies)]
        wcat = [torch.cat([a, b], dim=1) for a, b in zip(wgs, wus)]
        for M in (4, 32, 512, TRAIN_TOKENS):
            x = torch.randn(M, K_DIM, generator=gen, device=dev).to(dtype)
            n0 = fused_glu.launches
            got = fused_glu(x, wgs[0], wus[0], table=table)
            check(fused_glu.launches == n0 + 1, f"fused_glu M={M} {dtype}: kernel not launched")
            want = fused_glu_plain(x, wgs[0], wus[0], plan, tables)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"fused_glu M={M} {dtype}: non-finite")
            check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                  f"fused_glu M={M} {dtype}: max err {err} > {tol}")
            k_ms = time_ms(torch, lambda i: fused_glu(x, wgs[i % n_copies], wus[i % n_copies],
                                                      table=table))
            p_ms = time_ms(torch, lambda i: fused_glu_plain(
                x, wgs[i % n_copies], wus[i % n_copies], plan, tables))
            l_ms = time_ms(torch, lambda i: torch.matmul(x, wcat[i % n_copies]))
            esize = x.element_size()
            nbytes = (M * K_DIM + 2 * K_DIM * N_DIM + M * N_DIM) * esize
            flops = 2 * 2 * M * K_DIM * N_DIM
            peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_PER_S
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
            rows[(M, dtype)] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            print(f"[smoke] fused_glu M={M} K={K_DIM} N={N_DIM} {dtype}: "
                  f"max_abs_err {err:.3g} (tol {tol}), kernel {k_ms * 1e3:.2f} us, "
                  f"plain {p_ms * 1e3:.2f} us, torch.matmul(x, [Wg|Wu]) "
                  f"{l_ms * 1e3:.2f} us, bound {rows[(M, dtype)]['bound_ms'] * 1e3:.2f} us "
                  f"({rows[(M, dtype)]['bound_by']})")
    return rows


def _compare_scaled(torch, got, want, tol, what) -> float:
    """``got`` against ``want`` on the scale of ``want``: max |got - want| at
    most ``tol`` times max |want|.  Returns the max abs error."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    check(err <= tol * scale, f"{what}: max err {err} > {tol} x scale {scale}")
    return err


# The order band: a pre-activation z = x @ w (+ b) summed over K in any order
# lies within ORDER_BAND_C * (K + 1) * 2^-24 * (|x| @ |w| + |b|) of the plain
# f32 version's: the forward error bound K u of an f32 dot product for each
# side, doubled for the tensor cores' truncating adds, so 1 + 2 of the bound
# apart at most, and 4 leaves a margin (tests/test_torch_glu_backward.py
# holds four orders to it on the CPU).  A slope may differ from the plain
# version's only for a z within the band of a breakpoint, and it is then the
# slope of the segment on the breakpoint's other side.
ORDER_BAND_C = 4
MAX_FLIP_SHARE = 1e-3  # elements whose slope is not the plain version's
MAX_BAND_SHARE = 0.2   # within the band: ~4% at K = 768, ~14% at olmoe's K = 2048


def _near_breakpoint(torch, z, tables, band):
    """For each element of ``z``: whether it lies within ``band`` of a
    breakpoint of the table (``tables[0]``), and the nearest breakpoint."""
    bps = tables[0].reshape(-1).float()
    dist = torch.full_like(z, math.inf)
    nearest = torch.zeros_like(z, dtype=torch.long)
    for i, b in enumerate(bps.tolist()):
        d = (z - b).abs()
        closer = d < dist
        dist = torch.where(closer, d, dist)
        nearest = torch.where(closer, i, nearest)
    return dist <= band, bps[nearest]


def _order_band(torch, x, weights, bias, g, got, plan, tables, what,
                max_band: float | None = MAX_BAND_SHARE, parts: bool = False):
    """The backward kernel's slopes against the plain version's, element by
    element: ``got`` is dzg of the GLU (``weights`` (wg, wu)) or dz of the
    linear layer (``weights`` (w,), ``bias``).  An element is marked where
    it differs from g * zu * slope_plain (or g * slope_plain) by more than
    the rounding of zu over the order band and of the products.  Every marked
    element must lie within the order band of a breakpoint of the plain
    pre-activation and take there the slope of one of the breakpoint's two
    segments.  Bounds the marked share by ``MAX_FLIP_SHARE`` and the share
    within the band by ``max_band``.  Returns the mask of the elements
    within the band, which the caller leaves out of its tolerance check, and
    the line to print.  With ``max_band`` None (the widest K, where the band
    grows past ``MAX_BAND_SHARE``) the band's share is not bounded, and the
    mask returned is that of the marked elements alone: every other element,
    in the band or not, takes the plain version's slope and stays in the
    caller's tolerance check.  With ``parts`` it returns the marked mask,
    the band's mask, each element's allowance at the plain version's slope
    (the rounding of zu over the order band and of the products) and the
    line, for ``_compare_flips``."""
    u = 2.0 ** -24
    K = x.shape[-1]
    xf, gf = x.float(), g.float()
    z, mag = [], []
    for i, w in enumerate(weights):
        zi, mi = xf @ w.float(), xf.abs() @ w.float().abs()
        if i == 0 and bias is not None:
            zi, mi = zi + bias.float(), mi + bias.float().abs()
        z.append(zi)
        mag.append(mi)

    def want_and_allow(slope):
        if len(weights) == 1:
            want = gf * slope
            return want, 4 * u * want.abs()
        want = gf * z[1] * slope
        return want, (gf.abs() * slope.abs() * (ORDER_BAND_C * K * u) * mag[1]
                      + 4 * u * want.abs())

    def off(slope):
        want, allow = want_and_allow(slope)
        return (got.float() - want).abs() > allow

    marked = off(plan.apply_value_and_slope(z[0], *tables)[1])
    near, b = _near_breakpoint(torch, z[0], tables, ORDER_BAND_C * (K + 1) * u * mag[0])
    # the breakpoint's own segment (the left one owns it) and the right one
    sides = [plan.apply_value_and_slope(t, *tables)[1]
             for t in (b, torch.nextafter(b, torch.full_like(b, math.inf)))]
    wrong = marked & off(sides[0]) & off(sides[1])
    n = z[0].numel()
    outside, n_wrong = int((marked & ~near).sum()), int(wrong.sum())
    flips, in_band = int(marked.sum()) / n, int(near.sum()) / n
    check(outside == 0, f"{what}: {outside} slopes differ from the plain version's outside "
                        f"the order band of a breakpoint")
    check(n_wrong == 0, f"{what}: {n_wrong} slopes are neither segment's at their breakpoint")
    check(flips <= MAX_FLIP_SHARE and (max_band is None or in_band <= max_band),
          f"{what}: slope mismatch share {flips:.3g}, share within the band {in_band:.3g}")
    line = (f"slope mismatches {flips:.3g} of the elements, each within the order band "
            f"(c = {ORDER_BAND_C}) of a breakpoint with a neighbouring segment's slope; "
            f"the band holds {in_band:.3g}")
    if parts:
        return (marked, near, want_and_allow(plan.apply_value_and_slope(z[0], *tables)[1])[1],
                line + ", the mismatches alone left out of the tolerance, the band's other "
                       "elements held within it plus their allowance")
    if max_band is None:
        return marked, line + ", the mismatches alone left out of the tolerance"
    return near, line + ", left out of the tolerance"


def _compare_flips(torch, got, want, marked, near, allow, tol, what) -> float:
    """dzg against the plain version's with the slope mismatches
    (``marked``: each a neighbouring segment's slope within the order band
    of a breakpoint, as ``_order_band`` checks) left out: every other
    element within ``tol`` times max |want|, and within the band (``near``)
    also within its ``allow``, zu's rounding over the order band times
    |g·slope|, since a flip between two segments whose slopes differ by
    less than that is not marked.  Returns the max abs error of the
    elements held."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got.float() - want.float()).abs().masked_fill(marked, 0.0)
    scale = want.float().abs().max().item()
    over = int((err > tol * scale + torch.where(near, allow, torch.zeros_like(allow))).sum())
    worst = err.max().item()
    check(over == 0, f"{what}: {over} elements past {tol} x scale {scale} (and their "
                     f"allowance within the band); max err {worst}")
    return worst


def _compare_outside(torch, got, want, near, tol, what) -> float:
    """``_compare_scaled`` on the elements outside the order band (``near``
    False), on the scale of all of ``want``."""
    return _compare_scaled(torch, torch.where(near, want.float(), got.float()), want, tol, what)


def glu_bwd_phase(torch):
    """The GLU backward kernel (through ``fused_glu_bwd``, the backward's
    wrapper) vs ``fused_glu_bwd_plain``: ragged M=37 K=65 N=130 and the
    training shape M=4096 K=768 N=3072 (8 x 512 tokens of repro-100m), dzg
    and dzu each held on its own scale, f32 (TF32 off) at 1e-4 and bf16
    operands at 1e-2 outside the order band of a breakpoint, and every
    slope that is not the plain version's within that band, a neighbouring
    segment's (``_order_band``)."""
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.kernels.fused.glu import fused_glu_bwd, fused_glu_bwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, plan, tables = _table(torch, "gelu_tanh")
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = {}
    for M, K, N in ((37, 65, 130), (TRAIN_TOKENS, K_DIM, N_DIM)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            wg = (torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(dtype)
            wu = (torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(dtype)
            g = torch.randn(M, N, generator=gen, device=dev).to(dtype)
            n0 = fused_glu.bwd_launches
            dzg, dzu = fused_glu_bwd(x, wg, wu, g, plan, tables)
            check(fused_glu.bwd_launches == n0 + 1, f"GLU bwd {M}x{K}x{N}: kernel not launched")
            wdzg, wdzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
            torch.cuda.synchronize()
            what = f"GLU bwd M={M} K={K} N={N} {dtype}"
            near, band = torch.zeros_like(wdzg, dtype=torch.bool), ""
            if dtype == torch.bfloat16:
                near, band = _order_band(torch, x, (wg, wu), None, g, dzg, plan, tables, what)
                band = "; " + band
            err = max(_compare_outside(torch, dzg, wdzg, near, tol, f"{what} dzg"),
                      _compare_outside(torch, dzu, wdzu, near, tol, f"{what} dzu"))
            line = (f"[smoke] fused_glu backward M={M} K={K} N={N} {dtype}: max_abs_err "
                    f"{err:.3g}{band}")
            if M == TRAIN_TOKENS and dtype == torch.bfloat16:
                wcat = torch.cat([wg, wu], dim=1)
                k_ms = time_ms(torch, lambda i: fused_glu_bwd(x, wg, wu, g, plan, tables),
                               reps=5, iters=4)
                p_ms = time_ms(torch, lambda i: fused_glu_bwd_plain(x, wg, wu, g, plan, tables),
                               reps=3, iters=3)
                l_ms = time_ms(torch, lambda i: torch.matmul(x, wcat), reps=5, iters=4)
                esize = x.element_size()
                nbytes = (M * K + 2 * K * N + M * N) * esize + 2 * M * N * 4
                rows[(M, dtype)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                    "max_abs_err": err, **_bound(nbytes, 4.0 * M * K * N)}
                line += (f", kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, "
                         f"torch.matmul(x, [Wg|Wu]) {l_ms * 1e3:.1f} us, bound "
                         f"{rows[(M, dtype)]['bound_ms'] * 1e3:.1f} us "
                         f"({rows[(M, dtype)]['bound_by']})")
            print(line)
    return rows


def _table(torch, fn: str):
    """The 32-breakpoint table of ``fn`` (gelu_tanh: repro-100m's mlp site;
    silu: olmoe's moe.expert site; gelu: whisper's), its plan and its
    delta-layout operands on the card."""
    from repro_torch import sfu
    from repro_torch.kernels.fused.epilogue import plan_and_operands

    table = sfu.get_store().get(fn=fn, n_breakpoints=32)
    plan, tables = plan_and_operands(table)
    return table, plan, tuple(t.cuda() for t in tables)


def _moe_bytes(E, C, K, N, esize, f32_outputs=0) -> float:
    """x, both weights and g or the output once each; ``f32_outputs`` more
    (E, C, N) f32 tensors written (the backward's dzg and dzu)."""
    return (E * C * K + 2 * E * K * N + E * C * N) * esize + f32_outputs * E * C * N * 4


# sha256 of the dense GLU's output bytes at glu_digests' inputs, keyed
# "M dtype": f32 as the dense-only GLU kernel of commit 94d8fb7 (before the
# expert axis went in) computed them; bf16 as the tensor-core kernel computes
# them (one summation order in every tile configuration): at M = 32 and 4096
# since it replaced the CUDA-core bf16 kernel of 7183c4b, at M = 4 since its
# decode configuration replaced that kernel's last bf16 use (re-recorded
# then; glu_decode_phase holds a decode row bitwise the same row of an
# M = 32 launch); all on an H100 80GB HBM3 (700 W)
GLU_DIGESTS = {
    "4 bfloat16": "8305f56977201a4f2f91572b7958034d3107a177866be3e5a996e9e3d3aeadf0",
    "4 float32": "902a6b8c678f99214f4eeaa85a941bba6e252277505b81da7c01b085990443d5",
    "32 bfloat16": "0dd46e0295d575a2be762d3e52f81641c4a25172308b8ad2baa514970d3f8e0a",
    "32 float32": "bed1cd64c059e7917e5d0c667b26db8845e383891dfa03a202c4cc91e0bcf25b",
    "4096 bfloat16": "791edd511c87a367c45cea953c1e2d9bf2b33d6dce90608f47ac213ec9169341",
    "4096 float32": "90dbfc5b640997328650a7749240b77bd47a14874d448bff962be163e520737f",
}


def glu_digests(torch, fn=None) -> dict:
    """sha256 of the GLU's output bytes on fixed inputs from numpy's
    generator: repro-100m's GLU (K=768, N=3072, the 32-breakpoint gelu_tanh
    table) at M = 4, 32 and 4096 (a decode step, a prefill, a train step:
    each M takes its own tile config), bf16 and f32.  ``fn(x, wg, wu,
    table)`` computes it, ``fused_glu`` by default."""
    import hashlib

    import numpy as np

    from repro_torch import sfu
    from repro_torch.kernels.fused import fused_glu

    fn = fn or (lambda x, wg, wu, table: fused_glu(x, wg, wu, table=table))
    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    rng = np.random.default_rng(5)
    w = [torch.from_numpy(rng.standard_normal((K_DIM, N_DIM), dtype=np.float32)
                          / math.sqrt(K_DIM)).cuda() for _ in range(2)]
    out = {}
    for M in (4, 32, TRAIN_TOKENS):
        x = torch.from_numpy(rng.standard_normal((M, K_DIM), dtype=np.float32)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            y = fn(x.to(dtype), w[0].to(dtype), w[1].to(dtype), table)
            raw = y.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            out[f"{M} {str(dtype).split('.')[-1]}"] = hashlib.sha256(raw).hexdigest()
    return out


def moe_phase(torch):
    """fused_moe_glu on CUDA tensors (its kernel) vs its plain version: a
    ragged E=3 C=37 K=65 N=130, then olmoe-1b-7b's experts (E=64, K=2048,
    N=1024) at the bucket capacities of its calls (C = 1 at a 4-slot decode
    step, 5 and 40 for 32- and 256-token prefills, 640 for 8 x 512 training
    tokens), bf16 at 1e-2 and f32 (TF32 off) at 1e-4 of the output's max.
    The dense GLU, and the MoE GLU at E = 1, give bitwise the outputs
    recorded in ``GLU_DIGESTS``;
    at E = 64 experts 0, 31 and 63 give bitwise their own E = 1 launch.
    Each bf16 shape is timed beside its bound, the plain version and
    ``torch.bmm(x, [Wg|Wu])``."""
    from repro_torch.kernels.fused import fused_glu, fused_moe_glu
    from repro_torch.kernels.fused.glu import fused_glu_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    table, plan, tables = _table(torch, "silu")
    gen = torch.Generator(device=dev).manual_seed(9)

    dense = glu_digests(torch)
    one = glu_digests(torch, lambda x, wg, wu, t: fused_moe_glu(x[None], wg[None], wu[None],
                                                                table=t)[0])
    for key, want in GLU_DIGESTS.items():
        check(dense[key] == want, f"fused_glu M={key}: output is not bitwise the recorded one")
        check(one[key] == want, f"fused_moe_glu E=1 M={key}: not bitwise the dense GLU's")
    check(sorted(dense) == sorted(GLU_DIGESTS), f"GLU digests of {sorted(dense)}")
    print(f"[smoke] fused_glu and fused_moe_glu E=1 at M in (4, 32, {TRAIN_TOKENS}) bf16/f32: "
          "bitwise the recorded outputs")

    def weights(E, K, N, dtype):
        return tuple((torch.randn(E, K, N, generator=gen, device=dev) / math.sqrt(K)).to(dtype)
                     for _ in range(2))

    def run(x, wg, wu, tol, what):
        n0 = fused_moe_glu.launches
        got = fused_moe_glu(x, wg, wu, table=table)
        check(fused_moe_glu.launches == n0 + 1, f"{what}: kernel not launched")
        want = fused_glu_plain(x, wg, wu, plan, tables)
        torch.cuda.synchronize()
        check(got.dtype == x.dtype and got.shape == want.shape, f"{what}: {got.shape} {got.dtype}")
        return got, _compare_scaled(torch, got, want, tol, what)

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        x = torch.randn(3, 37, 65, generator=gen, device=dev).to(dtype)
        what = f"fused_moe_glu ragged E=3 C=37 K=65 N=130 {dtype}"
        _, err = run(x, *weights(3, 65, 130, dtype), tol, what)
        print(f"[smoke] {what}: max_abs_err {err:.3g} (tol {tol} of the max)")

    rows = {}
    E, K, N = MOE_E, MOE_K, MOE_N
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        wg, wu = weights(E, K, N, dtype)
        wcat = torch.cat([wg, wu], dim=2) if dtype == torch.bfloat16 else None
        for C, call in MOE_CAPACITIES.items():
            x = torch.randn(E, C, K, generator=gen, device=dev).to(dtype)
            what = f"fused_moe_glu E={E} C={C} ({call}) K={K} N={N} {dtype}"
            got, err = run(x, wg, wu, tol, what)
            if C == 40:
                for e in (0, 31, E - 1):
                    alone = fused_moe_glu(x[e:e + 1], wg[e:e + 1], wu[e:e + 1], table=table)
                    check(torch.equal(got[e], alone[0]),
                          f"{what}: expert {e} is not bitwise its own E=1 launch")
            line = f"[smoke] {what}: max_abs_err {err:.3g} (tol {tol} of the max)"
            if wcat is not None:
                reps = 3 if C >= MOE_TRAIN_C else 10
                k_ms = time_ms(torch, lambda i: fused_moe_glu(x, wg, wu, table=table),
                               reps=reps, iters=3)
                p_ms = time_ms(torch, lambda i: fused_glu_plain(x, wg, wu, plan, tables),
                               reps=2, iters=2)
                l_ms = time_ms(torch, lambda i: torch.bmm(x, wcat), reps=reps, iters=3)
                rows[C] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                           **_bound(_moe_bytes(E, C, K, N, 2), 4.0 * E * C * K * N)}
                line += (f", kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, "
                         f"torch.bmm(x, [Wg|Wu]) {l_ms * 1e3:.1f} us, bound "
                         f"{rows[C]['bound_ms'] * 1e3:.1f} us ({rows[C]['bound_by']})")
            print(line)
        del wg, wu, wcat
    return rows


DECODE_M = 16  # csrc/glu.cu tc::DECODE_M: the bf16 GLU family's decode configurations


def glu_decode_phase(torch):
    """The bf16 GLU family's decode configurations (M <= DECODE_M) in the
    tensor-core kernel's one summation order: for the dense GLU (K = 768,
    N = 3072, gelu_tanh), the MoE GLU at E = 1 and E = 64 (olmoe's K = 2048,
    N = 1024, silu) and the linear layer (K = 768, N = 3072, gelu, with and
    without its bias), under the function's 32-breakpoint table, the exact
    function and the identity, forward and backward (dzg, dzu; dz), the rows
    of a launch at M rows are bitwise the same rows inside a launch at
    M = 32 (the Small tile); also on a ragged M = 3, K = 65, N = 130 (the
    dense GLU and the linear layer)."""
    from repro_torch.kernels.fused import fused_glu, fused_linear, fused_moe_glu
    from repro_torch.kernels.fused.epilogue import device_operands
    from repro_torch.kernels.fused.glu import fused_glu_bwd
    from repro_torch.kernels.fused.linear import fused_linear_bwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    n_checks = 0
    rows = (1, 2, 3, 4, 5, 8, DECODE_M)
    cases = [  # (what, fn, lead, K, N, rows)
        ("fused_glu", "gelu_tanh", (), K_DIM, N_DIM, rows),
        ("fused_moe_glu E=1", "silu", (1,), MOE_K, MOE_N, rows),
        ("fused_moe_glu E=64", "silu", (MOE_E,), MOE_K, MOE_N, (1, 5, DECODE_M)),
        ("fused_linear", "gelu", None, K_DIM, N_DIM, rows),
        ("fused_glu ragged", "gelu_tanh", (), 65, 130, (3,)),
        ("fused_linear ragged", "gelu", None, 65, 130, (3,)),
    ]
    for what, fn, lead, K, N, rows in cases:
        x32 = rnd(*(lead or ()), 32, K)
        g32 = rnd(*(lead or ()), 32, N)
        if lead is None:
            w, b = rnd(K, N, scale=K ** -0.5), rnd(N, scale=0.1)
        else:
            wg, wu = rnd(*lead, K, N, scale=K ** -0.5), rnd(*lead, K, N, scale=K ** -0.5)
        for ep in (f"{fn} PWL f32", f"exact {fn}", "identity"):
            kw = _epilogue_kwargs(ep)
            plan, tables = device_operands(kw.get("table"), kw.get("act"), "cuda")
            if lead is None:
                runs = [(f"{what} {bias}", lambda x, g, bb=bb: [
                    fused_linear(x, w, bb, **kw), fused_linear_bwd(x, w, bb, g, plan, tables)])
                    for bias, bb in (("bias", b), ("no bias", None))]
            else:
                glu = fused_moe_glu if lead else fused_glu
                runs = [(what, lambda x, g: [glu(x, wg, wu, **kw),
                                             *fused_glu_bwd(x, wg, wu, g, plan, tables)])]
            for name, run in runs:
                want = run(x32, g32)
                for M in rows:
                    got = run(x32[..., :M, :], g32[..., :M, :])
                    for i, (a, w_) in enumerate(zip(got, want)):
                        _bitwise(torch, a, w_[..., :M, :].contiguous(),
                                 f"{name} {ep} M={M} output {i} against the M=32 launch's rows")
                        n_checks += 1
    print(f"[smoke] bf16 GLU family at M <= {DECODE_M} (dense GLU, MoE GLU E=1 and E=64, linear "
          f"with and without bias; table, exact, identity; forward and backward; ragged "
          f"3 x 65 x 130): {n_checks} outputs bitwise the same rows of an M=32 launch")


def moe_skip_phase(torch):
    """The decode configuration's empty-bucket skip at olmoe's widths (E = 64,
    C = 1, K = 2048, N = 1024, bf16): every other bucket zeroed (bucket 1 in
    -0), under the silu table, exact silu and the identity, forward and
    backward: every non-empty bucket is bitwise the same expert's output from
    a launch with no bucket zeroed, and every empty one bitwise what the
    host's epilogue gives on +0 accumulators (act(+0)·(+0); dzg = g·0·act'(0),
    dzu = g·act(0)); the forward output is within 1e-2 of the plain version
    (of its max).  Under the table the forward is timed beside its bound (the
    non-empty experts' weights), the plain version and ``torch.bmm``."""
    from repro_torch.kernels.fused import fused_moe_glu
    from repro_torch.kernels.fused.glu import fused_glu_bwd, fused_glu_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    E, K, N, bf = MOE_E, MOE_K, MOE_N, torch.bfloat16
    wg, wu = ((torch.randn(E, K, N, generator=gen, device=dev) / math.sqrt(K)).to(bf)
              for _ in range(2))
    x = torch.randn(E, 1, K, generator=gen, device=dev).to(bf)
    g = torch.randn(E, 1, N, generator=gen, device=dev).to(bf)
    xz = x.clone()
    xz[1::2] = 0.0
    xz[1] = -0.0
    check(bool(torch.signbit(xz[1].float()).all()), "bucket 1 must hold -0")
    live = torch.arange(E, device=dev) % 2 == 0
    n_live = int(live.sum())
    rows = {}
    for ep in ("silu PWL f32", "exact silu", "identity"):
        kw = _epilogue_kwargs(ep)
        (pplan, ptables), (plan, tables) = _epilogue_operands(torch, kw)

        def run(xx):
            return [fused_moe_glu(xx, wg, wu, **kw),
                    *fused_glu_bwd(xx, wg, wu, g, plan, tables, counter=fused_moe_glu)]

        n0 = fused_moe_glu.launches
        full, part = run(x), run(xz)
        check(fused_moe_glu.launches == n0 + 2, f"fused_moe_glu {ep}: kernel not launched")
        zero = torch.zeros(E - n_live, 1, N, device=dev)
        act, slope = pplan.apply_value_and_slope(zero, *ptables)
        gd = g[~live].float()
        host = [(act * zero).to(bf), gd * zero * slope, gd * act]
        for i, (p_, f_, h_) in enumerate(zip(part, full, host)):
            what = f"fused_moe_glu skip E={E} C=1 {ep} output {i}"
            _bitwise(torch, p_[live], f_[live], f"{what}: non-empty buckets")
            _bitwise(torch, p_[~live], h_, f"{what}: empty buckets")
        err = _compare_scaled(torch, part[0], fused_glu_plain(xz, wg, wu, pplan, ptables), 1e-2,
                              f"fused_moe_glu skip {ep} against the plain version")
        line = (f"[smoke] fused_moe_glu E={E} C=1 {ep}, {n_live} of {E} buckets non-empty (one "
                f"in -0): non-empty buckets bitwise the full launch's, empty ones bitwise "
                f"act(+0)*(+0) and (g*0*act'(0), g*act(0)); forward max_abs_err {err:.3g}")
        if ep == "silu PWL f32":
            wcat = torch.cat([wg, wu], dim=2)
            k_ms = time_ms(torch, lambda i: fused_moe_glu(xz, wg, wu, **kw), reps=10, iters=3)
            f_ms = time_ms(torch, lambda i: fused_moe_glu(x, wg, wu, **kw), reps=10, iters=3)
            p_ms = time_ms(torch, lambda i: fused_glu_plain(xz, wg, wu, pplan, ptables),
                           reps=2, iters=2)
            l_ms = time_ms(torch, lambda i: torch.bmm(xz, wcat), reps=10, iters=3)
            nbytes = (E * K + 2 * n_live * K * N + E * N) * 2  # x read, live weights, output
            rows[f"C=1, {n_live} of {E} buckets non-empty"] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                "full_ms": f_ms, **_bound(nbytes, 4.0 * n_live * K * N)}
            r = rows[f"C=1, {n_live} of {E} buckets non-empty"]
            line += (f"; kernel {k_ms * 1e3:.1f} us (every bucket full: {f_ms * 1e3:.1f} us), "
                     f"plain {p_ms * 1e3:.1f} us, torch.bmm(x, [Wg|Wu]) {l_ms * 1e3:.1f} us, "
                     f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
            del wcat
        print(line)
    return rows


@contextlib.contextmanager
def _bucket_census(torch):
    """While the block runs, counts on the card the non-empty buckets (a row
    not all +-0) of every MoE GLU forward launch at bucket capacity 1
    (olmoe's decode steps of up to 12 slots): yields a dict whose "calls" and
    "live" (a device tensor, or None) the caller reads after it."""
    from repro_torch.kernels.fused import glu as G

    launch, seen = G._launch_forward, {"calls": 0, "live": None}

    def census(what, x, wg, wu, plan, tables):
        if what == "fused_moe_glu" and x.shape[1] == 1:
            n = (x != 0).flatten(1).any(dim=1).sum()
            seen["live"] = n if seen["live"] is None else seen["live"] + n
            seen["calls"] += 1
        return launch(what, x, wg, wu, plan, tables)

    G._launch_forward = census
    try:
        yield seen
    finally:
        G._launch_forward = launch


def moe_bwd_phase(torch):
    """The MoE GLU's backward kernel (through ``fused_glu_bwd`` counted on
    ``fused_moe_glu``) vs ``fused_glu_bwd_plain``: ragged E=3 C=37 K=65 N=130 and olmoe's
    experts at the training capacity C = 640, dzg and dzu each on its own
    scale, f32 (TF32 off) at 1e-4 and bf16 at 1e-2.  The f32 inputs lie on
    an integer grid (``_igrid``), so every product is an exact f32 sum in
    any order: a pre-activation within a rounding of a breakpoint would
    otherwise take the neighbouring segment's slope in one of the two
    orders (a jump of up to 0.087 in silu's table), which no tolerance
    separates from a fault.  The bf16 inputs are normal: they are held at
    1e-2 outside the order band of a breakpoint, and every slope that is not
    the plain version's lies within that band, a neighbouring segment's
    (``_order_band``).  At C = 640 in bf16 the kernel is timed
    beside its bound, the plain version and ``torch.autograd.grad`` of
    ``torch.bmm(x, [Wg|Wu])``, forward included."""
    from repro_torch.kernels.fused import fused_moe_glu
    from repro_torch.kernels.fused.glu import fused_glu_bwd, fused_glu_bwd_plain

    def fused_moe_glu_bwd(*operands):
        return fused_glu_bwd(*operands, counter=fused_moe_glu)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, plan, tables = _table(torch, "silu")
    gen = torch.Generator(device=dev).manual_seed(10)

    def inputs(E, C, K, N, dtype):
        if dtype == torch.float32:
            return (_igrid(torch, gen, (E, C, K), dtype),
                    _igrid(torch, gen, (E, K, N), dtype, span=2, step=2.0 ** -7),
                    _igrid(torch, gen, (E, K, N), dtype, span=2, step=2.0 ** -7),
                    _igrid(torch, gen, (E, C, N), dtype))
        s = 1.0 / math.sqrt(K)
        return (torch.randn(E, C, K, generator=gen, device=dev).to(dtype),
                (torch.randn(E, K, N, generator=gen, device=dev) * s).to(dtype),
                (torch.randn(E, K, N, generator=gen, device=dev) * s).to(dtype),
                torch.randn(E, C, N, generator=gen, device=dev).to(dtype))

    rows = {}
    for E, C, K, N in ((3, 37, 65, 130), (MOE_E, MOE_TRAIN_C, MOE_K, MOE_N)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            x, wg, wu, g = inputs(E, C, K, N, dtype)
            what = f"fused_moe_glu backward E={E} C={C} K={K} N={N} {dtype}"
            n0 = fused_moe_glu.bwd_launches
            dzg, dzu = fused_moe_glu_bwd(x, wg, wu, g, plan, tables)
            check(fused_moe_glu.bwd_launches == n0 + 1, f"{what}: kernel not launched")
            wdzg, wdzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
            torch.cuda.synchronize()
            near, band = torch.zeros_like(wdzg, dtype=torch.bool), ""
            if dtype == torch.bfloat16:
                near, band = _order_band(torch, x, (wg, wu), None, g, dzg, plan, tables, what)
                band = "; " + band
            err = max(_compare_outside(torch, dzg, wdzg, near, tol, f"{what} dzg"),
                      _compare_outside(torch, dzu, wdzu, near, tol, f"{what} dzu"))
            line = f"[smoke] {what}: max_abs_err {err:.3g} (tol {tol} of each max){band}"
            if C == MOE_TRAIN_C and dtype == torch.bfloat16:
                xr = x.clone().requires_grad_(True)
                wcat = torch.cat([wg, wu], dim=2).requires_grad_(True)
                gcat = torch.cat([g, g], dim=2)

                def library(i):
                    return torch.autograd.grad(torch.bmm(xr, wcat), (xr, wcat), gcat)

                k_ms = time_ms(torch, lambda i: fused_moe_glu_bwd(x, wg, wu, g, plan, tables),
                               reps=3, iters=3)
                p_ms = time_ms(torch, lambda i: fused_glu_bwd_plain(
                    x, wg, wu, g, plan, tables), reps=2, iters=2)
                l_ms = time_ms(torch, library, reps=3, iters=3)
                rows[C] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                           **_bound(_moe_bytes(E, C, K, N, 2, f32_outputs=2),
                                    4.0 * E * C * K * N)}
                line += (f", kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, autograd of "
                         f"torch.bmm(x, [Wg|Wu]) (fwd+bwd) {l_ms * 1e3:.1f} us, bound "
                         f"{rows[C]['bound_ms'] * 1e3:.1f} us ({rows[C]['bound_by']})")
            print(line)
    return rows


def _softmax_gate_band(torch, x2, mask2, g2, plan, tables):
    """Where the row softmax's backward kernel may rightly differ from its
    plain version: the kernel forms the decoded exp m·s + q in one fmaf,
    the plain version in two roundings (``csrc/pwl_decode.cuh``), so where
    that value lies within a rounding of 0 (a segment of the table crossing
    0: just right of the exp table's first breakpoint, where the flat left
    tail meets the first sloped segment) the gate of max(pwl, 0), 0 / 0.5 /
    1, may flip, and with it that score's dt = du·slope, and dm = -sum(dt)
    at the row's argmax.  Returns
    the (R, N) allowance, |du·slope| at such a score and their sum over the
    row at the argmax ties, and the count of such scores.  The other
    entries get none."""
    from repro_torch.kernels.fused.softmax import NEG_FILL, SHIFT_CLAMP

    live = mask2 > 0
    xm = torch.where(live, x2, NEG_FILL)
    m = xm.amax(dim=-1, keepdim=True)
    s = torch.clamp(xm - m, min=SHIFT_CLAMP)
    val, slope = plan.apply_value_and_slope(s, *tables)
    near0 = live & (slope != 0) & (val.abs() <= 2.0 ** -22 * (slope * s).abs())
    u = torch.clamp(val, min=0.0) * mask2
    L = torch.clamp(u.sum(dim=-1, keepdim=True), min=1e-30)
    du = g2 / L - (g2 * u).sum(dim=-1, keepdim=True) / (L * L)
    flip = torch.where(near0, (du * slope).abs(), 0.0)
    argmax = live & (xm == m)
    extra = flip + torch.where(argmax, flip.sum(dim=-1, keepdim=True), 0.0)
    return extra, int(near0.sum())


def _compare_rows(torch, got, want, live, tol, what, extra=None) -> float:
    """Gradient rows on their own scale: in each row max |got - want| at most
    ``tol`` times that row's max |want| (plus ``extra``, an (R, N) allowance,
    where given), and every entry outside ``live`` exactly 0.  Returns the
    max abs error."""
    N = got.shape[-1]
    g, w = got.float().reshape(-1, N), want.float().reshape(-1, N)
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    diff = (g - w).abs()
    err = diff.amax(dim=-1)
    scale = w.abs().amax(dim=-1)
    allow = (tol * scale)[:, None]
    if extra is not None:
        allow = allow + extra.reshape(-1, N)
    bad = int((diff > allow).any(dim=-1).sum())
    check(bad == 0, f"{what}: {bad} rows off by more than {tol} of their scale "
          f"(worst ratio {(err / scale.clamp(min=1e-30)).max().item():.3g})")
    check(not bool(g[~live].any()), f"{what}: a masked entry has a nonzero gradient")
    return err.max().item()


def softmax_bwd_phase(torch):
    """The row-softmax backward kernel (through ``fused_pwl_softmax`` under
    autograd) vs ``fused_pwl_softmax_bwd_plain``, f32, each row at 1e-5 of
    its scale: the training rows (8 x 12 heads x 512 queries, 512 keys,
    causal), a {0, 1} mask over rows of 2048 (two blocks a row), rows whose
    max is tied three ways, and 48 rows of 32768 (a cluster of 8 blocks a
    row) under a prefix mask with three-way ties, whose last 12 rows are
    wholly masked.  An all-masked row's dx is the plain version's, NaN where
    it is NaN (the VJP's gl * 0 / L^2 is 0 / 0 there, in the JAX package
    too), and equal elsewhere.  Slice 15 adds gemma3-1b's global layers at
    1 x 4096 training (4 x 4096 rows of 4096, causal), also with the 512
    window, both timed; there a score whose decoded exp lies within one
    rounding of 0 may take the other gate (``_softmax_gate_band``; 1 to 2
    rows in 16384 need it)."""
    from repro_torch.kernels.fused import fused_pwl_softmax
    from repro_torch.kernels.fused.softmax import (
        _split_plan,
        fused_pwl_softmax_bwd,
        fused_pwl_softmax_bwd_plain,
        static_mask,
    )

    dev = torch.device("cuda")
    table, plan, tables = _exp_table(torch)
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    train = TRAIN_SOFTMAX
    gemma = (1, GEMMA_H, GEMMA_HKV, GEMMA_TRAIN_SEQ, GEMMA_TRAIN_SEQ)
    cases = [  # (name, score shape, kwargs)
        (train, (B, 1, HKV, S, S), {"causal": True}),
        ("96 rows x 2048 mask", (8, HKV, 2048), {"mask": True}),
        ("512 rows x 512 three-way argmax ties", (512, 512), {"ties": True}),
        ("48 x 32768 mask, three-way ties, 12 rows all masked", (4, HKV, 32768),
         {"ties": True, "lens": [32768, 20000, 5, 0]}),
        (GEMMA_TRAIN_SOFTMAX, gemma, {"causal": True}),
        (GEMMA_TRAIN_SOFTMAX + f" window {GEMMA_WINDOW}", gemma,
         {"causal": True, "window": GEMMA_WINDOW}),
    ]
    timed = (train, GEMMA_TRAIN_SOFTMAX, GEMMA_TRAIN_SOFTMAX + f" window {GEMMA_WINDOW}")
    rows = {}
    for name, shape, kw in cases:
        x = torch.randn(shape, generator=gen, device=dev) * 3.0
        N = shape[-1]
        fkw = {}
        if kw.get("ties"):
            x[..., :3] = x.amax(dim=-1, keepdim=True) + 1.0
        if kw.get("mask"):
            fkw["mask"] = torch.rand(shape, generator=gen, device=dev) > 0.3
            fkw["mask"][..., 0] = True  # no row is wholly masked
            mask2 = fkw["mask"].reshape(-1, N).to(torch.float32)
        elif kw.get("lens"):
            lens = torch.tensor(kw["lens"], device=dev)
            fkw["mask"] = (torch.arange(N, device=dev)[None, :] < lens[:, None])[:, None, :]
            mask2 = torch.broadcast_to(fkw["mask"], shape).reshape(-1, N).to(torch.float32)
        elif kw.get("causal"):
            fkw = {"causal": True, "window": kw.get("window")}
            mask2 = static_mask(x.numel() // N, N, shape[-2], True, kw.get("window"), device=dev)
        else:
            mask2 = None
        g = torch.randn(shape, generator=gen, device=dev)
        xr = x.clone().requires_grad_(True)
        n0 = fused_pwl_softmax.bwd_launches
        (got,) = torch.autograd.grad(fused_pwl_softmax(xr, table=table, **fkw), xr, g)
        check(fused_pwl_softmax.bwd_launches == n0 + 1, f"softmax bwd {name}: not launched")
        x2, g2 = x.reshape(-1, N), g.reshape(-1, N)
        want = fused_pwl_softmax_bwd_plain(x2, mask2, g2, plan, tables)
        torch.cuda.synchronize()
        live = torch.ones_like(x2, dtype=torch.bool) if mask2 is None else mask2 > 0
        some = live.any(dim=-1)
        got2 = got.reshape(-1, N)
        extra = None
        if name.startswith(GEMMA_TRAIN_SOFTMAX):
            extra, n_zero = _softmax_gate_band(torch, x2, mask2, g2, plan, tables)
            off = ((got2 - want).abs() > 1e-5 * want.abs().amax(dim=-1, keepdim=True)).any(-1)
            band_note = (f"; {n_zero} kept scores decode within a rounding of 0, "
                         f"{int(off.sum())} rows past 1e-5 only there and at the argmax")
            extra = extra[some]
        err = _compare_rows(torch, got2[some], want[some], live[some], 1e-5,
                            f"softmax bwd {name}", extra)
        line = (f"[smoke] fused_pwl_softmax backward {name} (cluster "
                f"{_split_plan(x2.shape[0], N).cluster}): max_abs_err {err:.3g} (row tol 1e-5"
                f"{band_note if extra is not None else ''})")
        if not bool(some.all()):
            _same_or_nan(torch, got2[~some], want[~some], f"softmax bwd {name} all-masked rows")
            line += (f"; {int((~some).sum())} all-masked rows equal to the plain version's "
                     f"(NaN share {torch.isnan(want[~some]).float().mean().item():.3g})")
        if name in timed:
            def library(i):
                return torch.autograd.grad(torch.softmax(xr, dim=-1), xr, g)

            k_ms = time_ms(torch, lambda i: fused_pwl_softmax_bwd(
                x2, None, g2, plan, tables, shape[-2], True, kw.get("window")), reps=5, iters=4)
            p_ms = time_ms(torch, lambda i: fused_pwl_softmax_bwd_plain(
                x2, mask2, g2, plan, tables), reps=2, iters=2)
            l_ms = time_ms(torch, library, reps=5, iters=4)
            n = x.numel()
            nbytes = _softmax_bytes(n, int(live.sum()), n_live_inputs=2, explicit_mask=False)
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                          **_bound(nbytes, 0.0), "decode_ms": _search_decode_ms(int(live.sum()))}
            line += (f", kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, autograd of "
                     f"torch.softmax {l_ms * 1e3:.1f} us, bound {rows[name]['bound_ms'] * 1e3:.1f}"
                     f" us (bytes), search decode {rows[name]['decode_ms'] * 1e3:.1f} us")
        print(line)
    return rows


def _same_or_nan(torch, got, want, what) -> None:
    """``got`` is ``want`` bitwise, NaN where ``want`` is NaN."""
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"{what}: the NaN pattern differs")
    check(torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)),
          f"{what}: differs from the plain version")


def _fragmented_table(n_rows, n_cols, num_pages):
    from repro_torch.serving import PageAllocator

    alloc = PageAllocator(num_pages)
    rows = [[] for _ in range(n_rows)]
    for _ in range(n_cols):
        for r in rows:
            r.extend(alloc.alloc(1))
    for r in rows[::2]:
        alloc.free(r[::-1])
        r.clear()
    for _ in range(n_cols):
        for r in rows[::2]:
            r.extend(alloc.alloc(1))
    return rows


def kv_phase(torch):
    """The page-write kernel (``csrc/kv_cache.cu``) against its plain
    versions, bitwise outside the sentinel page, at the serve shapes (bf16
    pools of one layer): the writes alone at repro-100m's 12 KV heads of dim
    64 and olmoe-1b-7b's 16 of dim 128; the writes that rotate q and k (the
    paged model calls' path) there too, decode B = 4 and prefill 1 x 32, and
    the 2 x 4096 prefill, each timed beside the chain it replaced (the
    positions, two ``rope`` calls and the write alone); and, untimed, GQA at
    head dim 256, f32 pools, q/k/v as strided views of one projection, and
    rows one element past a 16-byte boundary (the scalar instantiation).
    Returns the rows of the kernels line, by name."""
    out = {name: row for name, row in _kv_case(torch, HKV, DH).items()}
    out.update({f"{name}[olmoe]": row for name, row in _kv_case(torch, MOE_HKV, MOE_DH).items()})
    for arch, tag in (("repro-100m", ""), ("olmoe-1b-7b", "[olmoe]")):
        out[f"rope_append_kv_{tag}"] = _rope_case(torch, arch, B=4, S=1)
        out[f"rope_write_prompt_pages_{tag}"] = _rope_case(torch, arch, B=1, S=32)
    out["rope_write_prompt_pages_[2x4096]"] = _rope_case(torch, "repro-100m", B=2, S=4096)
    for kw in ({"H": 4, "hkv": 1, "dh": 256}, {"dtype": torch.float32},
               {"layout": "strided"}, {"layout": "offset"}):
        for B, S in ((4, 1), (1, 32)):
            _rope_case(torch, "repro-100m", B=B, S=S, timed=False, **kw)
    return out


def _kv_case(torch, hkv: int, dh: int) -> dict:
    from repro_torch.serving import kv_cache as KV

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    esize = 2
    out = {}

    # prefill: B=1, a 32-token bucket, pool sized as serve sizes it (4 slots x
    # 4 columns + sentinel = 17 pages), the table fragmented by LIFO reuse
    P = 17
    rows = _fragmented_table(3, 2, P)
    table = torch.tensor([rows[0]], dtype=torch.int32, device=dev)
    S = 32
    kn = torch.randn(1, S, hkv, dh, generator=gen, device=dev).to(dt)
    vn = torch.randn(1, S, hkv, dh, generator=gen, device=dev).to(dt)
    base_k = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(dt)
    base_v = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(dt)
    ka, va, kb, vb = base_k.clone(), base_v.clone(), base_k.clone(), base_v.clone()
    n0 = KV.write_prompt_pages_.launches
    KV.write_prompt_pages_(ka, va, kn, vn, table)
    check(KV.write_prompt_pages_.launches == n0 + 1, f"write_prompt_pages_ dh={dh}: not launched")
    KV.write_prompt_pages_plain(kb, vb, kn, vn, table)
    torch.cuda.synchronize()
    check(torch.equal(ka[:, 1:], kb[:, 1:]) and torch.equal(va[:, 1:], vb[:, 1:]),
          f"write_prompt_pages_ Hkv={hkv} dh={dh}: kernel differs from its plain version")
    check(not torch.equal(ka, base_k), f"write_prompt_pages_ Hkv={hkv} dh={dh} wrote nothing")
    flat = (table[0].long()[:, None] * PS + torch.arange(PS, device=dev)).reshape(-1)
    kn_h = kn[0].permute(1, 0, 2).contiguous()  # (Hkv, S, dh)
    k_ms = time_ms(torch, lambda i: KV.write_prompt_pages_(ka, va, kn, vn, table))
    p_ms = time_ms(torch, lambda i: KV.write_prompt_pages_plain(kb, vb, kn, vn, table))
    l_ms = time_ms(torch, lambda i: (ka.view(hkv, P * PS, dh).index_copy_(1, flat, kn_h),
                                     va.view(hkv, P * PS, dh).index_copy_(1, flat, kn_h)))
    nbytes = 2 * 2 * S * hkv * dh * esize + table.numel() * 4
    out["write_prompt_pages_"] = {
        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": 0.0,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"[smoke] write_prompt_pages_ B=1 S={S} Hkv={hkv} dh={dh} bf16: bitwise ok, "
          f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, index_copy_ "
          f"{l_ms * 1e3:.2f} us, bound {out['write_prompt_pages_']['bound_ms'] * 1e3:.3f} us")

    # decode: 4 slots, one inactive (all-sentinel row, kv_len 0), one append
    # at a page boundary, table width 4 columns
    rows = _fragmented_table(3, 3, P)
    tab = torch.zeros((4, 4), dtype=torch.int32)
    for b, r in enumerate(rows):
        tab[b, :len(r)] = torch.tensor(r)
    tab = tab.to(dev)
    kv_len = torch.tensor([PS + 3, 2 * PS, PS - 1, 0], dtype=torch.int32, device=dev)
    kn = torch.randn(4, 1, hkv, dh, generator=gen, device=dev).to(dt)
    vn = torch.randn(4, 1, hkv, dh, generator=gen, device=dev).to(dt)
    ka, va, kb, vb = base_k.clone(), base_v.clone(), base_k.clone(), base_v.clone()
    n0 = KV.append_kv_.launches
    KV.append_kv_(ka, va, kn, vn, tab, kv_len)
    check(KV.append_kv_.launches == n0 + 1, f"append_kv_ dh={dh}: not launched")
    KV.append_kv_plain(kb, vb, kn, vn, tab, kv_len)
    torch.cuda.synchronize()
    check(torch.equal(ka[:, 1:], kb[:, 1:]) and torch.equal(va[:, 1:], vb[:, 1:]),
          f"append_kv_ Hkv={hkv} dh={dh}: kernel differs from its plain version")
    changed = (ka != base_k).any(dim=3).any(dim=0)[1:]
    check(int(changed.sum()) == 3,
          f"append_kv_ Hkv={hkv} dh={dh} changed {int(changed.sum())} rows, want 3")
    lens = kv_len.long()
    pidx = torch.gather(tab.long(), 1, (lens // PS)[:, None])[:, 0]
    flat = pidx * PS + lens % PS
    kn_h = kn[:, 0].permute(1, 0, 2).contiguous()  # (Hkv, B, dh)
    k_ms = time_ms(torch, lambda i: KV.append_kv_(ka, va, kn, vn, tab, kv_len))
    p_ms = time_ms(torch, lambda i: KV.append_kv_plain(kb, vb, kn, vn, tab, kv_len))
    l_ms = time_ms(torch, lambda i: (ka.view(hkv, P * PS, dh).index_copy_(1, flat, kn_h),
                                     va.view(hkv, P * PS, dh).index_copy_(1, flat, kn_h)))
    nbytes = 2 * 2 * 4 * hkv * dh * esize + 4 * 4 + 4 * 4
    out["append_kv_"] = {
        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": 0.0,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"[smoke] append_kv_ B=4 Hkv={hkv} dh={dh} bf16: bitwise ok, kernel "
          f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, index_copy_ "
          f"{l_ms * 1e3:.2f} us, bound {out['append_kv_']['bound_ms'] * 1e3:.4f} us")
    return out


def _same_bits(torch, a, b) -> bool:
    """Equal bit for bit (NaN payloads and the sign of zero included)."""
    ints = {2: torch.int16, 4: torch.int32}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(ints[a.element_size()]),
                            b.contiguous().view(ints[b.element_size()])))


def _rope_case(torch, arch: str, B: int, S: int, timed: bool = True, H=None, hkv=None,
               dh=None, dtype=None, layout: str = "contiguous") -> dict | None:
    """``rope_append_kv_`` (S = 1) or ``rope_write_prompt_pages_`` against its
    plain version on the card (torch's rotation on the same tables, then the
    plain write): q, the prefill's k and the pools outside page 0 bitwise,
    and the same as the chain of the paged calls before the fusion (the
    positions, ``rope`` of q and of k, then the write alone).  ``layout``
    "strided" takes q, k, v as views of one (B, S, H + 2 Hkv, dh) projection,
    "offset" as rows one element past a 16-byte boundary.  Timed: kernel,
    plain version and chain, with the byte bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.serving import kv_cache as KV

    cfg = get_config(arch)
    H, hkv, dh = H or cfg.n_heads, hkv or cfg.n_kv_heads, dh or cfg.resolved_head_dim
    dt = dtype or torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2 + S)
    decode = S == 1
    # decode: 4 slots, the last inactive (all-sentinel row, kv_len 0), one
    # append at a page boundary; prefill: S / 16 pages a request.  Tables
    # fragmented by LIFO reuse.
    check(not decode or B == 4, "the decode case has 4 slots")
    n_cols = 4 if decode else S // PS
    P = (B + 1) * n_cols + 1
    rows = _fragmented_table(3, 3, P) if decode else _fragmented_table(max(B, 2), n_cols, P)
    tab = torch.zeros((B, n_cols), dtype=torch.int32)
    for b in range(B - 1 if decode else B):
        tab[b, :len(rows[b])] = torch.tensor(rows[b])
    tab = tab.to(dev)
    kv_len = torch.tensor([PS + 3, 2 * PS, PS - 1, 0], dtype=torch.int32, device=dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    if layout == "strided":
        qkv = rnd(B, S, H + 2 * hkv, dh)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + hkv], qkv[:, :, H + hkv:]
    elif layout == "offset":
        q, k, v = (rnd(B * S * n * dh + 1)[1:].view(B, S, n, dh) for n in (H, hkv, hkv))
    else:
        q, k, v = rnd(B, S, H, dh), rnd(B, S, hkv, dh), rnd(B, S, hkv, dh)
    base_k, base_v = rnd(hkv, P, PS, dh), rnd(hkv, P, PS, dh)
    positions = (kv_len[:, None] if decode
                 else torch.arange(S, device=dev)[None, :].expand(B, S))
    cos, sin = L.rope_tables(positions, dh, cfg.rope_theta)
    ka, va, kb, vb = base_k.clone(), base_v.clone(), base_k.clone(), base_v.clone()
    what = (f"rope_{'append_kv_' if decode else 'write_prompt_pages_'} B={B} S={S} H={H} "
            f"Hkv={hkv} dh={dh} {str(dt).split('.')[-1]} {layout}")
    if decode:
        def kernel(i):
            return (KV.rope_append_kv_(q, k, v, ka, va, tab, kv_len, cos, sin),)

        def plain(i):
            return (KV.rope_append_kv_plain(q, k, v, kb, vb, tab, kv_len, cos, sin),)

        def chain(i):  # the paged decode before the fusion: positions, rope, rope, append
            pos = (kv_len[:, None] + torch.arange(1, device=dev)[None, :]).expand(B, 1)
            qr, kr = L.rope(q, pos, cfg.rope_theta), L.rope(k, pos, cfg.rope_theta)
            KV.append_kv_(kb, vb, kr, v, tab, kv_len)
            return (qr,)
        counter = KV.rope_append_kv_
    else:
        def kernel(i):
            return KV.rope_write_prompt_pages_(q, k, v, ka, va, tab, cos, sin)

        def plain(i):
            return KV.rope_write_prompt_pages_plain(q, k, v, kb, vb, tab, cos, sin)

        def chain(i):  # the paged prefill before the fusion
            pos = (torch.arange(S, device=dev)[None, :] + 0).expand(B, S)
            qr, kr = L.rope(q, pos, cfg.rope_theta), L.rope(k, pos, cfg.rope_theta)
            KV.write_prompt_pages_(kb, vb, kr, v, tab)
            return qr, kr
        counter = KV.rope_write_prompt_pages_
    n0 = counter.launches
    got = kernel(0)
    check(counter.launches == n0 + 1, f"{what}: not launched")
    want = plain(0)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("q", "k")):
        check(g.shape == w.shape and g.is_contiguous(), f"{what}: rotated {name} layout")
        check(_same_bits(torch, g, w), f"{what}: rotated {name} differs from the plain version")
    check(_same_bits(torch, ka[:, 1:], kb[:, 1:]) and _same_bits(torch, va[:, 1:], vb[:, 1:]),
          f"{what}: pools differ from the plain version outside page 0")
    check(not torch.equal(ka[:, 1:], base_k[:, 1:]), f"{what}: wrote nothing")
    if decode:
        changed = (ka != base_k).any(dim=3).any(dim=0)[1:]
        check(int(changed.sum()) == B - 1, f"{what}: changed {int(changed.sum())} rows, "
                                           f"want {B - 1}")
    kb.copy_(base_k), vb.copy_(base_v)
    for g, w in zip(chain(0), got):
        check(_same_bits(torch, g, w), f"{what}: differs from the chain it replaced")
    check(_same_bits(torch, ka[:, 1:], kb[:, 1:]) and _same_bits(torch, va[:, 1:], vb[:, 1:]),
          f"{what}: pools differ from the chain it replaced outside page 0")
    if not timed:
        print(f"[smoke] {what}: bitwise the plain version and the chain")
        return None
    k_ms = time_ms(torch, kernel)
    p_ms = time_ms(torch, plain)
    c_ms = time_ms(torch, chain)
    esize = q.element_size()
    n_tok = B * S
    nbytes = (n_tok * (H + 2 * hkv) * dh * esize            # q, k, v read
              + n_tok * (H + (0 if decode else hkv)) * dh * esize  # rotated q (and k) written
              + n_tok * 2 * hkv * dh * esize                # pool rows written
              + 2 * n_tok * (dh // 2) * 4                   # cos, sin read
              + tab.numel() * 4 + (B * 4 if decode else 0))
    row = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "max_abs_err": 0.0,
           "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes", "chain_ms": c_ms,
           "shape": f"B={B} S={S} H={H} Hkv={hkv} dh={dh} bf16"}
    print(f"[smoke] {what}: bitwise the plain version and the chain, kernel "
          f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, chain it replaced "
          f"{c_ms * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.4f} us (bytes)")
    return row


def _exp_table(torch):
    from repro_torch import sfu
    from repro_torch.kernels.fused.epilogue import plan_and_operands

    table = sfu.get_store().get(fn="exp", n_breakpoints=EXP_BP)
    plan, tables = plan_and_operands(table)
    return table, plan, tuple(t.cuda() for t in tables)


def _compare(torch, got, want, tol, what) -> float:
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{what}: max err {err} > {tol}")
    return err


def _compare_probs(torch, got, want, live, tol, what) -> float:
    """Softmax rows on the scale their values have: got * N against
    want * N at ``tol`` (N the row width, so an entry of a uniform row is 1
    and a probability of ~1/N is held to ~tol relative); every entry outside
    ``live`` ((R, N) bool) exactly 0, and every row with a live entry summing
    to 1 at ``tol`` (summed in f64).  Returns the unscaled max abs error."""
    N = got.shape[-1]
    g, w = got.float().reshape(-1, N), want.float().reshape(-1, N)
    _compare(torch, g * N, w * N, tol, f"{what} (scaled by N={N})")
    check(not bool(g[~live].any()), f"{what}: a masked entry is nonzero")
    live_rows = live.any(dim=-1)
    sums = g.double().sum(dim=-1)[live_rows]
    dev = (sums - 1.0).abs().max().item() if sums.numel() else 0.0
    check(dev <= tol, f"{what}: a live row sums to 1 +- {dev} > {tol}")
    return (g - w).abs().max().item()


def _bound(nbytes: float, mma_flops: float) -> dict:
    """The least time for the work: bytes over HBM rate against the products'
    FLOPs over the bf16 tensor-core rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = mma_flops / PEAK_BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _softmax_bytes(n: int, n_live: int, n_live_inputs: int, explicit_mask: bool) -> float:
    """The bytes a row softmax, forward or backward, must move: each f32
    input (x; x and g for the backward) read where the mask keeps a score
    (a masked score's output is 0 whatever it holds), the f32 output written
    in full, and an explicit f32 mask read in full."""
    return 4.0 * (n_live_inputs * n_live + n + (n if explicit_mask else 0))


def _decode_ms(n_scores: float) -> float:
    """CUDA-core time of the linear delta decode alone, ~3 f32 operations per
    breakpoint per score (the paged decode's chain)."""
    return n_scores * 3 * EXP_BP / PEAK_F32_FLOP_PER_S * 1e3


def _search_decode_ms(n_scores: float) -> float:
    """Shared-memory time of the breakpoint search alone (the row softmax's
    and the flash kernels' decode, ``csrc/pwl_decode.cuh``): five shared
    loads of the padded breakpoints and one of the prefix table a score,
    each warp-wide load serving 32 scores, one such load a clock on each SM
    when its lanes hit no bank twice (the search at 32 breakpoints hits one
    at most twice; not counted)."""
    return n_scores * SEARCH_SHARED_LOADS / 32 / (SMS * SM_CLOCK_HZ) * 1e3


def softmax_phase(torch):
    """fused_pwl_softmax on CUDA tensors (its kernel) vs its plain version,
    each row held on the scale of its values (``_compare_probs``): f32 scores
    at 1e-5; bf16 scores, whose bf16 output checks the output cast, at 1e-2
    against the plain version's f32 result on the same scores.  Slice 15
    adds gemma3-1b's global layers at 1 x 4096 training (4 heads x 4096
    rows of 4096, causal; and with its 512 window, the local layers' rows
    when a window covers half the keys)."""
    from repro_torch.kernels.fused import fused_pwl_softmax
    from repro_torch.kernels.fused.softmax import _split_plan, fused_pwl_softmax_plain, static_mask

    dev = torch.device("cuda")
    table, plan, tables = _exp_table(torch)
    gen = torch.Generator(device=dev).manual_seed(3)

    def prefix_mask(lens, width):
        return (torch.arange(width, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None])

    cases = [  # (name, score shape, kwargs, timed)
        ("prefill B=1 12x32 x 32 causal", (1, 1, HKV, 32, 32), {"causal": True}, True),
        ("prefill B=1 12x2048 x 2048 causal", (1, 1, HKV, 2048, 2048), {"causal": True}, True),
        ("dense decode 48 x 48 mask", (4, HKV, 1, 48),
         {"mask": prefix_mask([48, 33, 1, 0], 48)[:, None, None, :]}, False),
        ("ragged 12x300 x 1500 window 128", (1, 1, HKV, 300, 1500), {"window": 128}, False),
        ("ragged 12x33 x 777 causal window 100", (1, 1, HKV, 33, 777),
         {"causal": True, "window": 100}, False),
        ("48 x 32768 mask", (4, HKV, 1, 32768),
         {"mask": prefix_mask([32768, 20000, 5, 0], 32768)[:, None, None, :]}, True),
        (TRAIN_SOFTMAX, (TRAIN_BATCH, 1, HKV, TRAIN_SEQ, TRAIN_SEQ), {"causal": True}, True),
        (WHISPER_CROSS_SOFTMAX, (4, HKV, 1, WHISPER_FRAMES), {}, True),
        ("odd 4x1025 x 1025 causal window 300", (1, 1, 4, 1025, 1025),
         {"causal": True, "window": 300}, False),
        ("odd 4097 x 4097 causal window 1000", (1, 1, 1, 4097, 4097),
         {"causal": True, "window": 1000}, False),
        (GEMMA_TRAIN_SOFTMAX, (1, GEMMA_H, GEMMA_HKV, GEMMA_TRAIN_SEQ, GEMMA_TRAIN_SEQ),
         {"causal": True}, True),
        (GEMMA_TRAIN_SOFTMAX + f" window {GEMMA_WINDOW}",
         (1, GEMMA_H, GEMMA_HKV, GEMMA_TRAIN_SEQ, GEMMA_TRAIN_SEQ),
         {"causal": True, "window": GEMMA_WINDOW}, True),
    ]
    rows = {}
    for name, shape, kw, timed in cases:
        x = torch.randn(shape, generator=gen, device=dev) * 3.0
        N = shape[-1]
        x2 = x.reshape(-1, N)
        if "mask" in kw:
            mask2 = torch.broadcast_to(kw["mask"], shape).reshape(-1, N).to(torch.float32)
        else:
            mask2 = static_mask(x2.shape[0], N, shape[-2], kw.get("causal", False),
                                kw.get("window"), device=dev)
        n0 = fused_pwl_softmax.launches
        got = fused_pwl_softmax(x, table=table, **kw)
        check(fused_pwl_softmax.launches == n0 + 1, f"softmax {name}: kernel not launched")
        want = fused_pwl_softmax_plain(x2, mask2, plan, tables).reshape(shape)
        torch.cuda.synchronize()
        live = mask2 > 0
        err = _compare_probs(torch, got, want, live, 1e-5, f"softmax {name} f32")
        xb = x.to(torch.bfloat16)
        got_b = fused_pwl_softmax(xb, table=table, **kw)
        check(got_b.dtype == torch.bfloat16, f"softmax {name}: bf16 scores gave {got_b.dtype}")
        want_b = fused_pwl_softmax_plain(xb.reshape(-1, N), mask2, plan, tables)
        err_b = _compare_probs(torch, got_b, want_b, live, 1e-2, f"softmax {name} bf16")
        line = f"[smoke] fused_pwl_softmax {name}: max_abs_err f32 {err:.3g}, bf16 {err_b:.3g}"
        if timed:
            k_ms = time_ms(torch, lambda i: fused_pwl_softmax(x, table=table, **kw))
            p_ms = time_ms(torch, lambda i: fused_pwl_softmax_plain(x2, mask2, plan, tables),
                           reps=5, iters=4)
            l_ms = time_ms(torch, lambda i: torch.softmax(x, dim=-1))
            n = x.numel()
            n_live = int(live.sum())
            nbytes = _softmax_bytes(n, n_live, n_live_inputs=1, explicit_mask="mask" in kw)
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                          **_bound(nbytes, 0.0), "decode_ms": _search_decode_ms(n_live),
                          "cluster": _split_plan(x2.shape[0], N).cluster}
            line += (f", kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, torch.softmax "
                     f"{l_ms * 1e3:.2f} us, bound {rows[name]['bound_ms'] * 1e3:.2f} us "
                     f"(bytes), search decode {rows[name]['decode_ms'] * 1e3:.2f} us, "
                     f"cluster {rows[name]['cluster']}")
        print(line)
    return rows


def _decode_sdpa_ms(torch, q, k_pages, v_pages, tab, lens) -> float:
    """The paged decode's yardstick: ``scaled_dot_product_attention`` over
    the K/V gathered into logical order and repeated to the query heads (the
    gather and the repeat not timed), each row masked to its kv_len."""
    import torch.nn.functional as F

    from repro_torch.serving import kv_cache as KV

    G = q.shape[2] // k_pages.shape[0]
    kd, vd = (KV.gather_pages(t, tab).permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              .contiguous() for t in (k_pages, v_pages))
    valid = torch.arange(kd.shape[2], device=q.device)[None, :] < lens[:, None]
    qh = q.permute(0, 2, 1, 3).contiguous()
    return time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=valid[:, None, None, :]))


def decode_phase(torch):
    """paged_flash_decode on CUDA tensors (split + merge kernels) vs its plain
    version on fragmented page tables: bf16 q and pools (bf16 output) at
    1e-2, f32 at 1e-5; repro-100m's head dim 64, and olmoe-1b-7b's decode
    step under the fused-softmax plan (16 KV heads of dim 128, G = 1); slice
    15: qwen2.5-32b's (8 KV heads of dim 128, G = 5, also over two splits)
    and internvl2-1b's (2 of dim 64, G = 7)."""
    from repro_torch.kernels.fused import paged_flash_decode
    from repro_torch.kernels.fused.decoding import paged_flash_decode_plain

    dev = torch.device("cuda")
    table, plan, tables = _exp_table(torch)
    gen = torch.Generator(device=dev).manual_seed(4)

    def make(kv_len, n_cols, hkv, G, P, dtype, dh):
        rows = _fragmented_table(len(kv_len), n_cols, P)
        tab = torch.zeros((len(kv_len), n_cols), dtype=torch.int32)
        for b, r in enumerate(rows):
            tab[b, :len(r)] = torch.tensor(r)
        q = torch.randn(len(kv_len), 1, hkv * G, dh, generator=gen, device=dev).to(dtype)
        kp = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(dtype)
        vp = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(dtype)
        lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        return q, kp, vp, tab.to(dev), lens

    cases = [  # (name, kv_len, n_cols, Hkv, G, pages, pages_per_split, dh, timed)
        ("B=4 kv_len {19,32,15,0}", [19, 32, 15, 0], 4, HKV, 1, 17, None, DH, True),
        ("B=4 one request at 4104 keys (3 splits)", [4104, 0, 37, 2050], 258, HKV, 1, 1033,
         None, DH, True),
        ("G=2 Hkv=6 kv_len {19,32,15,0} 2 pages a split", [19, 32, 15, 0], 4, 6, 2, 17, 2,
         DH, False),
        ("dh=128 Hkv=16 B=4 kv_len {19,32,15,0}", [19, 32, 15, 0], 4, MOE_HKV, 1, 17, None,
         MOE_DH, True),
        (DECODE_G5, [19, 32, 15, 0], 4, 8, 5, 17, None, 128, True),
        (DECODE_G7, [19, 32, 15, 0], 4, 2, 7, 17, None, 64, True),
        ("G=5 Hkv=8 dh=128 one request at 2100 keys (2 splits)", [2100, 0, 37, 19], 132, 8, 5,
         529, None, 128, False),
    ]
    rows = {}
    for name, kv_len, n_cols, hkv, G, P, pps, dh, timed in cases:
        errs = {}
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            q, kp, vp, tab, lens = make(kv_len, n_cols, hkv, G, P, dtype, dh)
            n0 = paged_flash_decode.launches
            got = paged_flash_decode(q, kp, vp, tab, lens, table=table, pages_per_split=pps)
            check(paged_flash_decode.launches == n0 + 1, f"decode {name}: kernel not launched")
            eff = min(pps or 2048 // PS, n_cols)
            want = paged_flash_decode_plain(q, kp, vp, tab, lens, plan, tables, eff)
            torch.cuda.synchronize()
            errs[dtype] = _compare(torch, got, want, tol, f"decode {name} {dtype}")
            empty = [b for b, n in enumerate(kv_len) if n == 0]
            check(not bool(got[empty].any()), f"decode {name}: kv_len 0 is not exact zeros")
        line = (f"[smoke] paged_flash_decode {name}: max_abs_err bf16 "
                f"{errs[torch.bfloat16]:.3g}, f32 {errs[torch.float32]:.3g}")
        if timed:
            q, kp, vp, tab, lens = make(kv_len, n_cols, hkv, G, P, torch.bfloat16, dh)
            eff = min(pps or 2048 // PS, n_cols)
            k_ms = time_ms(torch, lambda i: paged_flash_decode(q, kp, vp, tab, lens, table=table))
            p_ms = time_ms(torch, lambda i: paged_flash_decode_plain(
                q, kp, vp, tab, lens, plan, tables, eff), reps=3, iters=3)
            l_ms = _decode_sdpa_ms(torch, q, kp, vp, tab, lens)
            n_keys = int(lens.sum())
            live_pages = sum(-(-n // PS) for n in kv_len)
            nbytes = (2 * live_pages * PS * dh * hkv * 2 + 2 * q.numel() * 2
                      + tab.numel() * 4 + lens.numel() * 4)
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                          "max_abs_err": errs[torch.bfloat16],
                          **_bound(nbytes, 4.0 * n_keys * hkv * G * dh),
                          "decode_ms": _decode_ms(n_keys * hkv * G)}
            line += (f", kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, SDPA "
                     f"{l_ms * 1e3:.2f} us, bound {rows[name]['bound_ms'] * 1e3:.3f} us "
                     f"({rows[name]['bound_by']})")
        print(line)
    return rows


# bf16 cases of the flash kernels' tensor-core design: the masks of the f32
# cases, whisper's non-causal encoder, and head dims 128, 80 and 208 (a
# multiple of 16 below its instantiation's largest); T not a multiple of 64
# or 512.  (name, B, S, T, H, Hkv, kwargs; "dh" in kwargs, else DH)
BF16_FLASH_CASES = [
    ("S=T=3000 causal H=4", 1, 3000, 3000, 4, 4, {"causal": True}),
    ("S=T=3000 causal window 512 H=4", 1, 3000, 3000, 4, 4, {"causal": True, "window": 512}),
    ("decode rows over T=40000 kv_valid_len {39999, 12345}", 2, 1, 40000, 12, HKV,
     {"causal": False, "kv_valid_len": [39999, 12345]}),
    ("G=2 S=T=1000 causal H=12 Hkv=6", 1, 1000, 1000, 12, 6, {"causal": True}),
    ("G=2 S=300 T=700 kv_valid_len {0, 513} H=4 Hkv=2", 2, 300, 700, 4, 2,
     {"causal": False, "kv_valid_len": [0, 513]}),
    ("S=300 T=700 causal q_offset 400 H=4", 1, 300, 700, 4, 4, {"causal": True, "q_offset": 400}),
    ("whisper encoder S=T=1500 non-causal H=12", 2, 1500, 1500, 12, 12, {"causal": False}),
    ("dh=128 G=2 S=T=700 causal H=4 Hkv=2", 1, 700, 700, 4, 2, {"causal": True, "dh": 128}),
    ("dh=128 S=T=3000 causal window 512 H=2", 1, 3000, 3000, 2, 2,
     {"causal": True, "window": 512, "dh": 128}),
    ("dh=80 S=T=300 causal H=2", 1, 300, 300, 2, 2, {"causal": True, "dh": 80}),
    ("dh=208 S=T=300 causal H=2", 1, 300, 300, 2, 2, {"causal": True, "dh": 208}),
]


def flash_phase(torch):
    """fused_flash_attention on CUDA tensors (its kernel) vs its plain version
    (the same 512-key chain): bf16 at 1e-2 (the tensor-core design, every
    case of ``BF16_FLASH_CASES`` too), f32 at 1e-5."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused import fused_flash_attention
    from repro_torch.kernels.fused.attention import fused_flash_attention_plain

    dev = torch.device("cuda")
    table, plan, tables = _exp_table(torch)
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = [  # (name, B, S, T, H, Hkv, dtype, kwargs, timed)
        ("S=T=4096 causal H=12", 1, 4096, 4096, 12, HKV, torch.bfloat16, {"causal": True}, True),
        ("S=T=4096 causal H=12", 1, 4096, 4096, 12, HKV, torch.float32, {"causal": True}, False),
        ("S=T=3000 causal H=4", 1, 3000, 3000, 4, 4, torch.float32, {"causal": True}, False),
        ("S=T=3000 causal window 512 H=4", 1, 3000, 3000, 4, 4, torch.float32,
         {"causal": True, "window": 512}, False),
        ("decode rows over T=40000 kv_valid_len {39999, 12345}", 2, 1, 40000, 12, HKV,
         torch.float32, {"causal": False, "kv_valid_len": [39999, 12345]}, False),
        ("G=2 S=T=1000 causal H=12 Hkv=6", 1, 1000, 1000, 12, 6, torch.float32,
         {"causal": True}, False),
    ] + [(n, B, S, T, H, hkv, torch.bfloat16, kw, False)
         for n, B, S, T, H, hkv, kw in BF16_FLASH_CASES]
    rows = {}
    for name, B, S, T, H, hkv, dtype, kw, timed in cases:
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        kw = dict(kw)
        dh = kw.pop("dh", DH)
        q = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, T, hkv, dh, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, T, hkv, dh, generator=gen, device=dev).to(dtype)
        if "kv_valid_len" in kw:
            kw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"], device=dev)
        n0 = fused_flash_attention.launches
        got = fused_flash_attention(q, k, v, table=table, **kw)
        check(fused_flash_attention.launches == n0 + 1, f"flash {name}: kernel not launched")
        want, _ = fused_flash_attention_plain(
            q, k, v, plan, tables, causal=kw.get("causal", True), window=kw.get("window"),
            q_offset=kw.get("q_offset", 0), kv_valid_len=kw.get("kv_valid_len"))
        torch.cuda.synchronize()
        err = _compare(torch, got, want, tol, f"flash {name} {dtype}")
        line = f"[smoke] fused_flash_attention {name} {dtype}: max_abs_err {err:.3g} (tol {tol})"
        if timed:
            k_ms = time_ms(torch, lambda i: fused_flash_attention(q, k, v, table=table, **kw),
                           reps=5, iters=4)
            p_ms = time_ms(torch, lambda i: fused_flash_attention_plain(
                q, k, v, plan, tables, causal=True, window=None, q_offset=0,
                kv_valid_len=None), reps=2, iters=2)
            qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
            l_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))
            pairs = B * H * S * (S + 1) / 2
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                          **_bound(nbytes, 4.0 * pairs * DH),
                          "decode_ms": _search_decode_ms(pairs)}
            line += (f", kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, SDPA "
                     f"{l_ms * 1e3:.1f} us, bound {rows[name]['bound_ms'] * 1e3:.1f} us "
                     f"({rows[name]['bound_by']}), search decode "
                     f"{rows[name]['decode_ms'] * 1e3:.1f} us")
        print(line)
    return rows


def _igrid(torch, gen, shape, dtype, span=8, step=0.125):
    """Integer-grid values on the card, exact in bf16: every score and every
    dout . v of dh = 64 such values is an exact f32 sum in any order, so the
    forward kernel's row max is bitwise the plain version's and ties are
    real ties."""
    ints = torch.randint(-span, span + 1, shape, generator=gen, device="cuda")
    return (ints.to(torch.float32) * step).to(dtype)


def _check_raw_ties(torch, q, k, v, dout, causal, window, what) -> dict:
    """The backward kernels recompute every score, and the stats kernel
    counts, for each row, the keys whose recomputed score equals the
    forward's row max m bitwise (``stats[2]``, stored raw).  On random
    inputs, where no integer grid makes every sum exact, each row with a
    live key (m > -1e30) must count at least one: the recompute re-found
    the forward kernel's max.  Under the exp table and the exact exp (the
    two instantiations).  Returns the smallest count of a live row."""
    from repro_torch.kernels.fused import attention as A
    from repro_torch.kernels.fused.epilogue import plan_and_operands

    B, S, H, _ = q.shape
    worst = math.inf
    for name, (plan, tables) in (("exp table", _exp_table(torch)[1:]),
                                 ("exact exp", plan_and_operands(None, "exp"))):
        _, m = A._launch(q, k, v, plan, tables, causal, window, 0, None, True)
        stats = torch.empty((4, B, H, S), dtype=torch.float32, device=q.device)
        A._launch_bwd(q, k, v, dout, m, plan, tables, causal, window, 0, None, stats=stats)
        torch.cuda.synchronize()
        live = m > -1e30
        ntie = stats[2][live]
        lost = int((ntie < 1).sum())
        check(lost == 0, f"{what} {name}: {lost} of {int(live.sum())} live rows count no key "
              "at the forward's row max (a backward score is not the forward's bitwise)")
        low = float(ntie.min())
        worst = min(worst, low)
        print(f"[smoke] {what} {name}: raw tie count >= 1 on all {int(live.sum())} live rows "
              f"(min {low:g}, {int((ntie > 1).sum())} rows with more than one)")
    return {"min_raw_ties": worst}


def flash_bwd_phase(torch):
    """The flash backward kernels (through ``fused_flash_attention_bwd``, the
    backward's wrapper) vs ``fused_flash_attention_bwd_plain`` on the card,
    with m from the forward kernel: the cases of ``flash_phase`` (the bf16
    ones on the tensor-core design), a batch row with ``kv_valid_len`` 0 and
    a causal ``q_offset``; dq, dk and dv each held on its own scale, f32 at
    1e-4 (sums over up to 4096 keys or queries in another order), bf16 at
    1e-2.  Integer-grid inputs (``_igrid``), so the kernel's m must equal
    the plain chain's bitwise; the forward's output with m written must be
    bitwise its output without.  Then random normal bf16 inputs at the long
    train step's shape, where every live row's raw tie count must be at
    least 1 (``_check_raw_ties``).  At
    B = 1, S = T = 4096, H = 12 causal bf16 (the long-context train step's
    shape) one backward must raise the peak of allocated memory by less
    than 1/8 of the dense f32 score tensor, and the kernels, the plain
    version and the autograd of ``scaled_dot_product_attention`` (forward
    included) are timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused import fused_flash_attention
    from repro_torch.kernels.fused import attention as A

    dev = torch.device("cuda")
    table, plan, tables = _exp_table(torch)
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = [  # (name, B, S, T, H, Hkv, dtype, kwargs, timed)
        ("S=T=4096 causal H=12", 1, 4096, 4096, 12, HKV, torch.bfloat16, {"causal": True}, True),
        ("S=T=4096 causal H=12", 1, 4096, 4096, 12, HKV, torch.float32, {"causal": True}, False),
        ("S=T=3000 causal H=4", 1, 3000, 3000, 4, 4, torch.float32, {"causal": True}, False),
        ("S=T=3000 causal window 512 H=4", 1, 3000, 3000, 4, 4, torch.float32,
         {"causal": True, "window": 512}, False),
        ("decode rows over T=40000 kv_valid_len {39999, 12345}", 2, 1, 40000, 12, HKV,
         torch.float32, {"causal": False, "kv_valid_len": [39999, 12345]}, False),
        ("G=2 S=T=1000 causal H=12 Hkv=6", 1, 1000, 1000, 12, 6, torch.float32,
         {"causal": True}, False),
        ("G=2 S=300 T=700 kv_valid_len {0, 513} H=4 Hkv=2", 2, 300, 700, 4, 2, torch.float32,
         {"causal": False, "kv_valid_len": [0, 513]}, False),
        ("G=2 S=300 T=700 kv_valid_len {0, 513} H=4 Hkv=2", 2, 300, 700, 4, 2, torch.bfloat16,
         {"causal": False, "kv_valid_len": [0, 513]}, False),
        ("S=300 T=700 causal q_offset 400 H=4", 1, 300, 700, 4, 4, torch.float32,
         {"causal": True, "q_offset": 400}, False),
    ] + [(n, B, S, T, H, hkv, torch.bfloat16, kw, False)
         for n, B, S, T, H, hkv, kw in BF16_FLASH_CASES
         if n != "G=2 S=300 T=700 kv_valid_len {0, 513} H=4 Hkv=2"]  # above already
    rows = {}
    for name, B, S, T, H, hkv, dtype, kw, timed in cases:
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        kw = {"window": None, "q_offset": 0, "kv_valid_len": None, **kw}
        dh = kw.pop("dh", DH)
        q = _igrid(torch, gen, (B, S, H, dh), dtype)
        k = _igrid(torch, gen, (B, T, hkv, dh), dtype)
        v = _igrid(torch, gen, (B, T, hkv, dh), dtype)
        dout = _igrid(torch, gen, (B, S, H, dh), dtype)
        if kw["kv_valid_len"] is not None:
            kw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"], device=dev)
        args = (kw["causal"], kw["window"], kw["q_offset"], kw["kv_valid_len"])
        what = f"flash bwd {name} {dtype}"
        out_m, m = A._launch(q, k, v, plan, tables, *args, True)
        out = fused_flash_attention(q, k, v, table=table, **kw)
        _, m_plain = A.fused_flash_attention_plain(q, k, v, plan, tables, **kw)
        check(torch.equal(out, out_m), f"{what}: the forward's output changes with m written")
        check(torch.equal(m, m_plain), f"{what}: the kernel's row max is not the plain one's")
        n0 = fused_flash_attention.bwd_launches
        got = A.fused_flash_attention_bwd(q, k, v, dout, m, plan, tables, **kw)
        check(fused_flash_attention.bwd_launches == n0 + 1, f"{what}: kernels not launched")
        want = A.fused_flash_attention_bwd_plain(q, k, v, dout, m, plan, tables, **kw)
        torch.cuda.synchronize()
        errs = [_compare_scaled(torch, g, w, tol, f"{what} d{x}")
                for x, g, w in zip("qkv", got, want)]
        if kw["kv_valid_len"] is not None:
            empty = [b for b, n in enumerate(kw["kv_valid_len"].tolist()) if n == 0]
            check(not any(bool(g[empty].any()) for g in got),
                  f"{what}: a batch row with no valid key has a nonzero gradient")
        line = (f"[smoke] fused_flash_attention backward {name} {dtype}: max_abs_err dq "
                f"{errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (tol {tol} of each max)")
        if timed:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            grads = A.fused_flash_attention_bwd(q, k, v, dout, m, plan, tables, **kw)
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            del grads
            dense = 4 * B * H * S * T
            check(rise < dense / 8, f"{what}: a backward raised peak memory by {rise} bytes, "
                  f"not below 1/8 of the {dense}-byte dense score tensor")
            k_ms = time_ms(torch, lambda i: A.fused_flash_attention_bwd(
                q, k, v, dout, m, plan, tables, **kw), reps=3, iters=3)
            p_ms = time_ms(torch, lambda i: A.fused_flash_attention_bwd_plain(
                q, k, v, dout, m, plan, tables, **kw), reps=1, iters=2)
            qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            doh = dout.permute(0, 2, 1, 3).contiguous()

            def library(i):
                return torch.autograd.grad(
                    F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), (qh, kh, vh),
                    doh)

            l_ms = time_ms(torch, library, reps=5, iters=4)
            pairs = B * H * S * (S + 1) / 2
            nbytes = 7 * q.numel() * q.element_size() + m.numel() * 4
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                          "max_abs_err": max(errs), "peak_rise_bytes": rise,
                          **_bound(nbytes, 10.0 * pairs * DH)}
            # each kernel's own bound, from the products its pass needs over
            # the causal pairs (stats: q.k, dout.v and u.v; dq: q.k, dout.v
            # and ds.k; dkv: q.k, dout.v, u.dout and ds.q) and the bytes it
            # moves (each of q, k, v, dout read once, m and the (4, B, H, S)
            # f32 row stats, its outputs written once; here H = Hkv)
            qb, rb = q.numel() * q.element_size(), m.numel() * 4 * 5
            passes = {"stats": _bound(4 * qb + rb, 6.0 * pairs * DH),
                      "dq": _bound(5 * qb + rb, 6.0 * pairs * DH),
                      "dkv": _bound(6 * qb + rb, 8.0 * pairs * DH)}
            rows[name]["pass_bounds"] = passes
            line += (f", kernels {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, autograd of "
                     f"SDPA (fwd+bwd) {l_ms * 1e3:.1f} us, bound "
                     f"{rows[name]['bound_ms'] * 1e3:.1f} us ({rows[name]['bound_by']}), bound "
                     "of each kernel " + ", ".join(
                         f"{k} {v['bound_ms'] * 1e3:.1f} us ({v['bound_by']})"
                         for k, v in passes.items()) + f", peak "
                     f"memory rise {rise / 1e6:.1f} MB (dense scores {dense / 1e6:.0f} MB)")
        print(line)
    # random normal bf16 at the long-context train step's shape
    q, k, v, dout = (torch.randn(LONG_BATCH, LONG_SEQ, HKV, DH, generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    _check_raw_ties(torch, q, k, v, dout, True, None,
                    f"flash bwd S=T={LONG_SEQ} causal H={HKV} random bf16")
    return rows


# ---------------------------------------------------------------------------
# main path


def _counters() -> dict:
    """Each kernel's launch counter: (wrapper, attribute).  The backward
    kernels count on their forward's wrapper."""
    from repro_torch.kernels import fused, ops
    from repro_torch.serving.kv_cache import (
        append_kv_,
        rope_append_kv_,
        rope_write_prompt_pages_,
        write_prompt_pages_,
    )

    return {"fused_glu": (fused.fused_glu, "launches"),
            "fused_linear": (fused.fused_linear, "launches"),
            "pwl_activation": (ops.pwl_activation, "launches"),
            "pwl_activation_uniform": (ops.pwl_activation_uniform, "launches"),
            "fused_moe_glu": (fused.fused_moe_glu, "launches"),
            "write_prompt_pages_": (write_prompt_pages_, "launches"),
            "append_kv_": (append_kv_, "launches"),
            "rope_write_prompt_pages_": (rope_write_prompt_pages_, "launches"),
            "rope_append_kv_": (rope_append_kv_, "launches"),
            "fused_pwl_softmax": (fused.fused_pwl_softmax, "launches"),
            "paged_flash_decode": (fused.paged_flash_decode, "launches"),
            "fused_flash_attention": (fused.fused_flash_attention, "launches"),
            "fused_rmsnorm": (fused.fused_rmsnorm, "launches"),
            "fused_glu_bwd": (fused.fused_glu, "bwd_launches"),
            "fused_linear_bwd": (fused.fused_linear, "bwd_launches"),
            "fused_moe_glu_bwd": (fused.fused_moe_glu, "bwd_launches"),
            "fused_pwl_softmax_bwd": (fused.fused_pwl_softmax, "bwd_launches"),
            "fused_flash_attention_bwd": (fused.fused_flash_attention, "bwd_launches"),
            "fused_rmsnorm_bwd": (fused.fused_rmsnorm, "bwd_launches")}


def reset_counters():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counters() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


PAGE_WRITES = ("write_prompt_pages_", "append_kv_", "rope_write_prompt_pages_",
               "rope_append_kv_")
FULL_WIDTH = {  # arch: (d_model, layers, experts) of its published config
    "repro-100m": (768, N_LAYERS, 0),
    "olmoe-1b-7b": (MOE_K, MOE_LAYERS, MOE_E),
    "olmo-1b": (2048, 16, 0),
    "stablelm-1.6b": (2048, 24, 0),
    "qwen2.5-32b": (5120, 64, 0),
    "gemma3-1b": (1152, 26, 0),
    "internvl2-1b": (896, 24, 0),
    "mamba2-2.7b": (2560, 64, 0),
}


def serve_phase(torch, argv: list[str], attention, ffn: str | None = None,
                fallback: bool = False, ffn_layers: int | None = None,
                rc0: bool = False) -> dict:
    """One full-width session through the serve entry point; returns the
    launch counts of exactly that session.  ``attention(steps)`` gives the
    expected softmax / paged-decode / flash launches from the session's
    ``{"prefills", "decode_steps", "layers"}`` (the dense loop: one prefill
    and ``max_new`` decode steps).  Every layer of every model call runs its
    FFN's kernel: the GLU for repro-100m, the MoE GLU (and no GLU) for an
    MoE arch, or ``ffn`` (the standalone PWL kernel under an
    ``impl="kernel"`` plan), and no other FFN kernel; ``ffn_layers``, when
    given, is the number of a model call's layers that launch ``ffn`` (0
    for mamba2's empty FFN, whose GLU launches nothing).  Prints tok/s, the
    mean time of a model call and the session's peak of allocated device
    memory (weights included), as serve measures it.  ``fallback``: the
    session asks for the paged cache, which the arch has no layout for, so
    serve must say so on stderr and run its dense loop.  ``rc0``: the exit
    code serve's command line gives the session (``serve.session_rc``: no
    non-finite logits, no fused fallback) must be 0.  Returns the counts
    and, under ``"session"``, tok/s, ms a model call and the peak."""
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    check(args.device == "cuda", "serve must default to cuda")
    cfg = get_config(args.arch)
    check((cfg.d_model, cfg.n_layers, cfg.n_experts) == FULL_WIDTH[args.arch],
          f"not full-width {args.arch}")
    reset_counters()
    err = io.StringIO()
    capture = warnings.catch_warnings(record=True) if rc0 else contextlib.nullcontext([])
    with contextlib.redirect_stderr(err), capture as caught:
        if rc0:
            warnings.simplefilter("always")
        summary = serve.run(args)
    torch.cuda.synchronize()
    counts = read_counters()
    for line in err.getvalue().splitlines():
        print(f"[smoke] serve stderr: {line}")
    if rc0:
        for w in caught:
            print(f"[smoke] serve warning: {w.message}")
        rc = serve.session_rc(summary, caught)
        check(rc == 0, f"serve {' '.join(argv)} would exit {rc}")
    mode = "dense" if fallback else args.mode
    check(summary["mode"] == mode, f"{args.arch}: serve ran {summary['mode']} mode, not {mode}")
    if fallback:
        check(args.mode == "paged" and "[serve] paged cache unsupported (" in err.getvalue()
              and "running dense mode" in err.getvalue(),
              f"{args.arch}: no fallback line on stderr")
    peak = summary["peak_bytes"]
    check(len(summary["results"]) == args.batch, "a request is missing")
    L = cfg.n_layers
    if summary["mode"] == "dense":
        for row in summary["results"]:
            check(len(row) == args.max_new, f"dense row of {len(row)} tokens")
        pf, ds = 1, args.max_new
        check(all(counts[n] == 0 for n in PAGE_WRITES), "the dense loop wrote pages")
    else:
        eng = summary["engine"]
        for r in summary["results"]:
            check(len(r.tokens) == args.max_new and r.finish_reason == "length",
                  f"{r.request_id}: {len(r.tokens)} tokens ({r.finish_reason})")
        check(eng.health_summary()["nonfinite_logits"] == 0, "non-finite logits")
        pf, ds = summary["prefills"], summary["decode_steps"]
        # every layer of every call rotates q and k in its page write
        check(counts["rope_write_prompt_pages_"] == L * pf,
              f"rope_write_prompt_pages_ launches {counts['rope_write_prompt_pages_']} != "
              f"{L} x {pf}")
        check(counts["rope_append_kv_"] == L * ds,
              f"rope_append_kv_ launches {counts['rope_append_kv_']} != {L} x {ds}")
        check(counts["write_prompt_pages_"] == 0 and counts["append_kv_"] == 0,
              "a paged session ran a page write without the rotation")
    ffn = ffn or ("fused_moe_glu" if cfg.n_experts else "fused_glu")
    n_ffn = L if ffn_layers is None else ffn_layers
    check(counts[ffn] == n_ffn * (pf + ds),
          f"{ffn} launches {counts[ffn]} != {n_ffn} x ({pf} + {ds})")
    for other in ("fused_glu", "fused_moe_glu", "fused_linear", "pwl_activation",
                  "pwl_activation_uniform"):
        check(other == ffn or counts[other] == 0,
              f"{args.arch} launched {other} {counts[other]} times")
    for name, want in attention({"prefills": pf, "decode_steps": ds, "layers": L}).items():
        check(counts[name] == want, f"{' '.join(argv)}: {name} launches {counts[name]} != {want}")
    check(all(n == 0 for name, n in counts.items() if name.endswith("_bwd")),
          "serving launched a backward kernel")
    print(f"[smoke] serve {' '.join(argv) or '(defaults)'}: {summary['tokens']} tokens, "
          f"{summary['tok_per_s']:.1f} tok/s, {pf} prefills, {ds} decode steps, "
          f"{summary['seconds'] * 1e3 / (pf + ds):.2f} ms per model call, peak allocated "
          f"{peak / 1e9:.2f} GB, launches {counts}")
    check(peak < torch.cuda.get_device_properties(0).total_memory, "peak past the card")
    return {**counts, "session": {"tok_per_s": summary["tok_per_s"], "peak_bytes": peak,
                                  "ms_per_call": summary["seconds"] * 1e3 / (pf + ds)}}


def no_attention_kernels(steps) -> dict:
    """The default plan leaves the softmax exact: no fused attention kernel."""
    return {"fused_pwl_softmax": 0, "paged_flash_decode": 0, "fused_flash_attention": 0}


def short_prompt_attention(steps) -> dict:
    """A 32-token prefill takes the dense row softmax; decode the split-KV
    kernel (the dense loop's decode the row softmax with a mask)."""
    pf, ds, L = steps["prefills"], steps["decode_steps"], steps["layers"]
    return {"fused_pwl_softmax": L * pf, "paged_flash_decode": L * ds,
            "fused_flash_attention": 0}


def long_prompt_attention(steps) -> dict:
    """A 4096-token prefill is past the dense cap (12 x 4096^2 > 2^27 scores)
    and takes the flash kernel."""
    pf, ds, L = steps["prefills"], steps["decode_steps"], steps["layers"]
    return {"fused_pwl_softmax": 0, "paged_flash_decode": L * ds,
            "fused_flash_attention": L * pf}


def dense_loop_attention(steps) -> dict:
    pf, ds, L = steps["prefills"], steps["decode_steps"], steps["layers"]
    return {"fused_pwl_softmax": L * (pf + ds), "paged_flash_decode": 0,
            "fused_flash_attention": 0}


def dump_plan(path: pathlib.Path, arch: str = "repro-100m", pwl_softmax: bool = True,
              act_impl: str = "fused", table_dtype: str = "f32") -> str:
    """The plan a user would write: every site of ``arch`` at ``act_impl``
    (fused, or the standalone kernel) with tables stored in
    ``table_dtype``, with the PWL-exp softmax or without."""
    from repro_torch import sfu
    from repro_torch.configs import get_config

    plan = sfu.compile_plan(get_config(arch, act_impl=act_impl, pwl_softmax=pwl_softmax,
                                       act_table_dtype=table_dtype))
    check(all(spec.impl == act_impl and spec.dtype == table_dtype for _, spec in plan.items()),
          f"{arch}: a site is not {act_impl} with {table_dtype} tables")
    check(("attn.softmax:exp" in plan) == pwl_softmax, f"{arch}: the softmax site")
    return str(sfu.dump_plan(plan, path))


def _to_cuda(torch, tree):
    """A tree of tensors (dicts and lists) copied to the card."""
    if torch.is_tensor(tree):
        return tree.cuda()
    if isinstance(tree, dict):
        return {k: _to_cuda(torch, v) for k, v in tree.items()}
    return [_to_cuda(torch, v) for v in tree]


def reference_phase(torch):
    """The port on the card against its plain path on the CPU, reduced
    repro-100m in f32 (TF32 off), under the default plan and under the plan
    with the softmax site fused: logits at 1e-4, and paged greedy tokens
    equal to the dense loop's on the card."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.serving import GenRequest, PagedServingEngine

    for pwl_softmax in (False, True):
        cfg = get_reduced_config("repro-100m", act_impl="fused", pwl_softmax=pwl_softmax,
                                 dtype=torch.float32)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        params = cpu.init(seed=0)
        gparams = _to_cuda(torch, params)
        toks = torch.randint(0, cfg.vocab_size, (2, 40),
                             generator=torch.Generator().manual_seed(2))
        want = cpu.forward(params, toks)
        got = gpu.forward(gparams, toks.cuda()).cpu()
        err = (got - want).abs().max().item()
        what = "fused-softmax plan" if pwl_softmax else "default plan"
        check(torch.allclose(got, want, atol=1e-4, rtol=1e-4), f"reduced {what} logits err {err}")
        reqs = [GenRequest(f"r{i}", toks[i, : 9 + 13 * i].tolist(), 6) for i in range(2)]
        eng = PagedServingEngine(gpu, gparams, max_slots=2, page_size=16, max_context=64)
        paged = {r.request_id: r.tokens for r in eng.run(reqs)}
        dense = {r.request_id: generate(gpu, gparams, torch.tensor([r.prompt], device="cuda"),
                                        r.max_new_tokens)[0].tolist() for r in reqs}
        check(paged == dense, f"{what}: paged {paged} != dense {dense}")
        print(f"[smoke] reduced f32, {what}: cuda vs cpu logits max_abs_err {err:.3g}; "
              "paged == dense greedy tokens on cuda")


HELD_OUT_STEP = 10_000  # the data stream's first batch that the held-out loss reads
HELD_OUT_BATCHES = 8      # ... and the 7 after it: the gate holds their mean
HELD_OUT_MIN_DROP = 0.01  # a quarter of the fall the first runs' step losses showed
ORDER_NOISE_FACTOR = 3    # the drop must also pass 3x the loss's spread across orders
LONG_STEPS = 60  # long-context steps: 20 lower the held-out loss by < 0.01 in some GLU orders


@contextlib.contextmanager
def _plain_glu():
    """The plain GLU (``fused_glu_plain`` / ``fused_glu_bwd_plain``, cuBLAS's
    summation order) in place of the GLU kernel launches, in this process,
    for the duration: the other legitimate order the held-out gates hold
    the kernel's against."""
    from repro_torch.kernels.fused import glu as G

    saved = G._launch_forward, G._launch_backward
    G._launch_forward = lambda what, x, wg, wu, plan, tables: G.fused_glu_plain(
        x, wg, wu, plan, tables)
    G._launch_backward = lambda what, x, wg, wu, g, plan, tables: G.fused_glu_bwd_plain(
        x, wg, wu, g, plan, tables)
    try:
        yield
    finally:
        G._launch_forward, G._launch_backward = saved


def _held_out_gate(torch, args, init, trained: list, what: str) -> str:
    """The held-out gate: the mean loss of ``HELD_OUT_BATCHES`` batches that
    no run trains on (the stream's ``HELD_OUT_STEP`` and after), evaluated
    in f32 from the f32 masters, must fall from ``init`` to each parameter
    tree of ``trained`` by ``HELD_OUT_MIN_DROP`` on average, and by more
    than 3 times the evaluation's own spread across legitimate orders: the
    init mean against the mean over each batch's two halves, or, for a
    batch of one, over that batch stacked twice (other GEMM shapes, the
    same function), and against the init mean under the plain GLU.  The model at init turns a one-ulp
    rounding change into a loss change of the gate's size (``ab_flash.py
    --gate``), so one bf16 batch cannot carry it.  Returns the line to
    print."""
    import dataclasses
    import statistics

    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.models import Model

    cfg = train.resolve_config(args)
    model = Model(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))
    held = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(HELD_OUT_STEP + i).items()}
            for i in range(HELD_OUT_BATCHES)]
    half = args.batch // 2

    def loss(params, rows=slice(None), copies=1):
        with torch.no_grad():
            return statistics.fmean(
                float(model.loss(params, {k: torch.cat([v[rows]] * copies)
                                          for k, v in b.items()})[0]) for b in held)

    at_init = loss(init)
    if half:
        other = 0.5 * (loss(init, slice(0, half)) + loss(init, slice(half, None)))
    else:
        other = loss(init, copies=2)
    noise = abs(at_init - other)
    with _plain_glu():
        spread = abs(at_init - loss(init))
    afters = [loss(p) for p in trained]
    drop = at_init - statistics.fmean(afters)
    gate = max(HELD_OUT_MIN_DROP, ORDER_NOISE_FACTOR * max(noise, spread))
    check(math.isfinite(drop) and drop >= gate,
          f"{what} held-out loss {at_init:.6f} -> {afters} (drop {drop:.3g} < {gate:.3g}; "
          f"noise {noise:.3g}, order spread {spread:.3g})")
    return (f"held-out batches {HELD_OUT_STEP}..{HELD_OUT_STEP + HELD_OUT_BATCHES - 1} "
            f"(f32 mean): loss at init {at_init:.6f}, after "
            + ", ".join(f"{a:.6f}" for a in afters) + f", drop {drop:.4f} (gate {gate:.4g}: "
            f"{HELD_OUT_MIN_DROP}, or {ORDER_NOISE_FACTOR} x the evaluation's spread, "
            f"reordered {noise:.3g}, plain GLU {spread:.3g})")


def _restore(torch, args, ckpt_dir: str, step: int):
    """The f32 masters at init (seed 0, as the launcher makes them) and in the
    checkpoint of ``step``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    model = Model(train.resolve_config(args), device="cuda")
    init = adamw.init_state(model.init(seed=0, master=True))
    trained, meta = CheckpointManager(ckpt_dir).restore(step=step, like=init, device="cuda")
    check(int(meta["step"]) == step, f"checkpoint {step} holds step {meta['step']}")
    return init["params"], trained["params"]


def _train_plain(torch, args):
    """The launcher's run of ``args`` (seed 0, its optimizer and schedule, the
    stream's batches from step 0) with the plain GLU in place of the
    kernel: the f32 masters after ``args.steps`` steps."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    cfg = train.resolve_config(args)
    state = adamw.init_state(Model(cfg, device="cuda").init(seed=0, master=True))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5))
    step_fn = build_train_step(cfg, "cuda", opt_cfg=opt_cfg, microbatches=1)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))
    with _plain_glu():
        for step in range(args.steps):
            batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(step).items()}
            state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    return state["params"]


def train_phase(torch, plan: str, ckpt_dir: str) -> dict:
    """Full-width repro-100m through the train entry point on ``cuda`` under
    the fused-softmax plan, at the launcher's defaults (batch 8 x seq 512,
    remat on): 20 steps with a checkpoint every 10, then a resume for 2 more
    from the checkpoint it left.  Checks the exit code (0: the loss fell),
    finite losses, and the launch counts of each run: under remat every layer
    runs its forward twice a step and its backward once, so 24 GLU and 24
    row-softmax forwards and 12 of each backward per step, and no other
    kernel.  The step losses come from different batches, whose own spread
    is about the fall over 20 steps, so the run is also held on batches it
    never trains on: the checkpoint of step 20 must pass ``_held_out_gate``.
    Returns the counts, the median step time and tokens/s of the 20-step
    run."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    def parse(steps):
        args = train.build_parser().parse_args(
            ["--arch", "repro-100m", "--steps", str(steps), "--plan", plan,
             "--ckpt-dir", ckpt_dir, "--ckpt-every", "10", "--log-every", "5"])
        check(args.device == "cuda" and (args.batch, args.seq) == (TRAIN_BATCH, TRAIN_SEQ),
              "train must default to cuda at batch 8 x seq 512")
        return args

    def run(steps):
        reset_counters()
        out = train.run(parse(steps))
        torch.cuda.synchronize()
        return out, read_counters()

    cfg = get_config("repro-100m")
    check(cfg.d_model == 768 and cfg.n_layers == N_LAYERS and cfg.remat,
          "not full-width repro-100m with remat")
    out, counts = run(20)
    check(out["rc"] == 0, f"train rc {out['rc']}: losses {out['losses']}")
    check(len(out["losses"]) == 20 and all(math.isfinite(x) for x in out["losses"]),
          f"train losses {out['losses']}")
    _check_train_counts(counts, 20, "train 20 steps")
    med = statistics.median(out["step_seconds"])
    tok_s = out["tokens_per_step"] / med
    print(f"[smoke] train repro-100m --plan <fused softmax> 20 steps: loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, median step "
          f"{med * 1e3:.1f} ms ({tok_s:.0f} tokens/s), first step "
          f"{out['step_seconds'][0] * 1e3:.1f} ms, launches {counts}")
    args = parse(20)
    init, after = _restore(torch, args, ckpt_dir, 20)
    print("[smoke] train after 20 steps: " + _held_out_gate(torch, args, init, [after], "train"))
    res, rcounts = run(22)
    check(len(res["losses"]) == 2 and all(math.isfinite(x) for x in res["losses"]),
          f"resume: losses {res['losses']}")
    _check_train_counts(rcounts, 2, "train resume 2 steps")
    print(f"[smoke] train resume from step 20: 2 steps, losses {res['losses']}")
    return {"counts": counts, "step_ms": med * 1e3, "tokens_per_s": tok_s}


def long_train_phase(torch, plan: str, ckpt_dir: str) -> dict:
    """Full-width repro-100m through the train entry point on ``cuda`` under
    the fused-softmax plan at batch 1 x 4096, past the dense cap:
    ``LONG_STEPS`` steps, remat on, every attention on the flash kernels
    forward and backward.  Checks the exit code (0: the loss fell), finite
    losses, the launch counts (per step 24 flash forwards and 12 flash
    backward calls, 24 GLU forwards and 12 GLU backwards, no row softmax),
    and the held-out gate of ``train_phase`` on 1 x 4096 batches, on average
    over this run and the same run with the plain GLU (``_train_plain``):
    one long-context batch a step, the runs' held-out losses spread by more
    than the gate across GLU orders (``ab_flash.py --gate``).  Returns the
    counts, the median step time and tokens/s."""
    import statistics

    from repro_torch.launch import train

    args = train.build_parser().parse_args(
        ["--arch", "repro-100m", "--steps", str(LONG_STEPS), "--plan", plan, "--batch",
         str(LONG_BATCH), "--seq", str(LONG_SEQ), "--ckpt-dir", ckpt_dir, "--ckpt-every", "100",
         "--log-every", "5"])
    check(args.device == "cuda", "train must default to cuda")
    reset_counters()
    out = train.run(args)
    torch.cuda.synchronize()
    counts = read_counters()
    check(out["rc"] == 0, f"long train rc {out['rc']}: losses {out['losses']}")
    check(len(out["losses"]) == LONG_STEPS and all(math.isfinite(x) for x in out["losses"]),
          f"long train losses {out['losses']}")
    want = {"fused_glu": 2 * N_LAYERS * LONG_STEPS, "fused_glu_bwd": N_LAYERS * LONG_STEPS,
            "fused_flash_attention": 2 * N_LAYERS * LONG_STEPS,
            "fused_flash_attention_bwd": N_LAYERS * LONG_STEPS}
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"long train {LONG_STEPS} steps: {name} launches {n} != {want.get(name, 0)}")
    med = statistics.median(out["step_seconds"])
    tok_s = out["tokens_per_step"] / med
    print(f"[smoke] train repro-100m --plan <fused softmax> --batch {LONG_BATCH} --seq "
          f"{LONG_SEQ} {LONG_STEPS} steps: loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, "
          f"median step {med * 1e3:.1f} ms ({tok_s:.0f} tokens/s), first step "
          f"{out['step_seconds'][0] * 1e3:.1f} ms, launches {counts}")
    init, after = _restore(torch, args, ckpt_dir, LONG_STEPS)
    line = _held_out_gate(torch, args, init, [after, _train_plain(torch, args)], "long train")
    print(f"[smoke] long train (1 x {LONG_SEQ}) after {LONG_STEPS} steps, this run and the "
          f"plain GLU's: {line}")
    return {"counts": counts, "step_ms": med * 1e3, "tokens_per_s": tok_s}


def _check_train_counts(counts: dict, steps: int, what: str) -> None:
    want = {"fused_glu": 2 * N_LAYERS * steps, "fused_pwl_softmax": 2 * N_LAYERS * steps,
            "fused_glu_bwd": N_LAYERS * steps, "fused_pwl_softmax_bwd": N_LAYERS * steps}
    for name, n in counts.items():
        check(n == want.get(name, 0), f"{what}: {name} launches {n} != {want.get(name, 0)}")


def _norm(torch, tensors) -> float:
    return math.sqrt(sum(float(t.double().square().sum()) for t in tensors))


def _loss_and_grads(torch, model, masters, batch):
    from repro_torch import tree

    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(masters)]
    loss, _ = model.loss(tree.unflatten(masters, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def _worst_leaf(torch, got, want) -> float:
    """The largest elementwise difference of a leaf over that leaf's max."""
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
               for a, b in zip(got, want))


@contextlib.contextmanager
def _glu_dx_in_one_gemm(torch):
    """The GLU's plain VJP with dx taken as one GEMM, [dzg | dzu] times
    [Wg | Wu]^T, where the port sums two: the same function in another f32
    summation order, so some bf16 roundings of dx flip.  The gradients it
    gives against the port's plain VJP are the yardstick of what one flipped
    rounding does to the model's gradients."""
    from repro_torch.kernels.fused import glu

    def backward(ctx, g):
        x, wg, wu = ctx.saved_tensors
        dzg, dzu = glu.fused_glu_bwd_plain(x, wg, wu, g, ctx.plan, ctx.tables)
        xf = x.to(torch.float32)
        w = torch.cat([wg, wu], dim=1).to(torch.float32)
        dx = (torch.cat([dzg, dzu], dim=1) @ w.T).to(x.dtype)
        return (dx, (xf.T @ dzg).to(wg.dtype), (xf.T @ dzu).to(wu.dtype), None, None, None,
                None)

    orig = glu._GLUOp.__dict__["backward"]
    glu._GLUOp.backward = staticmethod(backward)
    try:
        yield
    finally:
        glu._GLUOp.backward = orig


@contextlib.contextmanager
def _linear_dx_in_halves(torch):
    """The fused linear layer's plain VJP with dx summed in two halves of
    N, where the port takes one product: the same function in another f32
    summation order, whisper's counterpart of :func:`_glu_dx_in_one_gemm`."""
    from repro_torch.kernels.fused import linear

    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dz = linear.fused_linear_bwd_plain(x, w, b, g, ctx.plan, ctx.tables)
        wf, h = w.to(torch.float32), dz.shape[1] // 2
        dx = (dz[:, :h] @ wf[:, :h].T + dz[:, h:] @ wf[:, h:].T).to(x.dtype)
        dw = (x.to(torch.float32).T @ dz).to(w.dtype)
        return dx, dw, None if b is None else dz.sum(dim=0).to(b.dtype), None, None, None

    orig = linear._LinearOp.__dict__["backward"]
    linear._LinearOp.backward = staticmethod(backward)
    try:
        yield
    finally:
        linear._LinearOp.backward = orig


def _fused_vs_recompute(torch, cfg, batch, what: str, remat_off_check: bool,
                        reorder=None) -> str:
    """One model's gradients under ``impl_bwd="fused"`` against
    ``"recompute"`` on ``batch``, as :func:`grad_phase` holds them; returns
    the line to print.  ``reorder`` is the context in which the bf16
    yardstick's recompute sums dx in another order (the GLU's by default);
    given one, the cosine gate is 0.999 or, where the yardstick's own lowest
    cosine shows the model more sensitive than that, 1 - 4 x its gap."""
    import dataclasses

    from repro_torch.kernels.fused import use_impl_bwd
    from repro_torch.models import Model

    dtype = cfg.dtype
    check(cfg.remat, "the full-width gradients must be taken under remat")
    model = Model(cfg, device="cuda")
    masters = model.init(seed=0, master=True)
    runs = {}
    for mode in ("fused", "recompute"):
        with use_impl_bwd(mode):
            runs[mode] = _loss_and_grads(torch, model, masters, batch)
    torch.cuda.synchronize()
    (lf, gf), (lr, gr) = runs["fused"], runs["recompute"]
    check(float(lf) == float(lr), f"{what} loss fused {float(lf)} != recompute {float(lr)}")
    check(all(bool(torch.isfinite(a).all()) for a in gf), f"{what}: non-finite gradient")
    worst = _worst_leaf(torch, gf, gr)
    cos = [torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0).item() for a, b in zip(gf, gr)]
    line = (f"[smoke] grads {what} (remat), impl_bwd fused vs recompute: loss {float(lf):.6f} "
            f"equal, worst leaf {worst:.3g} of its max, lowest cosine {min(cos):.8f}, global "
            f"norm {_norm(torch, gf):.4g}")
    if dtype == torch.float32:
        check(worst <= 1e-4, f"{what}: a gradient leaf off by {worst:.3g} of its max")
        if remat_off_check:
            with use_impl_bwd("fused"):
                _, g_flat = _loss_and_grads(
                    torch, Model(dataclasses.replace(cfg, remat=False), device="cuda"),
                    masters, batch)
            remat_gap = _worst_leaf(torch, g_flat, gf)
            check(remat_gap <= 1e-6, f"{what}: remat off differs by {remat_gap:.3g} of a leaf")
            line += f"; remat off vs on: worst leaf {remat_gap:.3g}"
    else:
        with use_impl_bwd("fused"):
            _, again = _loss_and_grads(torch, model, masters, batch)
        check(all(torch.equal(a, b) for a, b in zip(gf, again)),
              f"{what}: two fused backwards differ")
        del again
        with use_impl_bwd("recompute"), (reorder or _glu_dx_in_one_gemm)(torch):
            _, g_order = _loss_and_grads(torch, model, masters, batch)
        yardstick = _worst_leaf(torch, g_order, gr)
        ycos = min(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item()
            for a, b in zip(g_order, gr))
        cos_gate = 0.999 if reorder is None else min(0.999, 1 - 4 * (1 - ycos))
        check(min(cos) >= cos_gate, f"{what}: a gradient leaf at cosine {min(cos):.6f} < "
              f"{cos_gate:.6f} (the yardstick's lowest {ycos:.6f})")
        check(worst <= 4 * yardstick,
              f"{what}: fused vs recompute {worst:.3g} > 4 x the reordered-dx yardstick "
              f"{yardstick:.3g}")
        line += (f"; yardstick, recompute vs recompute with dx in another order: worst leaf "
                 f"{yardstick:.3g}, lowest cosine {ycos:.8f}")
    return line


def grad_phase(torch, plan: str):
    """The gradients of the training path, each full-width batch under
    ``impl_bwd="fused"`` (the backward kernels) against ``"recompute"``
    (plain recomputation) on the card, f32 masters, remat on, the loss
    bitwise equal (the forwards are the same kernels).  Two batches: 8 x 512
    (the row softmax's backward) and 1 x 4096 (the flash backward, whose
    recompute is autograd through the dense oracle,
    ``flash_reference_attention``):

    * f32 compute (TF32 off): every gradient leaf at 1e-4 of its max (sums
      in another order; measured ~3e-6 on an H100), and at 8 x 512 the fused
      gradients with remat off at 1e-6 of each leaf's max against remat on
      (the recomputed forward is the same kernels on the same inputs);
    * bf16 compute, the training path's: a second fused backward bitwise the
      first (no atomics); every leaf at cosine >= 0.999 with its recompute;
      and the worst leaf's gap at most 4 times a yardstick measured on the
      same batch, recompute against recompute with the GLU's dx summed in
      another order (``_glu_dx_in_one_gemm``).  Both pairs differ only in f32
      roundings inside the backward that flip some bf16 roundings; the
      backward of a PWL model at this init amplifies such flips to percents
      of a leaf's max (the JAX package's own gradients move as much under a
      rounding-sized nudge of the weights:
      ``tests/test_torch_train_parity.py``).

    Then reduced repro-100m in f32 on the card against the CPU, loss and
    every leaf at 1e-4 of its max, as reference_phase holds the logits."""
    from repro_torch import sfu
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    vocab = get_config("repro-100m").vocab_size
    for batch_size, seq in ((TRAIN_BATCH, TRAIN_SEQ), (LONG_BATCH, LONG_SEQ)):
        data = SyntheticLMData(DataConfig(vocab_size=vocab, seq_len=seq,
                                          global_batch=batch_size))
        batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
        for dtype in (torch.float32, torch.bfloat16):
            cfg = get_config("repro-100m", act_plan=sfu.load_plan(plan), dtype=dtype)
            what = f"full-width {dtype} batch {batch_size}x{seq}"
            print(_fused_vs_recompute(torch, cfg, batch, what,
                                      remat_off_check=seq == TRAIN_SEQ))

    rcfg = get_reduced_config("repro-100m", act_plan=sfu.load_plan(plan), dtype=torch.float32)
    cpu, gpu = Model(rcfg, device="cpu"), Model(rcfg, device="cuda")
    rmasters = cpu.init(seed=0, master=True)
    rdata = SyntheticLMData(DataConfig(vocab_size=rcfg.vocab_size, seq_len=64, global_batch=2))
    rbatch = {k: torch.from_numpy(v) for k, v in rdata.batch_at(0).items()}
    lc, gc = _loss_and_grads(torch, cpu, rmasters, rbatch)
    lg, gg = _loss_and_grads(torch, gpu, _to_cuda(torch, rmasters),
                             {k: v.cuda() for k, v in rbatch.items()})
    check(abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)),
          f"reduced f32 loss cuda {float(lg)} vs cpu {float(lc)}")
    worst = max(_compare_scaled(torch, a.cpu(), b, 1e-4, f"reduced f32 grad leaf {i}") /
                max(b.abs().max().item(), 1e-30) for i, (a, b) in enumerate(zip(gg, gc)))
    print(f"[smoke] grads reduced f32, cuda vs cpu: loss {float(lg):.6f} vs {float(lc):.6f}, "
          f"worst leaf error {worst:.3g} of its max")


def moe_train_phase(torch, plan: str) -> dict:
    """Reduced olmoe-1b-7b (2 MoE layers, d_model 64, 8 experts top 2)
    through the train entry point on ``cuda`` under the fused plan, at the
    launcher's defaults (batch 8 x 512; remat off, as the reduced config
    has it): 20 steps, rc 0 (the loss fell), finite losses and load-balancing
    losses, and per step one MoE GLU forward and one backward a layer, no
    other kernel.  Full-width MoE training needs more than one card holds
    (f32 masters, gradients and two moments of 6.92 B parameters)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import train

    args = train.build_parser().parse_args(
        ["--arch", "olmoe-1b-7b", "--reduced", "--steps", "20", "--plan", plan,
         "--log-every", "5"])
    check(args.device == "cuda", "train must default to cuda")
    cfg = get_reduced_config("olmoe-1b-7b")
    check(cfg.n_experts == 8 and not cfg.remat, "not reduced olmoe-1b-7b without remat")
    reset_counters()
    out = train.run(args)
    torch.cuda.synchronize()
    counts = read_counters()
    check(out["rc"] == 0, f"olmoe train rc {out['rc']}: losses {out['losses']}")
    check(len(out["losses"]) == 20 and all(math.isfinite(x) for x in out["losses"]),
          f"olmoe train losses {out['losses']}")
    want = {"fused_moe_glu": cfg.n_layers * 20, "fused_moe_glu_bwd": cfg.n_layers * 20}
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"olmoe train 20 steps: {name} launches {n} != {want.get(name, 0)}")
    print(f"[smoke] train olmoe-1b-7b --reduced --plan <fused> 20 steps: loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, launches {counts}")
    return counts


def moe_grad_phase(torch):
    """One full-width olmoe-1b-7b MoE layer (64 experts top 8, d_model 2048,
    expert d_ff 1024) on 8 x 512 tokens (capacity 640) under its fused
    plan: the gradients of x, the f32 router and the f32 expert masters (cast
    to the compute dtype as the train step casts them) of
    ``sum(cos(y)) + aux``, with ``impl_bwd="fused"`` (the backward kernel)
    against ``"recompute"`` (plain recomputation) on the card, the loss
    bitwise equal (the same forward kernel).  f32 (TF32 off) on integer-grid
    x and expert weights (exact products, so both backwards decode the same
    segment; see ``moe_bwd_phase``) at 1e-4 of each leaf's max; bf16 on the
    init's normal weights at cosine >= 0.999 for every leaf."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused import fused_moe_glu, use_impl_bwd
    from repro_torch.models import moe
    from repro_torch.models.common import compute_params, init_params
    from repro_torch.models.transformer import moe_defs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    names = ("router", "w_gate", "w_up", "w_down")
    T = TRAIN_BATCH * TRAIN_SEQ
    for dtype in (torch.float32, torch.bfloat16):
        cfg = get_config("olmoe-1b-7b", act_impl="fused", dtype=dtype)
        check(moe.capacity(cfg, T) == MOE_TRAIN_C, "capacity at 8 x 512 tokens is not 640")
        defs = moe_defs(cfg)
        masters = init_params(defs, 0, dev, dtype, master=True)
        shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)
        if dtype == torch.float32:
            for k in ("w_gate", "w_up"):
                masters[k] = _igrid(torch, gen, masters[k].shape, dtype, span=2, step=2.0 ** -7)
            x0 = _igrid(torch, gen, shape, dtype)
        else:
            x0 = torch.randn(shape, generator=gen, device=dev).to(dtype)
        runs = {}
        for mode in ("fused", "recompute"):
            leaves = {k: masters[k].detach().clone().requires_grad_(True) for k in names}
            x = x0.clone().requires_grad_(True)
            n0, b0 = fused_moe_glu.launches, fused_moe_glu.bwd_launches
            with use_impl_bwd(mode):
                y, aux = moe.moe_layer(cfg, compute_params(defs, leaves, dtype), x)
                loss = torch.cos(y.float()).sum() + aux
                grads = torch.autograd.grad(loss, [x] + [leaves[k] for k in names])
            torch.cuda.synchronize()
            check(fused_moe_glu.launches == n0 + 1, f"MoE layer {mode}: forward kernel launches")
            check(fused_moe_glu.bwd_launches == b0 + (mode == "fused"),
                  f"MoE layer {mode}: backward kernel launches")
            runs[mode] = (float(loss.detach()), float(aux.detach()), grads)
        (lf, af, gf), (lr, _, gr) = runs["fused"], runs["recompute"]
        what = f"full-width olmoe MoE layer {dtype} 8x{TRAIN_SEQ}"
        check(lf == lr, f"{what}: loss fused {lf} != recompute {lr}")
        check(all(bool(torch.isfinite(a).all()) for a in gf), f"{what}: non-finite gradient")
        worst = _worst_leaf(torch, gf, gr)
        cos = [torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item() for a, b in zip(gf, gr)]
        if dtype == torch.float32:
            check(worst <= 1e-4, f"{what}: a gradient leaf off by {worst:.3g} of its max")
        else:
            check(min(cos) >= 0.999, f"{what}: a gradient leaf at cosine {min(cos):.6f}")
        print(f"[smoke] grads {what}, impl_bwd fused vs recompute: loss {lf:.4f} equal "
              f"(aux {af:.4f}), worst leaf {worst:.3g} of its max, lowest cosine "
              f"{min(cos):.8f} (leaves x, {', '.join(names)})")
        del masters, runs, gf, gr


def moe_reference_phase(torch, plan: str):
    """Reduced olmoe-1b-7b (2 MoE layers, d_model 64, 8 experts top 2) in f32
    (TF32 off) under its fused plan on the card against the same calls on
    the CPU, so the routing (f32 logits, the stable top-k), the dispatch into
    capacity buckets, the combine and the aux loss run on CUDA against an
    independent path: logits of ``forward`` on 2 x 64 tokens (capacity 40),
    the loss, its nll and aux, and every gradient leaf of ``Model.loss`` at
    1e-4 (each leaf on the scale of its max); then the logits of one paged
    prefill (a 20-token prompt in a 32-token bucket) and of three paged
    decode steps fed the CPU's greedy tokens, at 1e-4.  Each MoE layer of
    each call ran its kernel on the card."""
    from repro_torch import sfu, tree
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels.fused import fused_moe_glu
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced_config("olmoe-1b-7b", act_plan=sfu.load_plan(plan), dtype=torch.float32)
    check(cfg.n_experts == 8 and cfg.n_active_experts == 2, "not reduced olmoe-1b-7b")
    L = cfg.n_layers
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2))
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    gbatch = {k: v.cuda() for k, v in batch.items()}

    params = cpu.init(seed=0)
    check(params["layers"][0]["ffn"]["router"].dtype == torch.float32, "router is not f32")
    gparams = _to_cuda(torch, params)
    n0 = fused_moe_glu.launches
    got = gpu.forward(gparams, gbatch["tokens"]).cpu()
    check(fused_moe_glu.launches == n0 + L, "olmoe forward: an MoE layer skipped its kernel")
    want = cpu.forward(params, batch["tokens"])
    logit_err = _compare_scaled(torch, got, want, 1e-4, "reduced olmoe logits cuda vs cpu")

    def loss_and_grads(model, masters, b):
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(masters)]
        loss, metrics = model.loss(tree.unflatten(masters, leaves), b)
        return loss.detach(), {k: float(v.detach()) for k, v in metrics.items()}, \
            torch.autograd.grad(loss, leaves)

    masters = cpu.init(seed=0, master=True)
    n0, b0 = fused_moe_glu.launches, fused_moe_glu.bwd_launches
    lg, mg, gg = loss_and_grads(gpu, _to_cuda(torch, masters), gbatch)
    check(fused_moe_glu.launches == n0 + L and fused_moe_glu.bwd_launches == b0 + L,
          "olmoe loss: an MoE layer skipped its forward or backward kernel")
    lc, mc, gc = loss_and_grads(cpu, masters, batch)
    for name, a, b in (("loss", float(lg), float(lc)), ("nll", mg["nll"], mc["nll"]),
                       ("aux", mg["aux"], mc["aux"])):
        check(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b),
              f"reduced olmoe {name} cuda {a} vs cpu {b}")
    check(mc["aux"] > 1.0, f"reduced olmoe aux {mc['aux']}: not one per layer at least")
    worst = max(_compare_scaled(torch, a.cpu(), b, 1e-4, f"reduced olmoe grad leaf {i}") /
                max(b.abs().max().item(), 1e-30) for i, (a, b) in enumerate(zip(gg, gc)))

    ps, P, n = 16, 9, 20
    table = torch.tensor([[3, 5, 0]], dtype=torch.int32)
    toks = torch.zeros((1, 32), dtype=torch.int32)
    toks[0, :n] = batch["tokens"][0, :n]
    lens = torch.tensor([n], dtype=torch.int32)
    ccache, gcache = cpu.make_paged_cache(P, ps), gpu.make_paged_cache(P, ps)
    n0 = fused_moe_glu.launches
    want = cpu.prefill_paged(params, toks, ccache, table[:, :2], lens)
    got = gpu.prefill_paged(gparams, toks.cuda(), gcache, table[:, :2].cuda(), lens.cuda())
    paged_err = _compare_scaled(torch, got.cpu(), want, 1e-4, "reduced olmoe paged prefill")
    for step in range(3):
        cur = want[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        kv = lens + step
        want = cpu.decode_step_paged(params, cur, ccache, table, kv)
        got = gpu.decode_step_paged(gparams, cur.cuda(), gcache, table.cuda(), kv.cuda())
        paged_err = max(paged_err, _compare_scaled(torch, got.cpu(), want, 1e-4,
                                                   f"reduced olmoe paged decode step {step}"))
    check(fused_moe_glu.launches == n0 + 4 * L, "olmoe paged calls: an MoE layer skipped its kernel")
    print(f"[smoke] reduced olmoe f32, cuda vs cpu: logits max_abs_err {logit_err:.3g}; loss "
          f"{float(lg):.6f} vs {float(lc):.6f}, aux {mg['aux']:.6f} vs {mc['aux']:.6f}, worst "
          f"grad leaf {worst:.3g} of its max; paged prefill + 3 decode steps max_abs_err "
          f"{paged_err:.3g}")


# ---------------------------------------------------------------------------
# slice 5: the standalone PWL kernels; bf16 tables on the card


def _f32_bound(nbytes: float, f32_ops: float) -> dict:
    """Bytes over the HBM rate against f32 operations over the rate of the
    CUDA cores outside the tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = f32_ops / PEAK_F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _elementwise_bound(n: int, esize: int, ops_per_elem: float) -> dict:
    """x read once, y written once, against the decode's f32 operations on
    the CUDA cores (``ops_per_elem`` an element)."""
    return _f32_bound(2.0 * n * esize, n * ops_per_elem)


def _bitwise(torch, got, want, what) -> None:
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    a, b = got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)
    check(bool(torch.equal(a, b)),
          f"{what}: not bitwise, max err {(got.float() - want.float()).abs().max().item()}")


MAMBA_H = 80  # mamba2-2.7b's SSM heads: dt's softplus runs on (B, L, 80) f32
MAMBA_DT = {"dt prefill 4 x 32 x 80 f32": (4, 32, MAMBA_H),
            "dt decode 4 x 1 x 80 f32": (4, 1, MAMBA_H),
            "dt 4 x 300 x 80 f32": (4, 300, MAMBA_H)}


def pwl_act_phase(torch):
    """The standalone PWL kernels (TPU kernels 19 and 20) through their
    wrappers ``ops.pwl_activation`` / ``ops.pwl_activation_uniform`` on CUDA
    tensors against their plain versions, bitwise: kernel 19 at the unfused
    GLU gate of the ``impl="kernel"`` serving session (decode 4 x 3072,
    prefill 32 x 3072, bf16; gelu_tanh, 32 breakpoints), at 4096 x 3072 in
    bf16, f16 and f32, and with bf16 and f16 tables (the plain version on
    the native operands); kernel 20 at tests/test_kernels.py's shape (32 x
    384 f32, sigmoid, 32 breakpoints, uniform) and at 4096 x 3072 bf16.
    Both also at 4096 x 3072 + 3 elements and on views that start one
    element past a 16-byte boundary (bf16, f16, f32), so the 16-byte
    vectors, the elements before the first boundary and the ragged tail all
    run.  The 4096 x 3072 bf16 shapes and the decode gate are timed beside
    their byte bound and the plain version.  Kernel 19 also at mamba2-2.7b's
    dt shapes (``MAMBA_DT``: softplus, 32 breakpoints, f32), bitwise and
    timed, and on an empty tensor, which launches and counts nothing."""
    from repro_torch import sfu
    from repro_torch.core import functions as F
    from repro_torch.core.pwl import make_uniform_table
    from repro_torch.kernels import ops, pwl_act
    from repro_torch.kernels.fused.epilogue import pack_table

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    big = TRAIN_TOKENS * N_DIM

    def offset_view(n, dtype, scale):
        """n elements one element past a 16-byte boundary (a view of n + 1)."""
        base = (torch.randn(n + 1, generator=gen, device=dev) * scale).to(dtype)
        view = base[1:]
        check(view.data_ptr() % 16 != 0, "the offset view must start off a 16-byte boundary")
        return view

    def rnd(shape, dtype, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    cases = [  # (name, x, table format, timed)
        ("decode 4 x 3072 bf16", rnd((4, 1, N_DIM), torch.bfloat16, 4.0), "f32", True),
        ("prefill 32 x 3072 bf16", rnd((1, 32, N_DIM), torch.bfloat16, 4.0), "f32", False),
        ("4096 x 3072 bf16", rnd((TRAIN_TOKENS, N_DIM), torch.bfloat16, 4.0), "f32", True),
        ("4096 x 3072 f16", rnd((TRAIN_TOKENS, N_DIM), torch.float16, 4.0), "f32", False),
        ("4096 x 3072 f32", rnd((TRAIN_TOKENS, N_DIM), torch.float32, 4.0), "f32", False),
        ("4096 x 3072 bf16, bf16 table", rnd((TRAIN_TOKENS, N_DIM), torch.bfloat16, 4.0), "bf16",
         False),
        ("4096 x 3072 f32, f16 table", rnd((TRAIN_TOKENS, N_DIM), torch.float32, 4.0), "f16",
         False),
        ("4096 x 3072 + 3 bf16", rnd((big + 3,), torch.bfloat16, 4.0), "f32", False),
        ("offset view 4096 x 3072 + 3 bf16", offset_view(big + 3, torch.bfloat16, 4.0), "f32",
         False),
        ("offset view 4096 x 3072 + 1 f16", offset_view(big + 1, torch.float16, 4.0), "f32",
         False),
        ("offset view 4096 x 3072 + 3 f32", offset_view(big + 3, torch.float32, 4.0), "f32",
         False),
        ("offset view 5 bf16", offset_view(5, torch.bfloat16, 4.0), "f32", False),
    ]
    for name, x, fmt, timed in cases:
        t = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32, dtype=fmt)
        n0 = ops.pwl_activation.launches
        got = ops.pwl_activation(x, t)
        check(ops.pwl_activation.launches == n0 + 1, f"pwl_activation {name}: not launched")
        native = tuple(a.to(dev) for a in pack_table(t))  # bf16/f16 stay native here
        want = pwl_act.pwl_nonuniform_plain(x, *native)
        torch.cuda.synchronize()
        _bitwise(torch, got, want, f"pwl_activation {name}")
        line = f"[smoke] pwl_activation {name}: bitwise its plain version"
        if timed:
            bp, dmq = (a.to(dev) for a in pack_table(table))
            k_ms = time_ms(torch, lambda i: ops.pwl_activation(x, table))
            p_ms = time_ms(torch, lambda i: pwl_act.pwl_nonuniform_plain(x, bp, dmq),
                           reps=3, iters=3)
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "max_abs_err": 0.0,
                          **_elementwise_bound(x.numel(), x.element_size(), SEARCH_OPS + 2)}
            line += (f", kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
                     f"{rows[name]['bound_ms'] * 1e3:.2f} us ({rows[name]['bound_by']})")
        print(line)

    # mamba2-2.7b's dt softplus under an impl="kernel" plan: f32 (B, L, 80)
    sp = sfu.get_store().get(fn="softplus", n_breakpoints=32)
    sp_bp, sp_dmq = (a.to(dev) for a in pack_table(sp))
    for name, shape in MAMBA_DT.items():
        x = rnd(shape, torch.float32, 2.0)  # x @ in_dt + dt_bias at init: ~N(0, 1)
        n0 = ops.pwl_activation.launches
        got = ops.pwl_activation(x, sp)
        check(ops.pwl_activation.launches == n0 + 1, f"pwl_activation {name}: not launched")
        _bitwise(torch, got, pwl_act.pwl_nonuniform_plain(x, sp_bp, sp_dmq),
                 f"pwl_activation {name}")
        k_ms = time_ms(torch, lambda i: ops.pwl_activation(x, sp))
        p_ms = time_ms(torch, lambda i: pwl_act.pwl_nonuniform_plain(x, sp_bp, sp_dmq))
        r = rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "max_abs_err": 0.0,
                          **_elementwise_bound(x.numel(), x.element_size(), SEARCH_OPS + 2)}
        print(f"[smoke] pwl_activation {name} (softplus, 32 breakpoints): bitwise its plain "
              f"version, kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    n0 = ops.pwl_activation.launches
    empty = ops.pwl_activation(torch.empty((4, 0, MAMBA_H), device=dev), sp)
    check(empty.shape == (4, 0, MAMBA_H) and ops.pwl_activation.launches == n0,
          "pwl_activation on an empty tensor counted a launch")

    spec = F.get("sigmoid")
    ut = make_uniform_table(spec, 32)
    um, uq = ut.m.to(dev), ut.q.to(dev)  # on the card: a graph capture copies nothing
    lo, hi = spec.default_range
    mq = ops.pack_uniform(um, uq)
    for name, x, timed in (
            ("32 x 384 f32", rnd((32, 384), torch.float32, 6.0), True),
            ("4096 x 3072 bf16", rnd((TRAIN_TOKENS, N_DIM), torch.bfloat16, 6.0), True),
            ("4096 x 3072 + 3 bf16", rnd((big + 3,), torch.bfloat16, 6.0), False),
            ("offset view 4096 x 3072 + 3 bf16", offset_view(big + 3, torch.bfloat16, 6.0),
             False),
            ("offset view 4096 x 3072 + 3 f32", offset_view(big + 3, torch.float32, 6.0), False)):
        n0 = ops.pwl_activation_uniform.launches
        got = ops.pwl_activation_uniform(x, um, uq, lo, hi)
        check(ops.pwl_activation_uniform.launches == n0 + 1,
              f"pwl_activation_uniform {name}: not launched")
        want = pwl_act.pwl_uniform_plain(x, mq, lo, hi)
        torch.cuda.synchronize()
        _bitwise(torch, got, want, f"pwl_activation_uniform {name}")
        line = f"[smoke] pwl_activation_uniform {name}: bitwise its plain version"
        if timed:
            k_ms = time_ms(torch, lambda i: ops.pwl_activation_uniform(x, um, uq, lo, hi))
            p_ms = time_ms(torch, lambda i: pwl_act.pwl_uniform_plain(x, mq, lo, hi), reps=3,
                           iters=3)
            # the affine index and the clip (~8 operations), the fetch, m * x + q
            r = rows[f"uniform {name}"] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": None, "max_abs_err": 0.0,
                **_elementwise_bound(x.numel(), x.element_size(), 11)}
            line += (f", kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
                     f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        print(line)
    return rows


def bf16_table_phase(torch):
    """A bf16 table through the fused kernels (packed into the f32 delta
    layout on the card) against the plain versions on the table's native
    operands, bitwise.  Inputs on a grid make every sum exact in any order
    and every product of a bf16 slope exact in f32, so the kernels' fmaf and
    reduction order cannot show: what is compared is the decode.  The GLU
    (gelu_tanh) at M = 4 and 32, K = 768, N = 3072 on 1/8-grid x and weights
    in bf16 and f32; the row softmax (exp) on 1/8-grid scores in [-2, 0],
    12 x 32 rows of 32, causal, and 48 rows of 32 with a prefix mask."""
    from repro_torch import sfu
    from repro_torch.kernels.fused import fused_glu, fused_pwl_softmax
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.kernels.fused.glu import fused_glu_plain
    from repro_torch.kernels.fused.softmax import fused_pwl_softmax_plain, static_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    glu_t = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32, dtype="bf16")
    plan, native = plan_and_operands(glu_t)
    check(native[1].dtype == torch.bfloat16 and plan.table_dtype == "bf16",
          "the plain side must read the native bf16 operands")
    native = tuple(t.to(dev) for t in native)
    for dtype in (torch.bfloat16, torch.float32):
        for M in (4, 32):
            x = _igrid(torch, gen, (M, K_DIM), dtype)
            wg = _igrid(torch, gen, (K_DIM, N_DIM), dtype)
            wu = _igrid(torch, gen, (K_DIM, N_DIM), dtype)
            n0 = fused_glu.launches
            got = fused_glu(x, wg, wu, table=glu_t)
            check(fused_glu.launches == n0 + 1, "fused_glu bf16 table: not launched")
            want = fused_glu_plain(x, wg, wu, plan, native)
            torch.cuda.synchronize()
            _bitwise(torch, got, want, f"fused_glu bf16 table M={M} {dtype}")
    exp_t = sfu.get_store().get(fn="exp", n_breakpoints=EXP_BP, dtype="bf16")
    splan, snative = plan_and_operands(exp_t)
    snative = tuple(t.to(dev) for t in snative)
    for name, shape, kw in (("12x32 x 32 causal", (1, 1, HKV, 32, 32), {"causal": True}),
                            ("48 x 32 prefix mask", (4, HKV, 1, 32), {"mask": True})):
        x = -torch.randint(0, 17, shape, generator=gen, device=dev).to(torch.float32) / 8.0
        N = shape[-1]
        if kw.get("mask"):
            lens = torch.tensor([32, 19, 1, 7], device=dev)
            kw = {"mask": (torch.arange(N, device=dev)[None, :] < lens[:, None])[:, None, None]}
            mask2 = torch.broadcast_to(kw["mask"], shape).reshape(-1, N).to(torch.float32)
        else:
            mask2 = static_mask(x.numel() // N, N, shape[-2], True, None, device=dev)
        n0 = fused_pwl_softmax.launches
        got = fused_pwl_softmax(x, table=exp_t, **kw)
        check(fused_pwl_softmax.launches == n0 + 1, "softmax bf16 table: not launched")
        want = fused_pwl_softmax_plain(x.reshape(-1, N), mask2, splan, snative).reshape(shape)
        torch.cuda.synchronize()
        _bitwise(torch, got, want, f"fused_pwl_softmax bf16 table {name}")
    print("[smoke] bf16 tables: fused_glu (M = 4, 32; bf16 and f32) and fused_pwl_softmax "
          "(causal, prefix mask) bitwise their plain versions on the native operands")


# ---------------------------------------------------------------------------
# slice 6: whisper-small's fused linear layer


WHISPER_D, WHISPER_LAYERS, WHISPER_FRAMES = 768, 12, 1500
WHISPER_CROSS_SOFTMAX = f"whisper cross-attention 4x{HKV} x {WHISPER_FRAMES}"  # a decode step's
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 8, 448  # Whisper's text context
WHISPER_ENC_M = 4 * WHISPER_FRAMES  # the encoder MLP's rows in a 4-request prefill


def linear_phase(torch):
    """The fused linear layer's forward (TPU kernel 15, through
    ``fused_linear``) vs its plain version at whisper's MLP input projection
    (K = 768, N = 3072, gelu, 32 breakpoints): M = 4 (a decode step), 128
    (a prefill of 4 x 32) and 6000 (the encoder over 4 x 1500 frames), with
    and without the bias, bf16 at 1e-2 and f32 (TF32 off) at 1e-4; a ragged
    37 x 65 x 130 first."""
    from repro_torch import sfu
    from repro_torch.kernels.fused import fused_linear
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.kernels.fused.linear import fused_linear_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    table = sfu.get_store().get(fn="gelu", n_breakpoints=32)
    plan, tables = plan_and_operands(table)
    tables = tuple(t.to(dev) for t in tables)
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    n_copies = 12  # 12 x 4.7 MB of bf16 weights: more than the 50 MB L2
    for M, K, N in ((37, 65, 130), (4, K_DIM, N_DIM), (128, K_DIM, N_DIM),
                    (WHISPER_ENC_M, K_DIM, N_DIM)):
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            ws = [(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(dtype)
                  for _ in range(n_copies if K == K_DIM else 1)]
            b = (torch.randn(N, generator=gen, device=dev) * 0.1).to(dtype)
            x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            errs = []
            for bias in (b, None):
                n0 = fused_linear.launches
                got = fused_linear(x, ws[0], bias, table=table)
                check(fused_linear.launches == n0 + 1, f"fused_linear M={M}: not launched")
                want = fused_linear_plain(x, ws[0], bias, plan, tables)
                torch.cuda.synchronize()
                errs.append(_compare(torch, got, want, tol,
                                     f"fused_linear M={M} K={K} N={N} {dtype} "
                                     f"{'bias' if bias is not None else 'no bias'}"))
            line = (f"[smoke] fused_linear M={M} K={K} N={N} {dtype}: max_abs_err with bias "
                    f"{errs[0]:.3g}, without {errs[1]:.3g} (tol {tol})")
            if K == K_DIM and dtype == torch.bfloat16:
                nc = len(ws)
                k_ms = time_ms(torch, lambda i: fused_linear(x, ws[i % nc], b, table=table),
                               reps=10 if M > 1000 else 20, iters=5 if M > 1000 else 10)
                p_ms = time_ms(torch, lambda i: fused_linear_plain(x, ws[i % nc], b, plan, tables),
                               reps=3, iters=3)
                l_ms = time_ms(torch, lambda i: torch.addmm(b, x, ws[i % nc]))
                nbytes = (M * K + K * N + N + M * N) * x.element_size()
                rows[M] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                           "max_abs_err": errs[0], **_bound(nbytes, 2.0 * M * K * N)}
                line += (f", kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
                         f"torch.addmm {l_ms * 1e3:.2f} us, bound {rows[M]['bound_ms'] * 1e3:.2f}"
                         f" us ({rows[M]['bound_by']})")
            print(line)
    return rows


def linear_bwd_phase(torch):
    """The fused linear layer's backward kernel (TPU kernel 16, through
    ``fused_linear_bwd``) vs its plain version: f32 (TF32 off) at 1e-4 of
    dz's max on integer-grid x, w and b (every pre-activation exact, so the
    decoded slope cannot differ by summation order; dz is then bitwise too)
    with and without the bias, at M = 128 and 6000; bf16 random operands at
    1e-2 at the training encoder's M = 8 x 1500 outside the order band of a
    breakpoint, every slope that is not the plain version's within that band,
    a neighbouring segment's (``_order_band``), timed."""
    from repro_torch.kernels.fused import fused_linear
    from repro_torch.kernels.fused.linear import fused_linear_bwd, fused_linear_bwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, plan, tables = _table(torch, "gelu")
    gen = torch.Generator(device=dev).manual_seed(14)
    K, N = K_DIM, N_DIM
    for M in (128, WHISPER_ENC_M):
        x = _igrid(torch, gen, (M, K), torch.float32)
        w = _igrid(torch, gen, (K, N), torch.float32)
        b = _igrid(torch, gen, (N,), torch.float32, span=64)
        g = torch.randn(M, N, generator=gen, device=dev)
        for bias in (b, None):
            n0 = fused_linear.bwd_launches
            got = fused_linear_bwd(x, w, bias, g, plan, tables)
            check(fused_linear.bwd_launches == n0 + 1, f"fused_linear bwd M={M}: not launched")
            want = fused_linear_bwd_plain(x, w, bias, g, plan, tables)
            torch.cuda.synchronize()
            what = f"fused_linear bwd M={M} f32 {'bias' if bias is not None else 'no bias'}"
            err = _compare_scaled(torch, got, want, 1e-4, what)
            _bitwise(torch, got, want, what)
            print(f"[smoke] {what} on the integer grid: max_abs_err {err:.3g} (bitwise)")
    M = WHISPER_TRAIN_BATCH * WHISPER_FRAMES
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    b = (torch.randn(N, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    g = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
    got = fused_linear_bwd(x, w, b, g, plan, tables)
    want = fused_linear_bwd_plain(x, w, b, g, plan, tables)
    torch.cuda.synchronize()
    near, band = _order_band(torch, x, (w,), b, g, got, plan, tables,
                             f"fused_linear bwd M={M} bf16")
    err = _compare_outside(torch, got, want, near, 1e-2, f"fused_linear bwd M={M} bf16")
    k_ms = time_ms(torch, lambda i: fused_linear_bwd(x, w, b, g, plan, tables), reps=5, iters=4)
    p_ms = time_ms(torch, lambda i: fused_linear_bwd_plain(x, w, b, g, plan, tables), reps=3,
                   iters=3)
    xr, wr, br = (t.detach().requires_grad_(True) for t in (x, w, b))

    def library(i):  # the autograd of addmm, forward included
        return torch.autograd.grad(torch.addmm(br, xr, wr), (xr, wr, br), g)

    l_ms = time_ms(torch, library, reps=5, iters=4)
    nbytes = (M * K + K * N + N + M * N) * 2 + M * N * 4
    row = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
           **_bound(nbytes, 2.0 * M * K * N)}
    print(f"[smoke] fused_linear bwd M={M} K={K} N={N} bf16: max_abs_err {err:.3g}; {band}; "
          f"kernel "
          f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, addmm forward + backward "
          f"{l_ms * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']})")
    return {M: row}


def _whisper_cfg(torch, plan: str, dtype=None):
    from repro_torch import sfu
    from repro_torch.configs import get_config

    cfg = get_config("whisper-small", act_plan=sfu.load_plan(plan),
                     **({} if dtype is None else {"dtype": dtype}))
    check((cfg.d_model, cfg.n_layers, cfg.n_encoder_layers, cfg.encoder_seq, cfg.d_ff,
           cfg.vocab_size) == (WHISPER_D, WHISPER_LAYERS, WHISPER_LAYERS, WHISPER_FRAMES,
                               N_DIM, 51865), "not full-width whisper-small")
    return cfg


def _whisper_batch(torch, cfg, B: int, S: int, seed: int) -> dict:
    """Tokens, targets and stub frames (standard normal in the model dtype,
    as tests/test_archs_smoke.py builds them), from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda"),
            "targets": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda"),
            "frames": torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=gen,
                                  device="cuda").to(cfg.dtype)}


def whisper_serve_phase(torch, plan: str) -> dict:
    """Full-width whisper-small (seed-0 weights, bf16) under the plan with
    every site fused, served as its users call it: ``Model.prefill(...,
    frames=)`` for 4 requests of a 32-token prompt, then 16 greedy
    ``decode_step``s.  Per prefill the fused linear kernel runs 24 times
    (12 encoder MLPs at M = 6000, 12 decoder MLPs at M = 128) and the row
    softmax 36 (the encoder's 4 x 12 x 1500^2 scores fit the dense cap:
    width 1500, non-causal; decoder self and cross); per decode step 12
    linear and 24 softmax launches (self over the dense cache, cross over
    1500 keys).  Logits finite; tok/s and the peak of allocated memory."""
    from repro_torch.models import Model

    cfg = _whisper_cfg(torch, plan)
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    B, S, new = 4, 32, 16
    batch = _whisper_batch(torch, cfg, B, S, seed=1)
    cache = model.make_cache(B, S + new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model.prefill(params, batch["tokens"], cache, frames=batch["frames"])
        check(logits.shape == (B, 1, cfg.padded_vocab), f"prefill logits {tuple(logits.shape)}")
        finite = [torch.isfinite(logits).all()]
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        out = [tok]
        for i in range(new):
            logits = model.decode_step(params, tok, cache, S + i)
            finite.append(torch.isfinite(logits).all())
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            out.append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counters()
    check(bool(torch.stack(finite).all()), "whisper serve: non-finite logits")
    L = cfg.n_layers
    want = {"fused_linear": 2 * L + L * new, "fused_pwl_softmax": 3 * L + 2 * L * new}
    for name, n in counts.items():
        check(n == want.get(name, 0), f"whisper serve: {name} launches {n} != {want.get(name, 0)}")
    toks = torch.cat(out, dim=1)
    print(f"[smoke] whisper-small serve (prefill of 4 x 32 tokens over 1500 frames, {new} decode "
          f"steps): {B * new} tokens in {dt:.3f}s ({B * new / dt:.1f} tok/s), peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, sample {toks[0, :8].tolist()}, "
          f"launches {counts}")
    return counts


WHISPER_STEPS = 4
WHISPER_SELF_POS = 200  # a shard row's decode position in its 448-slot self-attention cache


def whisper_train_phase(torch, plan: str) -> dict:
    """Full-width whisper-small trained through ``launch.steps.build_train_step``
    (f32 masters, bf16 compute, remat per layer) at 8 x 448 target tokens
    over 1500 frames: 4 steps on one fixed batch, whose loss must fall.  The
    encoder's 8 x 12 x 1500^2 scores pass the dense cap, so its attention
    takes the flash kernels, non-causal, forward and backward.  Per step,
    under remat: the fused linear 48 forwards and 24 backwards, the flash
    attention 24 and 12, the row softmax (decoder self and cross) 48 and
    24.  AdamW runs without the global-norm clip: at init whisper-small's
    gradient norm is ~1e16 (the JAX package's is 3.6e15 on a 1 x 64 batch,
    f32 on the CPU: each encoder layer multiplies the backward by ~8), so a
    clip to 1 leaves every leaf but the first encoder layers' under AdamW's
    eps, and the loss does not move (11.344 -> 11.364 in 4 steps on the
    H100); unclipped, AdamW steps every weight by about lr."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    cfg = _whisper_cfg(torch, plan)
    check(cfg.remat, "whisper trains under remat")
    step_fn = build_train_step(cfg, "cuda", opt_cfg=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=WHISPER_STEPS, grad_clip=math.inf))
    state = adamw.init_state(Model(cfg, device="cuda").init(seed=0, master=True))
    batch = _whisper_batch(torch, cfg, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses, times = [], []
    for _ in range(WHISPER_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    counts = read_counters()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"whisper train losses {losses}: did not fall")
    L = cfg.n_layers
    want = {"fused_linear": 4 * L * WHISPER_STEPS, "fused_linear_bwd": 2 * L * WHISPER_STEPS,
            "fused_flash_attention": 2 * L * WHISPER_STEPS,
            "fused_flash_attention_bwd": L * WHISPER_STEPS,
            "fused_pwl_softmax": 4 * L * WHISPER_STEPS,
            "fused_pwl_softmax_bwd": 2 * L * WHISPER_STEPS}
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"whisper train: {name} launches {n} != {want.get(name, 0)}")
    med = sorted(times[1:])[len(times[1:]) // 2]
    tok_s = WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ / med
    print(f"[smoke] whisper-small train {WHISPER_STEPS} steps at {WHISPER_TRAIN_BATCH} x "
          f"{WHISPER_TRAIN_SEQ} tokens over {WHISPER_FRAMES} frames: loss "
          f"{' -> '.join(f'{x:.4f}' for x in losses)}, step {med * 1e3:.1f} ms median of the "
          f"warm steps ({tok_s:.0f} target tokens/s), peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {counts}")
    return {"counts": counts, "step_ms": med * 1e3, "tokens_per_s": tok_s}


def whisper_grad_phase(torch, plan: str):
    """Full-width whisper-small's gradients under the backward kernels
    (``impl_bwd="fused"``: the linear layer's, the flash attention's,
    non-causal, and the row softmax's) against plain recomputation, on the
    training batch (8 x 448 over 1500 frames), as grad_phase holds
    repro-100m's: f32 (TF32 off) at 1e-4 of each leaf's max; bf16 a second
    fused backward bitwise the first, the worst leaf within 4x a yardstick
    (recompute against recompute with the linear layer's dx summed in
    another order, ``_linear_dx_in_halves``), and every leaf at cosine >=
    0.999, or 1 - 4 x the yardstick's own gap where that is lower: at init
    whisper-small's gradient grows ~8x a layer toward the input (the JAX
    package's to 3.6e15 in all), so bf16 roundings move cosines by ~1e-3
    (0.99863 at the lowest in a first run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        cfg = _whisper_cfg(torch, plan, dtype=dtype)
        batch = _whisper_batch(torch, cfg, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, seed=3)
        what = f"whisper-small {dtype} batch {WHISPER_TRAIN_BATCH}x{WHISPER_TRAIN_SEQ}"
        print(_fused_vs_recompute(torch, cfg, batch, what, remat_off_check=False,
                                  reorder=_linear_dx_in_halves))


def whisper_reference_phase(torch, plan: str):
    """Reduced whisper-small (2 + 2 layers, d_model 64, 24 frames) in f32
    (TF32 off) under the fused plan on the card against the CPU: logits of
    ``forward``, the loss, and the logits of ``prefill(frames=)`` and 4
    greedy ``decode_step``s fed the CPU's tokens, at 1e-4."""
    from repro_torch import sfu
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.fused import fused_linear
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced_config("whisper-small", act_plan=sfu.load_plan(plan), dtype=torch.float32)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params = cpu.init(seed=0)
    gparams = _to_cuda(torch, params)
    gen = torch.Generator().manual_seed(4)
    B, S = 2, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (B, S), generator=gen),
             "frames": torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=gen)}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    n0 = fused_linear.launches
    with torch.no_grad():
        got = gpu.forward(gparams, gbatch["tokens"], gbatch["frames"]).cpu()
        want = cpu.forward(params, batch["tokens"], batch["frames"])
        err = _compare_scaled(torch, got, want, 1e-4, "reduced whisper logits cuda vs cpu")
        lg, _ = gpu.loss(gparams, gbatch)
        lc, _ = cpu.loss(params, batch)
        check(abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)),
              f"reduced whisper loss cuda {float(lg)} vs cpu {float(lc)}")
        ccache, gcache = cpu.make_cache(B, S + 4), gpu.make_cache(B, S + 4)
        want = cpu.prefill(params, batch["tokens"], ccache, frames=batch["frames"])
        got = gpu.prefill(gparams, gbatch["tokens"], gcache, frames=gbatch["frames"])
        serve_err = _compare_scaled(torch, got.cpu(), want, 1e-4, "reduced whisper prefill")
        for i in range(4):
            cur = want[:, -1].argmax(dim=-1)[:, None]
            want = cpu.decode_step(params, cur, ccache, S + i)
            got = gpu.decode_step(gparams, cur.cuda(), gcache, S + i)
            serve_err = max(serve_err, _compare_scaled(torch, got.cpu(), want, 1e-4,
                                                       f"reduced whisper decode step {i}"))
    L = cfg.n_layers + cfg.n_encoder_layers
    check(fused_linear.launches == n0 + 2 * L + L + cfg.n_layers * 4,
          "reduced whisper: an MLP skipped the fused linear kernel")
    print(f"[smoke] reduced whisper f32, cuda vs cpu: logits max_abs_err {err:.3g}, loss "
          f"{float(lg):.6f} vs {float(lc):.6f}; prefill + 4 decode steps max_abs_err "
          f"{serve_err:.3g}")


# ---------------------------------------------------------------------------
# slice 7: the fused RMSNorm, the exact and identity epilogues, head_dim 256


NORM_EPILOGUES = ("identity", "gelu PWL f32", "gelu PWL bf16", "gelu PWL int8", "exact gelu")
# also at 4096 x 768 and 4096 x 5120: a 64-breakpoint table and an exact
# function the kernels call out of line
NORM_MORE_EPILOGUES = ("silu PWL f32 64", "exact silu")
NORM_EPS = 1e-6
QWEN_D = 5120  # qwen2.5-32b's d_model: rows past those the kernels hold in registers
NORM_MAX_FLIP_SHARE = 1e-6  # dx whose slope is not the plain version's, at 4096 x 5120


def _epilogue_kwargs(name: str) -> dict:
    """``table=`` or ``act=`` of a named epilogue: "identity", "exact <fn>" or
    "<fn> PWL <format> [<breakpoints>]" (32 breakpoints unless named)."""
    from repro_torch import sfu

    if name == "identity":
        return {}
    if name.startswith("exact "):
        return {"act": name.split()[1]}
    fn, _, fmt, *n = name.split()
    return {"table": sfu.get_store().get(fn=fn, n_breakpoints=int(n[0]) if n else 32,
                                         dtype=fmt)}


def _epilogue_operands(torch, kw: dict):
    """``(plan, operands)`` twice for an epilogue's kwargs: as the plain
    versions take them (a bf16 table in its native layout) and as the kernel
    wrappers take them (the f32 delta layout), both on the card."""
    from repro_torch.kernels.fused.epilogue import device_operands, plan_and_operands

    plan, tables = plan_and_operands(kw.get("table"), kw.get("act"))
    kplan, ktables = device_operands(kw.get("table"), kw.get("act"), "cuda")
    return (plan, tuple(t.cuda() for t in tables)), (kplan, ktables)


def _norm_bound(M: int, D: int, esize: int, n_bp: int, backward: bool,
                chain: bool = False) -> dict:
    """The fused RMSNorm's least time: x read and y written once (the
    backward: x and g read, dx written in f32, ds written), scale read once;
    against ~4 f32 operations an element for the normalisation (10 for the
    backward) and, with a table, the breakpoint search's ``SEARCH_OPS``
    (``chain``: the linear chain's ~3 a breakpoint, the decode before slice
    12).  An exact function's libm operations are not counted (at 4096 x 768
    they would need over 60 an element to pass the bytes)."""
    if backward:
        nbytes = M * D * (2 * esize + 4) + 2 * D * 4
    else:
        nbytes = 2 * M * D * esize + D * 4
    decode = (3 * n_bp if chain else SEARCH_OPS) if n_bp else 0
    return _f32_bound(nbytes, M * D * ((10 if backward else 4) + decode))


def _norm_band(torch, x, s, g, got, want, plan, tables, tol, what):
    """The RMSNorm backward kernel's dx against the plain version's
    (``want``), element by element, where a slope may differ: the kernel sums
    x² in another order and rounds its rsqrt apart, so its pre-activation y
    lies within ``ORDER_BAND_C`` (D + 10) 2⁻²⁴ |y| of the plain version's,
    and where that band holds a breakpoint the kernel may take the
    breakpoint's other segment.  An element is marked where its dx is off
    by more than ``tol`` of max |want|.  Every marked element must lie
    within the band of a breakpoint and be within that tolerance of the dx
    one of the breakpoint's two segments gives (the row's mean term kept);
    the marked share is bounded by ``NORM_MAX_FLIP_SHARE``.  Returns the max
    abs error of the unmarked elements and the line to print."""
    u = 2.0 ** -24
    D = x.shape[-1]
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(xf.square().sum(dim=-1, keepdim=True) / D + NORM_EPS)
    xh = xf * r
    w = 1.0 + s.float()
    y = xh * w
    du = gf * plan.apply_value_and_slope(y, *tables)[1] * w
    c = (du * xh).sum(dim=-1, keepdim=True) / D
    limit = tol * want.abs().max()
    marked = (got - want).abs() > limit
    bps = tables[0].reshape(-1).float()
    dist = torch.full_like(y, math.inf)
    nearest = torch.zeros_like(y, dtype=torch.long)
    for i, b in enumerate(bps.tolist()):
        d = (y - b).abs()
        closer = d < dist
        dist = torch.where(closer, d, dist)
        nearest = torch.where(closer, i, nearest)
    near = dist <= ORDER_BAND_C * (D + 10) * u * y.abs()
    b = bps[nearest]
    explained = torch.zeros_like(marked)
    for t in (b, torch.nextafter(b, torch.full_like(b, math.inf))):
        side = r * (gf * plan.apply_value_and_slope(t, *tables)[1] * w - xh * c)
        explained |= (got - side).abs() <= limit
    outside, wrong = int((marked & ~near).sum()), int((marked & ~explained).sum())
    flips, in_band = int(marked.sum()) / marked.numel(), int(near.sum()) / marked.numel()
    check(outside == 0, f"{what}: {outside} dx differ from the plain version's outside the "
                        "rounding band of a breakpoint")
    check(wrong == 0, f"{what}: {wrong} dx are neither segment's at their breakpoint")
    check(flips <= NORM_MAX_FLIP_SHARE, f"{what}: dx mismatch share {flips:.3g}")
    err = (got - want).abs().masked_fill(marked, 0.0).max().item()
    return err, (f"{int(marked.sum())} dx ({flips:.3g}) each within the rounding band of a "
                 f"breakpoint with a neighbouring segment's slope; the band holds {in_band:.3g}")


def norm_phase(torch):
    """``fused_rmsnorm`` (TPU kernels 17-18) on CUDA tensors against its
    plain versions: the forward through ``fused_rmsnorm`` (its launches
    counted), the backward through autograd under ``impl_bwd="fused"`` (its
    ``bwd_launches`` counted; the gradient of x must be the kernel's dx) and
    through ``fused_rmsnorm_bwd``.  Shapes: repro-100m's training rows (4096
    x 768), olmoe-1b-7b's width (4096 x 2048: the forward's rows over 2
    warps, the backward's streamed) and qwen2.5-32b's (4096 x 5120, streamed
    both ways: past the rows the kernels hold in registers) in bf16 (1e-2);
    the JAX tests' odd widths (33 x 40, 21 x 48) and 37 x 3000 (the
    forward's rows over 4 warps, the backward's streamed) in f32 (forward
    1e-5, dx and ds 1e-4 of each one's max).  Each with the identity, gelu
    PWL (f32, bf16 and int8 tables) and exact gelu epilogues, and at 4096 x
    768 and 4096 x 5120 also a 64-breakpoint silu table and exact silu
    (called out of line).  With a table at 4096 x 5120, where the row sums
    5120 squares, dx is held by ``_norm_band``: a slope may flip at a
    breakpoint within the rounding band of r.  ds must be bitwise the
    same from a second backward.  Timed at 4096 x 768 (every epilogue but
    the bf16 and int8 tables) and at 4096 x 2048 and 4096 x 5120 (the f32
    table), against ``torch.nn.functional.rms_norm`` (weight 1 + scale) and
    its autograd; each bound is printed beside the one the linear chain's
    decode had, each backward beside the time of the ``torch.sum`` of its
    16-row ds partials alone."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.fused import fused_rmsnorm
    from repro_torch.kernels.fused.norm import (
        fused_rmsnorm_bwd,
        fused_rmsnorm_bwd_plain,
        fused_rmsnorm_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    cases = [  # (name, M, D, dtype)
        (f"{TRAIN_TOKENS} x {K_DIM} bf16", TRAIN_TOKENS, K_DIM, torch.bfloat16),
        (f"{TRAIN_TOKENS} x {MOE_K} bf16", TRAIN_TOKENS, MOE_K, torch.bfloat16),
        (f"{TRAIN_TOKENS} x {QWEN_D} bf16", TRAIN_TOKENS, QWEN_D, torch.bfloat16),
        ("33 x 40 f32", 33, 40, torch.float32),
        ("21 x 48 f32", 21, 48, torch.float32),
        ("37 x 3000 f32", 37, 3000, torch.float32),
    ]
    rows = {}
    for name, M, D, dtype in cases:
        tol, gtol = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
        x = (torch.randn(M, D, generator=gen, device=dev) * 3.0).to(dtype)
        s = torch.randn(D, generator=gen, device=dev) * 0.3
        g = torch.randn(M, D, generator=gen, device=dev).to(dtype)
        more = NORM_MORE_EPILOGUES if D in (K_DIM, QWEN_D) else ()
        for ep in NORM_EPILOGUES + more:
            kw = _epilogue_kwargs(ep)
            (plan, tables), (kplan, ktables) = _epilogue_operands(torch, kw)
            what = f"fused_rmsnorm {name} {ep}"
            xr = x.detach().requires_grad_(True)
            n0, b0 = fused_rmsnorm.launches, fused_rmsnorm.bwd_launches
            y = fused_rmsnorm(xr, s, impl_bwd="fused", **kw)
            check(fused_rmsnorm.launches == n0 + 1, f"{what}: forward kernel not launched")
            y.backward(g)
            check(fused_rmsnorm.bwd_launches == b0 + 1, f"{what}: backward kernel not launched")
            want = fused_rmsnorm_plain(x, s, plan, tables, NORM_EPS)
            dx, ds = fused_rmsnorm_bwd(x, s, g, kplan, ktables)
            _, ds2 = fused_rmsnorm_bwd(x, s, g, kplan, ktables)
            wdx, wds = fused_rmsnorm_bwd_plain(x, s, g, plan, tables, NORM_EPS)
            torch.cuda.synchronize()
            check(y.dtype == dtype, f"{what}: output {y.dtype}")
            err = _compare(torch, y, want, tol, what)
            band = ""
            if "PWL" in ep and D == QWEN_D:  # a slope may flip at a breakpoint
                dx_err, band = _norm_band(torch, x, s, g, dx, wdx, plan, tables, gtol,
                                          f"{what} dx")
                band = f"; {band}"
            else:
                dx_err = _compare_scaled(torch, dx, wdx, gtol, f"{what} dx")
            errs = [dx_err, _compare_scaled(torch, ds, wds, gtol, f"{what} ds")]
            check(torch.equal(xr.grad, dx.to(dtype)), f"{what}: autograd's dx is not the kernel's")
            check(torch.equal(ds, ds2), f"{what}: ds differs between two backward calls")
            line = (f"[smoke] fused_rmsnorm {name} {ep}: max_abs_err {err:.3g} (tol {tol}), "
                    f"backward dx {errs[0]:.3g} ds {errs[1]:.3g} (tol {gtol} of each max), ds "
                    f"bitwise repeatable{band}")
            timed = (M == TRAIN_TOKENS and ep in ("identity", "gelu PWL f32", "exact gelu")
                     and (D == K_DIM or ep == "gelu PWL f32"))
            if timed:
                n_bp = kw["table"].bp.numel() if "table" in kw else 0
                w1 = (1.0 + s).to(dtype)
                k_ms = time_ms(torch, lambda i: fused_rmsnorm(x, s, **kw))
                p_ms = time_ms(torch, lambda i: fused_rmsnorm_plain(x, s, plan, tables,
                                                                    NORM_EPS), reps=5, iters=4)
                l_ms = time_ms(torch, lambda i: Fn.rms_norm(x, (D,), weight=w1, eps=NORM_EPS))
                kb_ms = time_ms(torch, lambda i: fused_rmsnorm_bwd(x, s, g, kplan, ktables))
                part = torch.zeros((-(-M // 16), D), device=dev)  # the 16-row ds partials
                sum_ms = time_ms(torch, lambda i: part.sum(dim=0))
                pb_ms = time_ms(torch, lambda i: fused_rmsnorm_bwd_plain(
                    x, s, g, plan, tables, NORM_EPS), reps=5, iters=4)
                xl, wl = x.detach().requires_grad_(True), w1.detach().requires_grad_(True)

                def library(i):  # the autograd of rms_norm, forward included
                    return torch.autograd.grad(Fn.rms_norm(xl, (D,), weight=wl, eps=NORM_EPS),
                                               (xl, wl), g)

                lb_ms = time_ms(torch, library)
                esize = x.element_size()
                rows[(name, ep)] = {
                    "fwd": {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                            **_norm_bound(M, D, esize, n_bp, backward=False)},
                    "bwd": {"ms": kb_ms, "plain_ms": pb_ms, "library_ms": lb_ms,
                            "max_abs_err": max(errs),
                            **_norm_bound(M, D, esize, n_bp, backward=True)}}
                r = rows[(name, ep)]
                old = [_norm_bound(M, D, esize, n_bp, backward=b, chain=True)["bound_ms"]
                       for b in (False, True)]
                line += (f"; forward kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
                         f"F.rms_norm {l_ms * 1e3:.2f} us, bound {r['fwd']['bound_ms'] * 1e3:.2f}"
                         f" us ({r['fwd']['bound_by']}; the chain's {old[0] * 1e3:.2f}); "
                         f"backward kernel {kb_ms * 1e3:.2f} us (of it the partials' torch.sum "
                         f"{sum_ms * 1e3:.2f} us), plain {pb_ms * 1e3:.2f} us, "
                         f"autograd of F.rms_norm {lb_ms * 1e3:.2f} us, bound "
                         f"{r['bwd']['bound_ms'] * 1e3:.2f} us ({r['bwd']['bound_by']}; the "
                         f"chain's {old[1] * 1e3:.2f})")
            print(line)
    return rows


def norm_path(torch) -> dict:
    """The slice's own path, the op through its public entry point (no model
    calls it, in the JAX package or here): at each of repro-100m's training
    rows (4096 x 768), olmoe's width (4096 x 2048) and qwen2.5-32b's (4096 x
    5120), in bf16 with the gelu table, counters reset, one forward and one
    backward of ``fused_rmsnorm`` under autograd, counters read.  Returns
    the counts by width."""
    from repro_torch.kernels.fused import fused_rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    counts = {}
    for D in (K_DIM, MOE_K, QWEN_D):
        x = torch.randn(TRAIN_TOKENS, D, generator=gen, device=dev).to(torch.bfloat16)
        s = (torch.randn(D, generator=gen, device=dev) * 0.3).requires_grad_(True)
        xr = x.requires_grad_(True)
        reset_counters()
        y = fused_rmsnorm(xr, s, **_epilogue_kwargs("gelu PWL f32"))
        torch.cos(y.float()).sum().backward()
        torch.cuda.synchronize()
        counts[D] = read_counters()
        check(bool(torch.isfinite(xr.grad.float()).all()) and bool(torch.isfinite(s.grad).all()),
              f"fused_rmsnorm path D={D}: non-finite gradients")
        check(counts[D]["fused_rmsnorm"] == 1 and counts[D]["fused_rmsnorm_bwd"] == 1,
              f"fused_rmsnorm path D={D}: launches {counts[D]}")
    return counts


def _kink_grid(torch, gen, shape, dtype, span, step):
    """Integer-grid values: every product and sum of them is exact in f32, so
    the kernel's pre-activations equal the plain version's bit for bit and
    the kinks -3, 0 and 3 are hit exactly."""
    ints = torch.randint(-span, span + 1, shape, generator=gen, device="cuda")
    return (ints.to(torch.float32) * step).to(dtype)


def _check_kinks(torch, z, what: str) -> None:
    for k in (-3.0, 0.0, 3.0):
        check(bool((z == k).any()), f"{what}: no pre-activation at the kink {k}")


def exact_epilogue_phase(torch):
    """Every kernel that takes an epilogue plan, under exact (``act=``) and
    identity plans, against its plain version on the card, forward and
    backward: the GLU (gelu, hardswish, identity) at M = 512, K = 768,
    N = 3072, the MoE GLU (the same) at E = 3, C = 37, K = 65, N = 130, the
    linear layer (gelu, hardswish, tanh, identity) at M = 128, K = 768,
    N = 3072 with a bias, in f32 on integer grids whose pre-activations hit
    -3, 0 and 3 exactly (1e-4 of each output's max, as the PWL cases); the
    row softmax, the split-KV decode and the flash attention with no table
    (the exact exp inside the clamps; softmax rows at 1e-5, decode 1e-5,
    flash forward 1e-5 and backward 1e-4, integer-grid scores with ties).
    Timed at the main paths' shapes in bf16: the GLU at M = 4096 (gelu
    forward and backward, identity forward), the MoE GLU at olmoe's decode
    step (C = 1, gelu), the linear layer at whisper's decode step (M = 4)
    and its backward at the training encoder's M = 12000 (gelu), the row
    softmax forward and backward at the training rows, the decode at the
    serving step, the flash forward and backward at S = T = 4096."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.fused import (
        fused_flash_attention,
        fused_glu,
        fused_linear,
        fused_moe_glu,
        fused_pwl_softmax,
        paged_flash_decode,
    )
    from repro_torch.kernels.fused import attention as A
    from repro_torch.kernels.fused.decoding import paged_flash_decode_plain
    from repro_torch.kernels.fused.glu import fused_glu_bwd, fused_glu_bwd_plain, fused_glu_plain
    from repro_torch.kernels.fused.linear import (
        fused_linear_bwd,
        fused_linear_bwd_plain,
        fused_linear_plain,
    )
    from repro_torch.kernels.fused.softmax import (
        fused_pwl_softmax_bwd,
        fused_pwl_softmax_bwd_plain,
        fused_pwl_softmax_plain,
        static_mask,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}

    def gated(name, fwd_kernel, fwd_plain, bwd_kernel, bwd_plain, counter, n_out):
        """forward and backward of one epilogue against the plain versions"""
        n0, b0 = counter.launches, counter.bwd_launches
        got, want = fwd_kernel(), fwd_plain()
        gb, wb = bwd_kernel(), bwd_plain()
        check(counter.launches == n0 + 1 and counter.bwd_launches == b0 + 1,
              f"{name}: kernels not launched")
        torch.cuda.synchronize()
        err = _compare_scaled(torch, got, want, 1e-4, name)
        gb, wb = (gb, wb) if n_out == 2 else ((gb,), (wb,))
        errs = [_compare_scaled(torch, a, b, 1e-4, f"{name} backward") for a, b in zip(gb, wb)]
        print(f"[smoke] {name}: max_abs_err {err:.3g}, backward {max(errs):.3g} (tol 1e-4 of "
              "each max)")

    # the GLU and the MoE GLU: x on a 1/2 grid, weights on a 1/2 grid
    for what, shape_x, shape_w, counter in (
            ("fused_glu M=512 K=768 N=3072", (512, K_DIM), (K_DIM, N_DIM), fused_glu),
            ("fused_moe_glu E=3 C=37 K=65 N=130", (3, 37, 65), (3, 65, 130), fused_moe_glu)):
        x = _kink_grid(torch, gen, shape_x, f32, 2, 0.5)
        wg = _kink_grid(torch, gen, shape_w, f32, 1, 0.5)
        wu = _kink_grid(torch, gen, shape_w, f32, 1, 0.5)
        g = torch.randn(*shape_x[:-1], shape_w[-1], generator=gen, device=dev)
        _check_kinks(torch, x @ wg, what)
        for act in ("gelu", "hardswish", None):
            (plan, tables), _ = _epilogue_operands(torch, {"act": act})
            gated(f"{what} {act or 'identity'} f32", lambda: counter(x, wg, wu, act=act),
                  lambda: fused_glu_plain(x, wg, wu, plan, tables),
                  lambda: fused_glu_bwd(x, wg, wu, g, plan, tables, counter),
                  lambda: fused_glu_bwd_plain(x, wg, wu, g, plan, tables), counter, 2)

    # the linear layer, with a bias on the 1/2 grid
    x = _kink_grid(torch, gen, (128, K_DIM), f32, 2, 0.5)
    w = _kink_grid(torch, gen, (K_DIM, N_DIM), f32, 1, 0.5)
    b = _kink_grid(torch, gen, (N_DIM,), f32, 4, 0.5)
    g = torch.randn(128, N_DIM, generator=gen, device=dev)
    _check_kinks(torch, x @ w + b, "fused_linear")
    for act in ("gelu", "hardswish", "tanh", None):
        (plan, tables), _ = _epilogue_operands(torch, {"act": act})
        gated(f"fused_linear M=128 K=768 N=3072 bias {act or 'identity'} f32",
              lambda: fused_linear(x, w, b, act=act),
              lambda: fused_linear_plain(x, w, b, plan, tables),
              lambda: fused_linear_bwd(x, w, b, g, plan, tables),
              lambda: fused_linear_bwd_plain(x, w, b, g, plan, tables), fused_linear, 1)

    # the softmax chains with the exact exp (no table)
    (eplan, etabs), _ = _epilogue_operands(torch, {"act": "exp"})
    B, S = TRAIN_BATCH, TRAIN_SEQ
    xs = _kink_grid(torch, gen, (B, 1, HKV, S, S), f32, 24, 0.125)
    gs = torch.randn(xs.shape, generator=gen, device=dev)
    x2, g2 = xs.reshape(-1, S), gs.reshape(-1, S)
    mask2 = static_mask(x2.shape[0], S, S, True, None, device=dev)
    live = mask2 > 0
    xr = xs.clone().requires_grad_(True)
    n0, b0 = fused_pwl_softmax.launches, fused_pwl_softmax.bwd_launches
    got = fused_pwl_softmax(xr, causal=True)
    (gx,) = torch.autograd.grad(got, xr, gs)
    check(fused_pwl_softmax.launches == n0 + 1 and fused_pwl_softmax.bwd_launches == b0 + 1,
          "softmax exact exp: kernels not launched")
    err = _compare_probs(torch, got, fused_pwl_softmax_plain(x2, mask2, eplan, etabs), live, 1e-5,
                         "softmax exact exp")
    errb = _compare_rows(torch, gx, fused_pwl_softmax_bwd_plain(x2, mask2, g2, eplan, etabs),
                         live, 1e-5, "softmax exact exp backward")
    print(f"[smoke] fused_pwl_softmax {TRAIN_SOFTMAX} exact exp: max_abs_err {err:.3g}, backward "
          f"{errb:.3g} (rows at 1e-5)")
    k_ms = time_ms(torch, lambda i: fused_pwl_softmax(xs, causal=True))
    p_ms = time_ms(torch, lambda i: fused_pwl_softmax_plain(x2, mask2, eplan, etabs), reps=5,
                   iters=4)
    l_ms = time_ms(torch, lambda i: torch.softmax(xs, dim=-1))
    n = xs.numel()
    rows["fused_pwl_softmax"] = {
        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
        **_bound(_softmax_bytes(n, int(live.sum()), 1, False), 0.0)}
    k_ms = time_ms(torch, lambda i: fused_pwl_softmax_bwd(x2, None, g2, eplan, etabs, S, True),
                   reps=5, iters=4)
    p_ms = time_ms(torch, lambda i: fused_pwl_softmax_bwd_plain(x2, mask2, g2, eplan, etabs),
                   reps=2, iters=2)
    xl = xs.clone().requires_grad_(True)  # a leaf whose graph no earlier call keeps alive
    l_ms = time_ms(torch, lambda i: torch.autograd.grad(torch.softmax(xl, dim=-1), xl, gs),
                   reps=5, iters=4)
    rows["fused_pwl_softmax_bwd"] = {
        "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": errb,
        **_bound(_softmax_bytes(n, int(live.sum()), 2, False), 0.0)}

    # the split-KV decode, exact exp
    kv_len, n_cols, P = [19, 32, 15, 0], 4, 17
    tab = torch.zeros((4, n_cols), dtype=torch.int32)
    for bi, r in enumerate(_fragmented_table(4, n_cols, P)):
        tab[bi, :len(r)] = torch.tensor(r)
    tab, lens = tab.to(dev), torch.tensor(kv_len, dtype=torch.int32, device=dev)
    for dtype, tol in ((bf16, 1e-2), (f32, 1e-5)):
        q = torch.randn(4, 1, HKV, DH, generator=gen, device=dev).to(dtype)
        kp = torch.randn(HKV, P, PS, DH, generator=gen, device=dev).to(dtype)
        vp = torch.randn(HKV, P, PS, DH, generator=gen, device=dev).to(dtype)
        n0 = paged_flash_decode.launches
        got = paged_flash_decode(q, kp, vp, tab, lens)
        check(paged_flash_decode.launches == n0 + 1, "decode exact exp: not launched")
        want = paged_flash_decode_plain(q, kp, vp, tab, lens, eplan, etabs, n_cols)
        torch.cuda.synchronize()
        err = _compare(torch, got, want, tol, f"decode exact exp {dtype}")
        print(f"[smoke] paged_flash_decode B=4 kv_len {{19,32,15,0}} exact exp {dtype}: "
              f"max_abs_err {err:.3g} (tol {tol})")
    qb, kb, vb = q.to(bf16), kp.to(bf16), vp.to(bf16)
    k_ms = time_ms(torch, lambda i: paged_flash_decode(qb, kb, vb, tab, lens))
    p_ms = time_ms(torch, lambda i: paged_flash_decode_plain(qb, kb, vb, tab, lens, eplan, etabs,
                                                             n_cols), reps=3, iters=3)
    live_pages = sum(-(-n // PS) for n in kv_len)
    nbytes = 2 * live_pages * PS * DH * HKV * 2 + 2 * qb.numel() * 2 + tab.numel() * 4 + 16
    rows["paged_flash_decode"] = {"ms": k_ms, "plain_ms": p_ms,
                                  "library_ms": _decode_sdpa_ms(torch, qb, kb, vb, tab, lens),
                                  "max_abs_err": err,
                                  **_bound(nbytes, 4.0 * sum(kv_len) * HKV * DH)}

    # the flash attention, exact exp: forward and backward, integer grids
    for name, S_, T_, H, hkv, dtype, timed in (
            ("S=T=1000 causal H=4 Hkv=2", 1000, 1000, 4, 2, f32, False),
            ("S=T=4096 causal H=12", LONG_SEQ, LONG_SEQ, 12, HKV, bf16, True)):
        q = _igrid(torch, gen, (1, S_, H, DH), dtype)
        k = _igrid(torch, gen, (1, T_, hkv, DH), dtype)
        v = _igrid(torch, gen, (1, T_, hkv, DH), dtype)
        dout = _igrid(torch, gen, (1, S_, H, DH), dtype)
        kw = dict(causal=True, window=None, q_offset=0, kv_valid_len=None)
        n0 = fused_flash_attention.launches
        got = fused_flash_attention(q, k, v, causal=True)
        check(fused_flash_attention.launches == n0 + 1, "flash exact exp: not launched")
        _, m = A._launch(q, k, v, eplan, etabs, True, None, 0, None, True)
        want, m_plain = A.fused_flash_attention_plain(q, k, v, eplan, etabs, **kw)
        b0 = fused_flash_attention.bwd_launches
        grads = A.fused_flash_attention_bwd(q, k, v, dout, m, eplan, etabs, **kw)
        check(fused_flash_attention.bwd_launches == b0 + 1, "flash exact exp bwd: not launched")
        wgrads = A.fused_flash_attention_bwd_plain(q, k, v, dout, m, eplan, etabs, **kw)
        torch.cuda.synchronize()
        what = f"flash {name} exact exp {dtype}"
        check(torch.equal(m, m_plain), f"{what}: the kernel's row max is not the plain one's")
        tol = 1e-2 if dtype == bf16 else 1e-5
        err = _compare(torch, got, want, tol, what)
        errs = [_compare_scaled(torch, a, b_, 1e-2 if dtype == bf16 else 1e-4, f"{what} d{n}")
                for n, a, b_ in zip("qkv", grads, wgrads)]
        print(f"[smoke] fused_flash_attention {name} exact exp {dtype}: max_abs_err {err:.3g}, "
              f"backward {max(errs):.3g}")
        if timed:
            pairs = H * S_ * (S_ + 1) / 2
            qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
            k_ms = time_ms(torch, lambda i: fused_flash_attention(q, k, v, causal=True),
                           reps=5, iters=4)
            p_ms = time_ms(torch, lambda i: A.fused_flash_attention_plain(
                q, k, v, eplan, etabs, **kw), reps=2, iters=2)
            l_ms = time_ms(torch, lambda i: Fn.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))
            rows["fused_flash_attention"] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                **_bound((2 * q.numel() + 2 * k.numel()) * 2, 4.0 * pairs * DH)}
            kb_ms = time_ms(torch, lambda i: A.fused_flash_attention_bwd(
                q, k, v, dout, m, eplan, etabs, **kw), reps=3, iters=3)
            pb_ms = time_ms(torch, lambda i: A.fused_flash_attention_bwd_plain(
                q, k, v, dout, m, eplan, etabs, **kw), reps=1, iters=2)
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (qh, kh, vh))
            doh = dout.permute(0, 2, 1, 3).contiguous()
            lb_ms = time_ms(torch, lambda i: torch.autograd.grad(
                Fn.scaled_dot_product_attention(qg, kg, vg, is_causal=True), (qg, kg, vg), doh),
                reps=5, iters=4)
            rows["fused_flash_attention_bwd"] = {
                "ms": kb_ms, "plain_ms": pb_ms, "library_ms": lb_ms, "max_abs_err": max(errs),
                **_bound(7 * q.numel() * 2 + m.numel() * 4, 10.0 * pairs * DH)}

    # timings of the matmul-family kernels at the main paths' shapes, bf16
    (gplan, gtabs), _ = _epilogue_operands(torch, {"act": "gelu"})
    x = torch.randn(TRAIN_TOKENS, K_DIM, generator=gen, device=dev).to(bf16)
    wg = (torch.randn(K_DIM, N_DIM, generator=gen, device=dev) / math.sqrt(K_DIM)).to(bf16)
    wu = (torch.randn(K_DIM, N_DIM, generator=gen, device=dev) / math.sqrt(K_DIM)).to(bf16)
    g = torch.randn(TRAIN_TOKENS, N_DIM, generator=gen, device=dev).to(bf16)
    wcat = torch.cat([wg, wu], dim=1)
    for act, key in (("gelu", "fused_glu"), (None, "fused_glu identity")):
        (plan, tables), _ = _epilogue_operands(torch, {"act": act})
        err = _compare(torch, fused_glu(x, wg, wu, act=act),
                       fused_glu_plain(x, wg, wu, plan, tables), 1e-2, f"fused_glu M=4096 {act} bf16")
        rows[key] = {"ms": time_ms(torch, lambda i: fused_glu(x, wg, wu, act=act), reps=5,
                                   iters=4),
                     "plain_ms": time_ms(torch, lambda i: fused_glu_plain(x, wg, wu, plan, tables),
                                         reps=3, iters=3),
                     "library_ms": time_ms(torch, lambda i: torch.matmul(x, wcat), reps=5, iters=4),
                     "max_abs_err": err,
                     **_bound((TRAIN_TOKENS * K_DIM + 2 * K_DIM * N_DIM + TRAIN_TOKENS * N_DIM) * 2,
                              4.0 * TRAIN_TOKENS * K_DIM * N_DIM)}
    dzg, dzu = fused_glu_bwd(x, wg, wu, g, gplan, gtabs)
    wdzg, wdzu = fused_glu_bwd_plain(x, wg, wu, g, gplan, gtabs)
    err = max(_compare_scaled(torch, dzg, wdzg, 1e-2, "fused_glu bwd gelu bf16"),
              _compare_scaled(torch, dzu, wdzu, 1e-2, "fused_glu bwd gelu bf16"))
    rows["fused_glu_bwd"] = {
        "ms": time_ms(torch, lambda i: fused_glu_bwd(x, wg, wu, g, gplan, gtabs), reps=5, iters=4),
        "plain_ms": time_ms(torch, lambda i: fused_glu_bwd_plain(x, wg, wu, g, gplan, gtabs),
                            reps=3, iters=3),
        "library_ms": time_ms(torch, lambda i: torch.matmul(x, wcat), reps=5, iters=4),
        "max_abs_err": err,
        **_bound((TRAIN_TOKENS * K_DIM + 2 * K_DIM * N_DIM + TRAIN_TOKENS * N_DIM) * 2
                 + 2 * TRAIN_TOKENS * N_DIM * 4, 4.0 * TRAIN_TOKENS * K_DIM * N_DIM)}
    # the MoE GLU at olmoe's decode step: E = 64, C = 1
    xm = torch.randn(MOE_E, 1, MOE_K, generator=gen, device=dev).to(bf16)
    wgm = (torch.randn(MOE_E, MOE_K, MOE_N, generator=gen, device=dev) / math.sqrt(MOE_K)).to(bf16)
    wum = (torch.randn(MOE_E, MOE_K, MOE_N, generator=gen, device=dev) / math.sqrt(MOE_K)).to(bf16)
    wmcat = torch.cat([wgm, wum], dim=2)
    err = _compare(torch, fused_moe_glu(xm, wgm, wum, act="gelu"),
                   fused_glu_plain(xm, wgm, wum, gplan, gtabs), 1e-2, "fused_moe_glu C=1 gelu")
    rows["fused_moe_glu"] = {
        "ms": time_ms(torch, lambda i: fused_moe_glu(xm, wgm, wum, act="gelu"), reps=5, iters=4),
        "plain_ms": time_ms(torch, lambda i: fused_glu_plain(xm, wgm, wum, gplan, gtabs), reps=3,
                            iters=3),
        "library_ms": time_ms(torch, lambda i: torch.bmm(xm, wmcat), reps=5, iters=4),
        "max_abs_err": err,
        **_bound(_moe_bytes(MOE_E, 1, MOE_K, MOE_N, 2), 4.0 * MOE_E * MOE_K * MOE_N)}
    del wgm, wum, wmcat
    # the linear layer: whisper's decode step forward, the training encoder's backward
    w = (torch.randn(K_DIM, N_DIM, generator=gen, device=dev) / math.sqrt(K_DIM)).to(bf16)
    b = (torch.randn(N_DIM, generator=gen, device=dev) * 0.1).to(bf16)
    x4 = torch.randn(4, K_DIM, generator=gen, device=dev).to(bf16)
    err = _compare(torch, fused_linear(x4, w, b, act="gelu"),
                   fused_linear_plain(x4, w, b, gplan, gtabs), 1e-2, "fused_linear M=4 gelu")
    rows["fused_linear"] = {
        "ms": time_ms(torch, lambda i: fused_linear(x4, w, b, act="gelu")),
        "plain_ms": time_ms(torch, lambda i: fused_linear_plain(x4, w, b, gplan, gtabs), reps=3,
                            iters=3),
        "library_ms": time_ms(torch, lambda i: torch.addmm(b, x4, w)), "max_abs_err": err,
        **_bound((4 * K_DIM + K_DIM * N_DIM + N_DIM + 4 * N_DIM) * 2, 2.0 * 4 * K_DIM * N_DIM)}
    M = WHISPER_TRAIN_BATCH * WHISPER_FRAMES
    xl = torch.randn(M, K_DIM, generator=gen, device=dev).to(bf16)
    gl = torch.randn(M, N_DIM, generator=gen, device=dev).to(bf16)
    err = _compare_scaled(torch, fused_linear_bwd(xl, w, b, gl, gplan, gtabs),
                          fused_linear_bwd_plain(xl, w, b, gl, gplan, gtabs), 1e-2,
                          "fused_linear bwd M=12000 gelu")
    xlr, wr, br = (t.detach().requires_grad_(True) for t in (xl, w, b))
    rows["fused_linear_bwd"] = {
        "ms": time_ms(torch, lambda i: fused_linear_bwd(xl, w, b, gl, gplan, gtabs), reps=5,
                      iters=4),
        "plain_ms": time_ms(torch, lambda i: fused_linear_bwd_plain(xl, w, b, gl, gplan, gtabs),
                            reps=3, iters=3),
        "library_ms": time_ms(torch, lambda i: torch.autograd.grad(
            torch.addmm(br, xlr, wr), (xlr, wr, br), gl), reps=5, iters=4),
        "max_abs_err": err,
        **_bound((M * K_DIM + K_DIM * N_DIM + N_DIM + M * N_DIM) * 2 + M * N_DIM * 4,
                 2.0 * M * K_DIM * N_DIM)}
    for key, r in rows.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        print(f"[smoke] exact/identity epilogue {key}: kernel {r['ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']})")
    return rows


def exact_path(torch) -> dict:
    """The exact and identity epilogues through the ops' public entry points
    (no model path takes them: the models always pass a table): counters
    reset, then a forward and, where the op has one, a backward under
    autograd of each at a small shape, counters read."""
    from repro_torch.kernels import fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).requires_grad_(True)

    reset_counters()
    outs = [fused.fused_glu(rnd(64, K_DIM), rnd(K_DIM, N_DIM), rnd(K_DIM, N_DIM), act="gelu"),
            fused.fused_moe_glu(rnd(4, 8, 64), rnd(4, 64, 96), rnd(4, 64, 96), act="hardswish"),
            fused.fused_linear(rnd(64, K_DIM), rnd(K_DIM, N_DIM), rnd(N_DIM), act="gelu"),
            fused.fused_linear(rnd(64, K_DIM), rnd(K_DIM, N_DIM), rnd(N_DIM)),
            fused.fused_rmsnorm(rnd(64, K_DIM), rnd(K_DIM), act="gelu"),
            fused.fused_pwl_softmax(rnd(2, HKV, 32, 32), causal=True),
            fused.fused_flash_attention(rnd(1, 256, HKV, DH), rnd(1, 256, HKV, DH),
                                        rnd(1, 256, HKV, DH))]
    torch.stack([torch.cos(o.float()).sum() for o in outs]).sum().backward()
    pt = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4) + 1
    fused.paged_flash_decode(torch.randn(2, 1, HKV, DH, device=dev),
                             torch.randn(HKV, 9, PS, DH, device=dev),
                             torch.randn(HKV, 9, PS, DH, device=dev), pt,
                             torch.tensor([40, 64], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    counts = read_counters()
    want = {"fused_glu": 1, "fused_moe_glu": 1, "fused_linear": 2, "fused_rmsnorm": 1,
            "fused_pwl_softmax": 1, "fused_flash_attention": 1, "paged_flash_decode": 1,
            "fused_glu_bwd": 1, "fused_moe_glu_bwd": 1, "fused_linear_bwd": 2,
            "fused_rmsnorm_bwd": 1, "fused_pwl_softmax_bwd": 1, "fused_flash_attention_bwd": 1}
    for name, n in counts.items():
        check(n == want.get(name, 0), f"exact-epilogue path: {name} launches {n}")
    return counts


GEMMA_SEQ = 2048


def dh256_phase(torch):
    """Head dim 256 at gemma3-1b's attention shape (H = 4, Hkv = 1, bf16):
    the flash forward and backward at B = 1, S = T = 2048, causal, once
    with its 512-token window and once without, against their plain
    versions (integer-grid inputs: the kernel's row max must equal the plain
    chain's bitwise; forward 1e-2, dq, dk, dv 1e-2 of each max), and at
    S = T = 700 in bf16 and f32 (1e-5, 1e-4); random normal bf16 inputs
    with and without the window, where every live row's raw tie count must
    be at least 1; the split-KV decode at dh 256 (bf16 1e-2, f32 1e-5);
    slice 15: the flash forward and backward at gemma3-1b's 1 x 4096
    training shape with the window.  Timed in bf16 against
    ``scaled_dot_product_attention`` over the K/V repeated to the 4 query
    heads (the repeat not timed)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.fused import fused_flash_attention, paged_flash_decode
    from repro_torch.kernels.fused import attention as A
    from repro_torch.kernels.fused.decoding import paged_flash_decode_plain

    dev = torch.device("cuda")
    table, plan, tables = _exp_table(torch)
    gen = torch.Generator(device=dev).manual_seed(19)
    H, hkv, dh = GEMMA_H, GEMMA_HKV, GEMMA_DH
    rows = {}
    cases = [(f"S=T={GEMMA_SEQ} causal", GEMMA_SEQ, torch.bfloat16, None, True),
             (f"S=T={GEMMA_SEQ} causal window {GEMMA_WINDOW}", GEMMA_SEQ, torch.bfloat16,
              GEMMA_WINDOW, True),
             ("S=T=700 causal", 700, torch.bfloat16, None, False),
             ("S=T=700 causal", 700, torch.float32, None, False),
             ("S=T=700 causal window 128", 700, torch.float32, 128, False),
             (GEMMA_TRAIN_FLASH, GEMMA_TRAIN_SEQ, torch.bfloat16, GEMMA_WINDOW, True)]
    for name, S, dtype, window, timed in cases:
        q = _igrid(torch, gen, (1, S, H, dh), dtype)
        k = _igrid(torch, gen, (1, S, hkv, dh), dtype)
        v = _igrid(torch, gen, (1, S, hkv, dh), dtype)
        dout = _igrid(torch, gen, (1, S, H, dh), dtype)
        kw = dict(causal=True, window=window, q_offset=0, kv_valid_len=None)
        what = f"dh 256 flash {name} {dtype}"
        n0 = fused_flash_attention.launches
        got = fused_flash_attention(q, k, v, table=table, causal=True, window=window)
        check(fused_flash_attention.launches == n0 + 1, f"{what}: not launched")
        out_m, m = A._launch(q, k, v, plan, tables, True, window, 0, None, True)
        want, m_plain = A.fused_flash_attention_plain(q, k, v, plan, tables, **kw)
        b0 = fused_flash_attention.bwd_launches
        grads = A.fused_flash_attention_bwd(q, k, v, dout, m, plan, tables, **kw)
        check(fused_flash_attention.bwd_launches == b0 + 1, f"{what}: backward not launched")
        wgrads = A.fused_flash_attention_bwd_plain(q, k, v, dout, m, plan, tables, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, out_m), f"{what}: the output changes with m written")
        check(torch.equal(m, m_plain), f"{what}: the kernel's row max is not the plain one's")
        tol, gtol = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
        err = _compare(torch, got, want, tol, what)
        errs = [_compare_scaled(torch, a, b, gtol, f"{what} d{n}")
                for n, a, b in zip("qkv", grads, wgrads)]
        line = (f"[smoke] fused_flash_attention dh=256 H={H} Hkv={hkv} {name} {dtype}: "
                f"max_abs_err {err:.3g} (tol {tol}), backward dq {errs[0]:.3g} dk {errs[1]:.3g} "
                f"dv {errs[2]:.3g} (tol {gtol} of each max)")
        if timed:
            qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
            kh, vh = (t.repeat_interleave(H // hkv, dim=1) for t in (kh, vh))
            pos = torch.arange(S, device=dev)
            keep = pos[None, :] <= pos[:, None]
            if window is not None:
                keep &= (pos[:, None] - pos[None, :]) < window
            sdpa = dict(is_causal=True) if window is None else dict(attn_mask=keep)
            k_ms = time_ms(torch, lambda i: fused_flash_attention(
                q, k, v, table=table, causal=True, window=window), reps=5, iters=4)
            p_ms = time_ms(torch, lambda i: A.fused_flash_attention_plain(
                q, k, v, plan, tables, **kw), reps=2, iters=2)
            l_ms = time_ms(torch, lambda i: Fn.scaled_dot_product_attention(qh, kh, vh, **sdpa))
            pairs = H * int(keep.sum())
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "max_abs_err": err,
                          **_bound((2 * q.numel() + 2 * k.numel()) * 2, 4.0 * pairs * dh)}
            kb_ms = time_ms(torch, lambda i: A.fused_flash_attention_bwd(
                q, k, v, dout, m, plan, tables, **kw), reps=3, iters=3)
            pb_ms = time_ms(torch, lambda i: A.fused_flash_attention_bwd_plain(
                q, k, v, dout, m, plan, tables, **kw), reps=1, iters=2)
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (qh, kh, vh))
            doh = dout.permute(0, 2, 1, 3).contiguous()
            lb_ms = time_ms(torch, lambda i: torch.autograd.grad(
                Fn.scaled_dot_product_attention(qg, kg, vg, **sdpa), (qg, kg, vg), doh),
                reps=5, iters=4)
            rows[name + " bwd"] = {
                "ms": kb_ms, "plain_ms": pb_ms, "library_ms": lb_ms, "max_abs_err": max(errs),
                **_bound((4 * q.numel() + 3 * k.numel()) * 2 + m.numel() * 4,
                         10.0 * pairs * dh)}
            line += (f"; forward kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, SDPA "
                     f"{l_ms * 1e3:.1f} us, bound {rows[name]['bound_ms'] * 1e3:.1f} us; backward "
                     f"kernels {kb_ms * 1e3:.1f} us, plain {pb_ms * 1e3:.1f} us, autograd of SDPA "
                     f"{lb_ms * 1e3:.1f} us, bound {rows[name + ' bwd']['bound_ms'] * 1e3:.1f} us")
        print(line)

    # random normal bf16 at the same shape
    for window in (None, GEMMA_WINDOW):
        q, dout = (torch.randn(1, GEMMA_SEQ, H, dh, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(1, GEMMA_SEQ, hkv, dh, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        _check_raw_ties(torch, q, k, v, dout, True, window,
                        f"dh 256 flash bwd S=T={GEMMA_SEQ} causal window {window} random bf16")

    # the split-KV decode at dh 256: 4 slots over the one KV head, G = 4
    kv_len, n_cols = [19, 32, 15, 2100], 132
    P = 4 * n_cols + 1
    tab = torch.zeros((4, n_cols), dtype=torch.int32)
    for bi, r in enumerate(_fragmented_table(4, n_cols, P)):
        tab[bi, :len(r)] = torch.tensor(r)
    tab, lens = tab.to(dev), torch.tensor(kv_len, dtype=torch.int32, device=dev)
    pps = 2048 // PS
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        q = torch.randn(4, 1, H, dh, generator=gen, device=dev).to(dtype)
        kp = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(dtype)
        vp = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(dtype)
        n0 = paged_flash_decode.launches
        got = paged_flash_decode(q, kp, vp, tab, lens, table=table)
        check(paged_flash_decode.launches == n0 + 1, "dh 256 decode: not launched")
        want = paged_flash_decode_plain(q, kp, vp, tab, lens, plan, tables, min(pps, n_cols))
        torch.cuda.synchronize()
        err = _compare(torch, got, want, tol, f"dh 256 decode {dtype}")
        print(f"[smoke] paged_flash_decode dh=256 H={H} Hkv={hkv} kv_len {kv_len} {dtype}: "
              f"max_abs_err {err:.3g} (tol {tol})")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kp, vp))
    k_ms = time_ms(torch, lambda i: paged_flash_decode(qb, kb, vb, tab, lens, table=table))
    p_ms = time_ms(torch, lambda i: paged_flash_decode_plain(qb, kb, vb, tab, lens, plan, tables,
                                                             min(pps, n_cols)), reps=3, iters=3)
    live_pages = sum(-(-n // PS) for n in kv_len)
    nbytes = 2 * live_pages * PS * dh * hkv * 2 + 2 * qb.numel() * 2 + tab.numel() * 4 + 16
    rows["decode"] = {"ms": k_ms, "plain_ms": p_ms,
                      "library_ms": _decode_sdpa_ms(torch, qb, kb, vb, tab, lens),
                      "max_abs_err": err, **_bound(nbytes, 4.0 * sum(kv_len) * H * dh)}
    print(f"[smoke] paged_flash_decode dh=256: kernel {k_ms * 1e3:.2f} us, plain "
          f"{p_ms * 1e3:.2f} us, SDPA {rows['decode']['library_ms'] * 1e3:.2f} us, bound "
          f"{rows['decode']['bound_ms'] * 1e3:.3f} us")
    return rows


def dh256_path(torch) -> dict:
    """gemma3-1b's attention at dh 256 through the ops' public entry points:
    counters reset, one flash forward and backward under autograd (B = 1,
    S = T = 2048, causal, the 512 window, bf16) and one paged decode step,
    counters read."""
    from repro_torch.kernels import fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    table = _exp_table(torch)[0]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q = rnd(1, GEMMA_SEQ, GEMMA_H, GEMMA_DH).requires_grad_(True)
    k = rnd(1, GEMMA_SEQ, GEMMA_HKV, GEMMA_DH).requires_grad_(True)
    v = rnd(1, GEMMA_SEQ, GEMMA_HKV, GEMMA_DH).requires_grad_(True)
    reset_counters()
    out = fused.fused_flash_attention(q, k, v, table=table, causal=True, window=GEMMA_WINDOW)
    torch.cos(out.float()).sum().backward()
    pt = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4) + 1
    fused.paged_flash_decode(rnd(2, 1, GEMMA_H, GEMMA_DH), rnd(GEMMA_HKV, 9, PS, GEMMA_DH),
                             rnd(GEMMA_HKV, 9, PS, GEMMA_DH), pt,
                             torch.tensor([40, 64], dtype=torch.int32, device=dev), table=table)
    torch.cuda.synchronize()
    counts = read_counters()
    check(all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v)),
          "dh 256 path: non-finite gradients")
    check(counts["fused_flash_attention"] == 1 and counts["fused_flash_attention_bwd"] == 1
          and counts["paged_flash_decode"] == 1, f"dh 256 path: launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# slice 15: the dense architectures

NEW_ARCHS = ("olmo-1b", "stablelm-1.6b", "qwen2.5-32b", "gemma3-1b", "internvl2-1b")
GLU_TIMED_4096 = ("olmo-1b", "gemma3-1b")  # the two that train here: 8 x 512, 1 x 4096


def arch_glu_phase(torch) -> dict:
    """The GLU and its backward at each new architecture's K x N (its
    d_model x d_ff and activation), bf16, M = 4 (a decode step of four
    slots), 32 (a 32-token prefill) and 4096 (a training batch), against
    the plain versions: the forward at 1e-2, dzg and dzu at 1e-2 of each
    one's max except the slopes that ``_order_band`` finds a neighbouring
    segment's at a breakpoint.  Past K = 2048 the order band holds more
    than ``MAX_BAND_SHARE`` of the elements (at qwen2.5-32b's K = 5120 the
    f32 accumulators' rounding bound grows with K), so here only those
    mismatched elements leave the tolerance check, and every other element,
    in the band or not, stays in it.  Timed: the forward at M = 4 for each
    (the weights rotated past the 50 MB L2), forward and backward at
    M = 4096 for olmo-1b and gemma3-1b, beside ``torch.matmul(x, [Wg|Wu])``.
    Returns the rows by (arch, M, "fwd" | "bwd")."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.kernels.fused.glu import fused_glu_bwd, fused_glu_bwd_plain, fused_glu_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    rows = {}
    for arch in NEW_ARCHS:
        cfg = get_config(arch)
        K, N = cfg.d_model, cfg.d_ff
        table, plan, tables = _table(torch, cfg.activation)
        copies = max(1, min(8, math.ceil(100e6 / (2 * K * N * 2))))
        wgs = [(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
               for _ in range(copies)]
        wus = [(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
               for _ in range(copies)]
        wg, wu = wgs[0], wus[0]
        for M in (4, 32, 4096):
            what = f"{arch} GLU M={M} K={K} N={N} {cfg.activation} bf16"
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            g = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
            n0, b0 = fused_glu.launches, fused_glu.bwd_launches
            got = fused_glu(x, wg, wu, table=table)
            dzg, dzu = fused_glu_bwd(x, wg, wu, g, plan, tables)
            check(fused_glu.launches == n0 + 1 and fused_glu.bwd_launches == b0 + 1,
                  f"{what}: kernels not launched")
            want = fused_glu_plain(x, wg, wu, plan, tables)
            wdzg, wdzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
            torch.cuda.synchronize()
            err = _compare(torch, got, want, 1e-2, what)
            marked, band = _order_band(torch, x, (wg, wu), None, g, dzg, plan, tables,
                                       f"{what} backward", max_band=None)
            berr = max(_compare_outside(torch, dzg, wdzg, marked, 1e-2, f"{what} dzg"),
                       _compare_outside(torch, dzu, wdzu, marked, 1e-2, f"{what} dzu"))
            del want, wdzg, wdzu, marked
            line = (f"[smoke] {what}: max_abs_err {err:.3g}; backward {berr:.3g} of each max "
                    f"outside the mismatches ({band})")
            if M == 4 or (M == 4096 and arch in GLU_TIMED_4096):
                wcat = [torch.cat([a, b], dim=1) for a, b in zip(wgs, wus)]
                reps = dict(reps=5, iters=4) if M == 4096 else {}
                k_ms = time_ms(torch, lambda i: fused_glu(x, wgs[i % copies], wus[i % copies],
                                                          table=table), **reps)
                p_ms = time_ms(torch, lambda i: fused_glu_plain(
                    x, wgs[i % copies], wus[i % copies], plan, tables), reps=3, iters=3)
                l_ms = time_ms(torch, lambda i: torch.matmul(x, wcat[i % copies]), **reps)
                nbytes = (M * K + 2 * K * N + M * N) * 2
                rows[(arch, M, "fwd")] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                          "max_abs_err": err, **_bound(nbytes, 4.0 * M * K * N)}
                line += (f"; forward kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
                         f"torch.matmul {l_ms * 1e3:.2f} us, bound "
                         f"{rows[(arch, M, 'fwd')]['bound_ms'] * 1e3:.2f} us "
                         f"({rows[(arch, M, 'fwd')]['bound_by']})")
                if M == 4096:
                    kb_ms = time_ms(torch, lambda i: fused_glu_bwd(x, wg, wu, g, plan, tables),
                                    reps=5, iters=4)
                    pb_ms = time_ms(torch, lambda i: fused_glu_bwd_plain(x, wg, wu, g, plan,
                                                                         tables),
                                    reps=2, iters=2)
                    nbytes_b = nbytes + 2 * M * N * 4
                    rows[(arch, M, "bwd")] = {"ms": kb_ms, "plain_ms": pb_ms, "library_ms": l_ms,
                                              "max_abs_err": berr,
                                              **_bound(nbytes_b, 4.0 * M * K * N)}
                    line += (f"; backward kernel {kb_ms * 1e3:.1f} us, plain "
                             f"{pb_ms * 1e3:.1f} us, bound "
                             f"{rows[(arch, M, 'bwd')]['bound_ms'] * 1e3:.1f} us")
                del wcat
            print(line)
        del wgs, wus, wg, wu
    torch.cuda.empty_cache()
    return rows


def arch_kv_phase(torch) -> dict:
    """The rotating page writes at qwen2.5-32b's grouping (40 query heads
    on 8 KV heads of dim 128, G = 5) and internvl2-1b's (14 on 2 of dim
    64, G = 7), decode B = 4 and prefill 1 x 32, bitwise against their plain
    versions and the chain they replaced (``_rope_case``), timed."""
    out = {}
    for arch in ("qwen2.5-32b", "internvl2-1b"):
        out[f"rope_append_kv_[{arch}]"] = _rope_case(torch, arch, B=4, S=1)
        out[f"rope_write_prompt_pages_[{arch}]"] = _rope_case(torch, arch, B=1, S=32)
    return out


def _gemma_layers():
    from repro_torch.configs import get_config

    kinds = [m for m, _ in get_config("gemma3-1b").layer_kinds]
    return kinds.count("attn_local"), kinds.count("attn_global")


def gemma_dense_attention(steps) -> dict:
    """gemma3-1b's dense loop under the fused-softmax plan, 4 x 2048 prompts:
    the prefill's global layers on the row softmax (4 x 4 x 2048^2 scores
    fit the cap), its local layers on the flash kernel with the window (2048
    keys > twice the window); every decode step's layers on the row softmax
    with a mask (the local layers over their 512-slot rings)."""
    n_local, n_global = _gemma_layers()
    pf, ds, L = steps["prefills"], steps["decode_steps"], steps["layers"]
    return {"fused_pwl_softmax": n_global * pf + L * ds, "paged_flash_decode": 0,
            "fused_flash_attention": n_local * pf}


def _release(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def qwen_init_phase(torch) -> dict:
    """qwen2.5-32b's seed-0 init on the card (the serving tree, 32.76 B
    parameters in bf16), its time and its peak of allocated memory, which
    must stay under the card's."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch import tree

    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = Model(get_config("qwen2.5-32b"), device="cuda").init(seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = sum(t.numel() for t in tree.leaves(params))
    held = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    peak = torch.cuda.max_memory_allocated() - base
    total = torch.cuda.get_device_properties(0).total_memory
    check(abs(n - 32.76e9) < 0.01e9, f"qwen2.5-32b has {n} parameters")
    check(peak < total, f"qwen2.5-32b init peak {peak} past the card's {total}")
    check(all(bool(torch.isfinite(t[i]).all()) for t in tree.leaves(params)
              for i in range(t.shape[0])), "qwen2.5-32b init: non-finite weights")
    print(f"[smoke] qwen2.5-32b init on the card: {n / 1e9:.2f} B parameters, "
          f"{held / 1e9:.2f} GB held, {secs:.1f} s, peak allocated {peak / 1e9:.2f} GB of "
          f"{total / 1e9:.2f} GB")
    del params
    _release(torch)
    return {"seconds": secs, "peak_bytes": peak, "held_bytes": held}


def arch_serve_phases(torch, tmp: pathlib.Path, gemma_plan: str) -> dict:
    """Full-width sessions of the new architectures through the serve entry
    point (``serve_phase``: each layer of each model call through the GLU
    kernel, the paged ones through the rotating page writes): olmo-1b,
    stablelm-1.6b and internvl2-1b at the defaults; qwen2.5-32b and
    internvl2-1b at the defaults and under their fused-softmax plans (the
    row softmax, and the split-KV decode at G = 5 and 7); gemma3-1b at the
    defaults (paged asked for: serve falls back to its dense loop), and
    under ``gemma_plan`` (its fused-softmax plan) in the dense loop at 4 x
    2048 + 16 (``gemma_dense_attention``).  Returns each session's counts
    by name."""
    out = {}
    for arch in ("olmo-1b", "stablelm-1.6b", "internvl2-1b", "qwen2.5-32b"):
        out[arch] = serve_phase(torch, ["--arch", arch], no_attention_kernels)
        _release(torch)
    for arch in ("internvl2-1b", "qwen2.5-32b"):
        plan = dump_plan(tmp / f"{arch}_fused_softmax_plan.json", arch)
        out[f"{arch} softmax"] = serve_phase(torch, ["--arch", arch, "--plan", plan],
                                             short_prompt_attention)
        _release(torch)
    out["gemma3-1b"] = serve_phase(torch, ["--arch", "gemma3-1b"], no_attention_kernels,
                                   fallback=True)
    out["gemma3-1b dense 2048"] = serve_phase(
        torch, ["--arch", "gemma3-1b", "--plan", gemma_plan, "--mode", "dense",
                "--prompt-len", "2048", "--max-new", "16"], gemma_dense_attention)
    _release(torch)
    return out


def internvl_vision_phase(torch) -> dict:
    """Full-width internvl2-1b with its vision prefix through ``Model``:
    ``prefill(vision_embeds=)`` of 4 requests x (256 stub patch embeddings
    + 32 tokens) into a dense cache, 16 greedy ``decode_step``s, and
    ``Model.loss`` on the same batch with the prefix (the loss over the 32
    token positions only), each layer of each call through the GLU kernel.
    The logits are finite, the prefix changes them, and the loss equals the
    cross entropy of ``forward``'s logits past the prefix."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.transformer import sharded_cross_entropy

    cfg = get_config("internvl2-1b", act_impl="fused")
    check(cfg.n_vision_tokens == 256 and FULL_WIDTH["internvl2-1b"][0] == cfg.d_model,
          "not full-width internvl2-1b")
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    B, S, n_new, nv = 4, 32, 16, cfg.n_vision_tokens
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev)
    vision = (torch.randn(B, nv, cfg.d_model, generator=gen, device=dev) * 0.02).to(cfg.dtype)
    L = cfg.n_layers
    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = model.make_cache(B, nv + S + n_new)
    logits = model.prefill(params, toks[:, :S], cache, vision_embeds=vision)
    first = logits
    out = []
    for i in range(n_new):
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        out.append(tok)
        logits = model.decode_step(params, tok, cache, nv + S + i)
        check(bool(torch.isfinite(logits).all()), f"internvl decode step {i}: non-finite")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counters()
    check(counts["fused_glu"] == L * (1 + n_new),
          f"internvl vision session: fused_glu launches {counts['fused_glu']} != {L} x 17")
    check(all(n == 0 for k, n in counts.items() if k != "fused_glu"),
          f"internvl vision session launched {counts}")
    plain = model.prefill(params, toks[:, :S], model.make_cache(B, S))
    check(not torch.equal(plain, first), "the vision prefix did not change the logits")
    batch = {"tokens": toks[:, :S], "targets": toks[:, 1:], "vision_embeds": vision}
    reset_counters()
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
        full = model.forward(params, toks[:, :S], vision_embeds=vision)
    check(read_counters()["fused_glu"] == 2 * L, "internvl loss and forward: GLU launches")
    check(full.shape == (B, nv + S, cfg.padded_vocab), f"internvl forward shape {full.shape}")
    want = sharded_cross_entropy(full[:, nv:], batch["targets"].long())
    check(math.isfinite(float(loss)) and abs(float(loss) - float(want)) <= 1e-5 * float(want),
          f"internvl loss {float(loss)} != {float(want)}")
    tok_s = B * n_new / secs
    print(f"[smoke] internvl2-1b prefill(vision_embeds=) 4 x ({nv} + {S}) then {n_new} decode "
          f"steps: {tok_s:.1f} tok/s ({secs * 1e3:.1f} ms), peak allocated {peak / 1e9:.2f} GB, "
          f"tokens {torch.cat(out, 1)[0].tolist()}"
          f"; loss with the prefix {float(loss):.4f} (ln V = {math.log(cfg.vocab_size):.4f}), "
          f"launches {counts}")
    del params, cache
    _release(torch)
    return counts


def _train_args(arch: str, plan: str, batch: int, seq: int, steps: int, ckpt_dir=None):
    from repro_torch.launch import train

    argv = ["--arch", arch, "--plan", plan, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--log-every", "5", "--ckpt-every", "1000"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", ckpt_dir]
    args = train.build_parser().parse_args(argv)
    check(args.device == "cuda", "train must default to cuda")
    return args


def _arch_train_counts(arch: str, steps: int) -> dict:
    """Per step under remat: each layer's forward twice, its backward once;
    the GLU in every layer, the flash kernels in gemma3's local layers and
    the row softmax in its global layers (in every layer for a model whose
    8 x 512 scores fit the dense cap); no kernel for mamba2."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    L = cfg.n_layers
    if cfg.d_ff == 0:  # mamba2: the empty FFN's GLU and the SSM layers launch nothing
        return {}
    if arch == "gemma3-1b":
        n_local, n_global = _gemma_layers()
    else:
        n_local, n_global = 0, L
    want = {"fused_glu": 2 * L, "fused_glu_bwd": L, "fused_flash_attention": 2 * n_local,
            "fused_flash_attention_bwd": n_local, "fused_pwl_softmax": 2 * n_global,
            "fused_pwl_softmax_bwd": n_global}
    return {k: v * steps for k, v in want.items() if v}


def _run_train(torch, args, what: str) -> dict:
    import statistics

    from repro_torch.launch import train

    reset_counters()
    out = train.run(args)
    torch.cuda.synchronize()
    counts = read_counters()
    steps = len(out["losses"])
    check(all(math.isfinite(x) for x in out["losses"]), f"{what}: losses {out['losses']}")
    want = _arch_train_counts(args.arch, steps)
    for name, n in counts.items():
        check(n == want.get(name, 0), f"{what}: {name} launches {n} != {want.get(name, 0)}")
    med = statistics.median(out["step_seconds"])
    peak = torch.cuda.max_memory_allocated()
    print(f"[smoke] {what}: {steps} steps, loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, median step {med * 1e3:.1f} ms "
          f"({out['tokens_per_step'] / med:.0f} tokens/s), peak allocated {peak / 1e9:.2f} GB, "
          f"launches {counts}")
    return {**out, "counts": counts, "step_ms": med * 1e3,
            "tokens_per_s": out["tokens_per_step"] / med}


OLMO_STEPS = 4


def olmo_train_phase(torch, tmp: pathlib.Path) -> dict:
    """Full-width olmo-1b (non-parametric LayerNorm: no norm parameters,
    empty subtrees in every tree) through the train entry point under its
    fused-softmax plan at the launcher's 8 x 512, remat on: ``OLMO_STEPS``
    steps straight, then the same steps as half, a checkpoint and a resume
    from it; the resumed run's losses must equal the straight run's bit for
    bit, and the launch counts hold every GLU and row softmax, forward and
    backward, on its kernel."""
    from repro_torch.checkpoint.manager import CheckpointManager

    plan = dump_plan(tmp / "olmo_fused_softmax_plan.json", "olmo-1b")
    torch.cuda.reset_peak_memory_stats()
    straight = _run_train(torch, _train_args("olmo-1b", plan, 8, 512, OLMO_STEPS),
                          f"olmo-1b train 8 x 512, {OLMO_STEPS} steps")
    check(straight["state"]["params"]["final_norm"] == {}, "olmo-1b: a norm has parameters")
    del straight["state"]
    _release(torch)
    ckpt = str(tmp / "olmo_ckpt")
    first = _run_train(torch, _train_args("olmo-1b", plan, 8, 512, OLMO_STEPS // 2, ckpt),
                       f"olmo-1b train, first {OLMO_STEPS // 2} steps")
    del first["state"]
    _release(torch)
    manifest = json.loads((pathlib.Path(ckpt) / f"step_{OLMO_STEPS // 2:08d}" /
                           "manifest.json").read_text())
    check(["params", "final_norm"] in manifest["empty"], "olmo checkpoint: no empty norm paths")
    second = _run_train(torch, _train_args("olmo-1b", plan, 8, 512, OLMO_STEPS, ckpt),
                        f"olmo-1b train resumed at step {OLMO_STEPS // 2}")
    check(second["state"]["mu"]["layers"][0]["ln1"] == {}, "olmo resume lost an empty norm")
    del second["state"]
    check(CheckpointManager(ckpt).latest_step() == OLMO_STEPS, "olmo: no final checkpoint")
    import shutil

    shutil.rmtree(ckpt)
    resumed = first["losses"] + second["losses"]
    check(resumed == straight["losses"],
          f"olmo-1b resumed losses {resumed} != straight {straight['losses']}")
    print(f"[smoke] olmo-1b resume: losses {resumed} equal the straight run's bit for bit")
    _release(torch)
    return straight


GEMMA_STEPS = 60


def gemma_train_phase(torch, plan: str) -> dict:
    """Full-width gemma3-1b through the train entry point under its
    fused-softmax plan at batch 1 x 4096, remat on, ``GEMMA_STEPS`` steps:
    the 22 local layers on the flash kernels with the 512 window (forward
    and backward), the 4 global layers on the row softmax at width 4096
    (4 x 4096^2 scores fit the dense cap), the GLU at M = 4096, the tied
    262,144-row embedding.  Held by ``_held_out_gate`` on 1 x 4096 batches,
    on average over this run and the same run with the plain GLU, as the
    repro-100m long-context run is."""
    from repro_torch.launch import train
    from repro_torch.models import Model

    args = _train_args("gemma3-1b", plan, 1, GEMMA_TRAIN_SEQ, GEMMA_STEPS)
    torch.cuda.reset_peak_memory_stats()
    out = _run_train(torch, args, f"gemma3-1b train 1 x {GEMMA_TRAIN_SEQ}")
    check(out["rc"] == 0, f"gemma3-1b train rc {out['rc']}: losses {out['losses']}")
    after = out.pop("state")["params"]
    _release(torch)
    init = Model(train.resolve_config(args), device="cuda").init(seed=0, master=True)
    line = _held_out_gate(torch, args, init, [after, _train_plain(torch, args)],
                          "gemma3-1b train")
    print(f"[smoke] gemma3-1b train (1 x {GEMMA_TRAIN_SEQ}) after {GEMMA_STEPS} steps, this "
          f"run and the plain GLU's: {line}")
    del init, after
    _release(torch)
    return out


def _nudge_tol(torch, params, run) -> float:
    """1e-4, or 4 times the change of ``run(params)`` when every weight is
    scaled by ``1 + 1e-7·N(0, 1)`` (f32 rounding) on the CPU: the
    tolerance of a model whose init amplifies rounding past 1e-4 (reduced
    gemma3-1b, ``tests/test_torch_gemma3.py``)."""
    from repro_torch import tree

    gen = torch.Generator().manual_seed(1)
    leaves = tree.leaves(params)
    nudged = tree.unflatten(params, [t * (1 + 1e-7 * torch.randn(t.shape, generator=gen))
                                     for t in leaves])
    return max(1e-4, 4 * float((run(nudged) - run(params)).abs().max()))


def arch_reference_phase(torch):
    """The new architectures, reduced, in f32 on the card against the port's
    plain path on the CPU under the fused-softmax plan (TF32 off): logits of
    2 x 40 tokens (internvl2-1b behind its 8-token vision prefix; gemma3-1b
    past twice its 16-token window, so its local layers take the flash
    kernel) at ``_nudge_tol``: 1e-4, or 4 times the CPU logits' own change
    under a 1e-7 nudge of the weights where that is larger (the PWL exp's
    slope jumps amplify f32 rounding: reduced qwen2.5-32b and gemma3-1b
    move by up to ~5e-4 and ~1e-3); gemma3-1b's dense prefill and decode
    past its rings' wrap; and for the paged archs a paged engine session's
    greedy tokens equal to the dense loop's on the card."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.serving import GenRequest, PagedServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in NEW_ARCHS:
        cfg = get_reduced_config(arch, act_impl="fused", pwl_softmax=True, dtype=torch.float32)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        params = cpu.init(seed=0)
        gparams = _to_cuda(torch, params)
        toks = torch.randint(0, cfg.vocab_size, (2, 40),
                             generator=torch.Generator().manual_seed(2))
        vision = None
        if cfg.n_vision_tokens:
            vision = torch.randn(2, cfg.n_vision_tokens, cfg.d_model,
                                 generator=torch.Generator().manual_seed(3)) * 0.02

        def on(dev, p, vision=vision):
            model = cpu if dev == "cpu" else gpu
            v = None if vision is None else vision.to(dev)
            return model.forward(p, toks.to(dev), vision_embeds=v).cpu()

        want = on("cpu", params)
        got = on("cuda", gparams)
        tol = _nudge_tol(torch, params, lambda p: on("cpu", p))
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=tol, rtol=1e-4),
              f"reduced {arch} logits err {err} > {tol}")
        line = f"[smoke] reduced {arch} f32 fused-softmax plan: cuda vs cpu logits {err:.3g} " \
               f"(tol {tol:.3g})"
        if arch == "gemma3-1b":
            caches = [m.make_cache(2, 30) for m in (cpu, gpu)]
            logits = [m.prefill(p, toks[:, :20].to(m.device), c)
                      for m, p, c in zip((cpu, gpu), (params, gparams), caches)]
            worst = (logits[1].cpu() - logits[0]).abs().max().item()
            for i in range(10):
                tok = logits[0][:, -1].argmax(-1)[:, None]
                logits = [m.decode_step(p, tok.to(m.device), c, 20 + i)
                          for m, p, c in zip((cpu, gpu), (params, gparams), caches)]
                worst = max(worst, (logits[1].cpu() - logits[0]).abs().max().item())
            check(worst <= tol, f"reduced gemma3-1b prefill 20 + 10 decode steps: err {worst}")
            line += f"; prefill of 20 then 10 decode steps past the 16-slot rings {worst:.3g}"
        else:
            reqs = [GenRequest(f"r{i}", toks[i, : 9 + 13 * i].tolist(), 6) for i in range(2)]
            eng = PagedServingEngine(gpu, gparams, max_slots=2, page_size=16, max_context=64)
            paged = {r.request_id: r.tokens for r in eng.run(reqs)}
            dense = {r.request_id: generate(gpu, gparams,
                                            torch.tensor([r.prompt], device="cuda"),
                                            r.max_new_tokens)[0].tolist() for r in reqs}
            check(paged == dense, f"reduced {arch}: paged {paged} != dense {dense}")
            line += "; paged == dense greedy tokens on cuda"
        print(line)


# ---------------------------------------------------------------------------
# slice 16: the Mamba2 SSM layer (mamba2-2.7b at full width, reduced jamba)

MAMBA = "mamba2-2.7b"
MAMBA_STEPS = 4
MAMBA_RESUME_LAYERS = 2  # the resume's depth: its two saves write 2 x 2.5 GB


def mamba2_plan(path: pathlib.Path, softplus_kernel: bool = False) -> str:
    """mamba2-2.7b's fused plan (``mlp:silu`` fused, ``ssm:silu`` pinned
    exact, ``ssm:softplus`` the plain PWL evaluation), or with
    ``ssm:softplus`` on the standalone PWL kernel (``impl="kernel"``)."""
    import dataclasses

    from repro_torch import sfu
    from repro_torch.configs import get_config

    plan = sfu.compile_plan(get_config(MAMBA, act_impl="fused"))
    if softplus_kernel:
        plan = sfu.ActivationPlan(sites=tuple(
            (k, dataclasses.replace(s, impl="kernel") if k == "ssm:softplus" else s)
            for k, s in plan.items()))
    impls = {k: s.impl for k, s in plan.items()}
    check(impls == {"mlp:silu": "fused", "ssm:silu": "exact",
                    "ssm:softplus": "kernel" if softplus_kernel else "jnp"},
          f"{MAMBA} plan {impls}")
    return str(sfu.dump_plan(plan, path))


def mamba2_serve_phases(torch, tmp: pathlib.Path) -> dict:
    """Full-width mamba2-2.7b (64 SSM layers, d_model 2560, 80 heads of 64,
    state 128, the empty FFN) through the serve entry point, paged asked
    for each time, so serve says on stderr that SSM states have no paged
    layout and runs its dense loop: the defaults (no kernel: the empty FFN's
    GLU launches nothing), ``--prompt-len 300 --max-new 16`` (chunk 128 pads
    300 to 384: two chunk boundaries and a padded last chunk), and the
    defaults under a plan with ``ssm:softplus`` on the standalone PWL kernel
    (64 launches a model call, no other FFN kernel)."""
    out = {}
    out["defaults"] = serve_phase(torch, ["--arch", MAMBA], no_attention_kernels,
                                  fallback=True, ffn_layers=0)
    _release(torch)
    out["300"] = serve_phase(torch, ["--arch", MAMBA, "--prompt-len", "300", "--max-new", "16"],
                             no_attention_kernels, fallback=True, ffn_layers=0)
    _release(torch)
    plan = mamba2_plan(tmp / "mamba2_softplus_kernel_plan.json", softplus_kernel=True)
    out["kernel"] = serve_phase(torch, ["--arch", MAMBA, "--plan", plan], no_attention_kernels,
                                ffn="pwl_activation", fallback=True)
    _release(torch)
    return out


@contextlib.contextmanager
def _train_depth(n_layers: int):
    """The train launcher's configs cut to ``n_layers`` layers (full width)."""
    import dataclasses

    from repro_torch.launch import train

    full = train.get_config
    train.get_config = lambda arch, **kw: dataclasses.replace(full(arch, **kw),
                                                              n_layers=n_layers)
    try:
        yield
    finally:
        train.get_config = full


def mamba2_train_phase(torch, tmp: pathlib.Path) -> dict:
    """Full-width mamba2-2.7b through the train entry point under its fused
    plan at the launcher's 8 x 512, remat on (the AdamW state of 2.70 B
    parameters, 43 GB, updated in place): ``MAMBA_STEPS`` steps, every loss
    and every step's gradient norm finite, no kernel launched (the plan's
    one fused site is the empty FFN).  Then, at full width cut to
    ``MAMBA_RESUME_LAYERS`` layers, the same steps straight and as half, a
    checkpoint and a resume from it, the resumed run's losses bit for bit
    the straight run's: a checkpoint of the 64-layer state is 32.4 GB, and
    the script keeps its disk writes, olmo-1b's two 14 GB checkpoints among
    them, under 45 GiB."""
    from repro_torch.checkpoint.manager import CheckpointManager

    plan = mamba2_plan(tmp / "mamba2_fused_plan.json")
    torch.cuda.reset_peak_memory_stats()
    what = f"{MAMBA} train 8 x 512, {MAMBA_STEPS} steps"
    full = _run_train(torch, _train_args(MAMBA, plan, 8, 512, MAMBA_STEPS), what)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(g) for g in full["grad_norms"]),
          f"{what}: gradient norms {full['grad_norms']}")
    print(f"[smoke] {what}: rc {full['rc']}, gradient norms {full['grad_norms']}")
    del full["state"]
    _release(torch)
    L = MAMBA_RESUME_LAYERS
    ckpt = str(tmp / "mamba2_ckpt")
    half = MAMBA_STEPS // 2
    with _train_depth(L):
        straight = _run_train(torch, _train_args(MAMBA, plan, 8, 512, MAMBA_STEPS),
                              f"{MAMBA} ({L} layers) train, {MAMBA_STEPS} steps")
        del straight["state"]
        first = _run_train(torch, _train_args(MAMBA, plan, 8, 512, half, ckpt),
                           f"{MAMBA} ({L} layers) train, first {half} steps")
        del first["state"]
        second = _run_train(torch, _train_args(MAMBA, plan, 8, 512, MAMBA_STEPS, ckpt),
                            f"{MAMBA} ({L} layers) train resumed at step {half}")
        del second["state"]
    check(CheckpointManager(ckpt).latest_step() == MAMBA_STEPS, f"{MAMBA}: no final checkpoint")
    import shutil

    shutil.rmtree(ckpt)
    resumed = first["losses"] + second["losses"]
    check(resumed == straight["losses"],
          f"{MAMBA} resumed losses {resumed} != straight {straight['losses']}")
    check(all(math.isfinite(g) for g in straight["grad_norms"] + first["grad_norms"]
              + second["grad_norms"]), f"{MAMBA} ({L} layers): gradient norms")
    print(f"[smoke] {MAMBA} ({L} layers) resume: losses {resumed} equal the straight run's "
          "bit for bit")
    _release(torch)
    return {**full, "peak_bytes": peak}


def _redraw_ssm_vectors(torch, params) -> None:
    """The SSM layers' ``A_log``, ``dt_bias``, ``D``, ``conv_b`` and
    ``norm_scale`` drawn afresh in place from a seeded generator (the init
    makes them zeros and ones, which would hide a mix-up of heads)."""
    gen = torch.Generator().manual_seed(7)
    draws = {"A_log": (-0.25, 0.75), "dt_bias": (-1.0, 0.5), "D": (1.0, 0.3),
             "conv_b": (0.0, 0.1), "norm_scale": (0.0, 0.1)}
    for slot in params["layers"]:
        for name, (loc, scale) in draws.items():
            if name in slot["mixer"]:
                t = slot["mixer"][name]
                t.copy_(loc + scale * torch.randn(t.shape, generator=gen))


def ssm_reference_phase(torch) -> dict:
    """Reduced mamba2-2.7b and jamba-v0.1-52b in f32 on the card against the
    port's plain path on the CPU (TF32 off), their SSM vectors redrawn:
    logits of 2 x 40 tokens at ``_nudge_tol`` (mamba2 under its fused plan,
    jamba under the fused-softmax plan); mamba2 with ``ssm_chunk=16``, a
    prefill of 40 (three chunks, the last padded) then 10 decode steps; and
    jamba's dense loop (a prefill of 20, then 8 decode steps) step by step,
    its launches following its layer kinds: a model call runs 4 dense GLUs,
    4 MoE GLUs and one row softmax (its one attention layer).  Returns
    jamba's dense-loop launch counts."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    toks = torch.randint(0, 512, (2, 40), generator=torch.Generator().manual_seed(2))
    out = {}
    for arch, kw in ((MAMBA, dict(act_impl="fused", ssm_chunk=16)),
                     ("jamba-v0.1-52b", dict(act_impl="fused", pwl_softmax=True))):
        cfg = get_reduced_config(arch, dtype=torch.float32, **kw)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        params = cpu.init(seed=0)
        _redraw_ssm_vectors(torch, params)
        gparams = _to_cuda(torch, params)

        def fwd(dev, p):
            return (cpu if dev == "cpu" else gpu).forward(p, toks.to(dev)).cpu()

        want = fwd("cpu", params)
        got = fwd("cuda", gparams)
        tol = _nudge_tol(torch, params, lambda p: fwd("cpu", p))
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, atol=tol, rtol=1e-4),
              f"reduced {arch} logits err {err} > {tol}")
        n = 40 if arch == MAMBA else 20
        steps = 10 if arch == MAMBA else 8
        caches = [m.make_cache(2, n + steps) for m in (cpu, gpu)]
        reset_counters()
        logits = [m.prefill(p, toks[:, :n].to(m.device), c)
                  for m, p, c in zip((cpu, gpu), (params, gparams), caches)]
        worst = (logits[1].cpu() - logits[0]).abs().max().item()
        for i in range(steps):
            tok = logits[0][:, -1].argmax(-1)[:, None]
            logits = [m.decode_step(p, tok.to(m.device), c, n + i)
                      for m, p, c in zip((cpu, gpu), (params, gparams), caches)]
            worst = max(worst, (logits[1].cpu() - logits[0]).abs().max().item())
        torch.cuda.synchronize()
        counts = read_counters()
        check(worst <= tol, f"reduced {arch} prefill {n} + {steps} decode steps: err {worst}")
        calls = 1 + steps
        if arch == MAMBA:
            want_counts = {}  # the empty FFN and the SSM layers launch nothing
        else:
            kinds = cfg.layer_kinds
            want_counts = {"fused_glu": calls * sum(f == "dense" for _, f in kinds),
                           "fused_moe_glu": calls * sum(f == "moe" for _, f in kinds),
                           "fused_pwl_softmax": calls * sum(m == "attn" for m, _ in kinds)}
            check(want_counts == {"fused_glu": 4 * calls, "fused_moe_glu": 4 * calls,
                                  "fused_pwl_softmax": calls}, f"jamba kinds {kinds}")
        for name, k in counts.items():
            check(k == want_counts.get(name, 0),
                  f"reduced {arch} dense loop: {name} launches {k} != {want_counts.get(name, 0)}")
        out[arch] = counts
        print(f"[smoke] reduced {arch} f32 ({'fused-softmax' if cfg.pwl_softmax else 'fused'} "
              f"plan): cuda vs cpu logits {err:.3g} (tol {tol:.3g}); prefill of {n} then "
              f"{steps} decode steps {worst:.3g}; dense-loop launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    return out


# ---------------------------------------------------------------------------
# slice 17: the paper's SGD table fit on the card

FIT_FIG2 = ("gelu", 5, -2.0, 2.0)  # the paper's Fig. 2 fit
FIT_REFITS = (("gelu", 16), ("exp", 32), ("silu", 32), ("gelu_tanh", 8))  # gen_tables --fast
FIT_MISS_BP = 24  # gelu_tanh at 24 breakpoints: no shipped artifact
UNIFORM_FALLBACK = "uniform-breakpoint"  # the store's missing-artifact warning


@contextlib.contextmanager
def _counting_adam_steps():
    """Counts the Adam steps of the fits run inside (``fit._adam_chunk``
    wrapped)."""
    from repro_torch.core import fit as fitlib

    real, counted = fitlib._adam_chunk, {"steps": 0}

    def chunk(spec, steps, *args, **kwargs):
        counted["steps"] += steps
        return real(spec, steps, *args, **kwargs)

    fitlib._adam_chunk = chunk
    try:
        yield counted
    finally:
        fitlib._adam_chunk = real


def _timed(torch, run):
    """``run()``'s result, its wall seconds (the device synchronized) and
    the Adam steps it took."""
    with _counting_adam_steps() as counted:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, secs, counted["steps"]


def _fit_chunk_profile(torch) -> dict:
    """One 50-step Adam chunk of the Fig. 2 fit on the card: its kernels,
    memsets, copies on the device and copies to or from the host a step
    under ``torch.profiler`` (eager: a graph replays the same kernels; None
    where the profiler saw no device activity), and its wall time a step
    eager and as a CUDA graph replay (the median of 5 chunks each)."""
    from repro_torch.core import fit as fitlib
    from repro_torch.core import functions as F
    from repro_torch.core import pwl

    spec, n, lo, hi = F.get(FIT_FIG2[0]), *FIT_FIG2[1:]
    x = pwl.linspace_f32(lo, hi, 8192, device="cuda")
    fx, w = spec.fn(x), fitlib._trapezoid_weights(x)
    p = pwl.linspace_f32(lo, hi, n, device="cuda")
    v = spec.fn(p)
    m_l, m_r = pwl.boundary_slopes(spec, p)
    state = tuple(torch.zeros_like(p) for _ in range(4)) + (0,)
    lr = torch.tensor(0.1, device="cuda")
    graph = fitlib.ChunkGraph()

    def chunk(g=None):
        out = fitlib._adam_chunk(spec, 50, p, v, state, lr, x, fx, w, m_l, m_r, graph=g)
        return float(out[3])

    def per_step_ms(g=None) -> float:
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            chunk(g)
            walls.append((time.perf_counter() - t0) * 1e3 / 50)
        return sorted(walls)[2]

    check(chunk() == chunk(graph) == chunk(graph),
          "a graphed Adam chunk's loss differs from the eager chunk's")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    counts = {"kernels": 0, "memsets": 0, "device_copies": 0, "host_copies": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.lower()
            kind = ("memsets" if "memset" in name else
                    "device_copies" if "dtod" in name else
                    "host_copies" if "memcpy" in name else "kernels")
            counts[kind] += 1
    per = {k: (c / 50 if counts["kernels"] else None) for k, c in counts.items()}
    return {**per, "eager_ms": per_step_ms(), "graph_ms": per_step_ms(graph)}


def _edited_plan(tmp: pathlib.Path, name: str, **spec) -> str:
    """The default fused plan of repro-100m, dumped, with its
    ``mlp:gelu_tanh`` spec edited as a user would edit the JSON."""
    path = pathlib.Path(dump_plan(tmp / name, pwl_softmax=False))
    plan = json.loads(path.read_text())
    sites = dict((k, v) for k, v in plan["sites"])
    check(set(sites) == {"mlp:gelu_tanh"}, f"repro-100m's sites: {sorted(sites)}")
    sites["mlp:gelu_tanh"].update(spec)
    path.write_text(json.dumps(plan, indent=2))
    return str(path)


def fit_phase(torch, tmp: pathlib.Path, default_counts: dict) -> dict:
    """The paper's SGD fit (``core/fit.py``) on the card, then its tables
    through the model path.

    (a) the Fig. 2 fit (gelu, 5 breakpoints on [-2, 2], 1200 steps, 2
        rounds) twice on ``cuda``: the tables bitwise equal, the MSE within
        5% of the same call on the CPU and at least 7x below the uniform
        table's; one Adam chunk's kernels a step, and its time eager and
        as the CUDA graph the fit replays;
    (b) ``gen_tables --fast --device cuda --root DIR`` re-fits four shipped
        pairs, each to at most 1.1x the shipped artifact's MSE with its
        provenance whole (the shipped artifacts untouched);
    (c) a fit-on-miss store (gelu_tanh, 24 breakpoints, ``gen_tables``'
        fast config) fits on the card; its table through the fused GLU
        kernel at repro-100m's decode (M = 4) and training (M = 4096) rows
        against the plain version (bf16 1e-2, f32 1e-4), one launch each;
    (d) two full-width repro-100m serve sessions at the defaults: a dumped
        plan with ``"fit": "uniform"`` at ``mlp:gelu_tanh`` (no warning),
        and one at 25 segments, which has no artifact (exactly one uniform-
        fallback warning); both launch the GLU kernel as often as the
        default session does.
    """
    import hashlib
    import warnings

    import numpy as np

    from repro_torch import sfu
    from repro_torch.core import fit as fitlib
    from repro_torch.core import functions as F
    from repro_torch.core import gen_tables, pwl
    from repro_torch.kernels.fused import fused_glu
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.kernels.fused.glu import fused_glu_plain

    t_phase = time.perf_counter()
    card = card_line()
    out = {}

    def bits(t):
        return t.contiguous().view(torch.int32)

    # (a) the Fig. 2 fit, twice on the card, once on the CPU
    fn, n, lo, hi = FIT_FIG2
    cfg = fitlib.FitConfig(max_steps=1200, max_rounds=2)
    runs = [_timed(torch, lambda: fitlib.fit(fn, n, lo, hi, cfg, device="cuda"))
            for _ in range(2)]
    (r1, s1, steps1), (r2, s2, steps2) = runs
    for f in ("bp", "m", "q"):
        check(torch.equal(bits(getattr(r1.table, f)), bits(getattr(r2.table, f))),
              f"fig2 fit: two runs on the card differ in {f}")
    check(steps1 == steps2 and r1.history == r2.history, "fig2 fit: the runs' histories differ")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of small ops: threads only slow them
    try:
        t0 = time.perf_counter()
        rc = fitlib.fit(fn, n, lo, hi, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    uniform = pwl.mse(pwl.make_uniform_table(F.get(fn), n, lo, hi), F.get(fn), lo, hi)
    check(abs(r1.mse - rc.mse) <= 0.05 * rc.mse,
          f"fig2 fit: card MSE {r1.mse:.6g} vs CPU {rc.mse:.6g}")
    check(uniform / r1.mse >= 7.0, f"fig2 fit: only {uniform / r1.mse:.2f}x below uniform")
    check(bool(torch.all(r1.table.bp[1:] > r1.table.bp[:-1])), "fig2 fit: bp not increasing")
    prof = _fit_chunk_profile(torch)
    out["fig2"] = {"seconds": [s1, s2], "steps": steps1, "mse": r1.mse, "cpu_mse": rc.mse,
                   "cpu_seconds": cpu_s, "uniform_ratio": uniform / r1.mse, **prof}
    print(f"[smoke] fit fig2 (gelu 5 bp on [-2, 2], 1200 steps, 2 rounds) on {card}: "
          f"{s1:.2f} s and {s2:.2f} s, {steps1} Adam steps, "
          f"{s1 * 1e3 / steps1:.3f} / {s2 * 1e3 / steps2:.3f} ms a step; bitwise equal; "
          f"MSE {r1.mse:.6g} (CPU {rc.mse:.6g} in {cpu_s:.2f} s, one thread; uniform / fit "
          f"{uniform / r1.mse:.2f}); history {[h[0] for h in r1.history]}")
    print(f"[smoke] fit fig2 Adam step: {prof['kernels']} kernels, {prof['memsets']} memsets, "
          f"{prof['device_copies']} copies on the device, {prof['host_copies']} to or from "
          f"the host (torch.profiler, eager); {prof['eager_ms']:.3f} ms eager, "
          f"{prof['graph_ms']:.3f} ms as a CUDA graph replay (median of 5 chunks of 50)")

    # (b) gen_tables --fast on the card re-fits shipped pairs
    shipped = {(f, b): sfu.TABLE_DIR / f"{f}_{b}bp.npz" for f, b in FIT_REFITS}
    digests = {k: hashlib.sha256(p.read_bytes()).hexdigest() for k, p in shipped.items()}
    root = tmp / "refit"
    store = sfu.TableStore(root=root)
    for f, b in FIT_REFITS:
        argv = ["--fast", "--device", "cuda", "--root", str(root), "--functions", f,
                "--breakpoints", str(b)]
        _, secs, steps = _timed(torch, lambda: gen_tables.main(argv))
        prov = store.provenance(f, b)
        check(prov is not None, f"gen_tables wrote no {f} {b}bp artifact")
        missing = {"schema", "fn", "n_breakpoints", "n_segments", "fit", "repro_version",
                   "created_unix", "mse", "mae", "range", "fit_config", "generator"} - set(prov)
        check(not missing and prov["generator"] == "repro_torch.core.gen_tables"
              and prov["fit_config"]["init"] == "curvature",
              f"{f} {b}bp provenance incomplete: {missing}")
        with np.load(shipped[(f, b)]) as data:
            ship_mse = float(data["mse"])
        ratio = prov["mse"] / ship_mse
        check(ratio <= 1.1, f"re-fit {f} {b}bp: MSE {prov['mse']:.4g} is {ratio:.3f}x the "
                            f"shipped {ship_mse:.4g}")
        out[f"refit {f} {b}"] = {"seconds": secs, "steps": steps, "ratio": ratio}
        print(f"[smoke] fit gen_tables --fast {f} {b} bp on the card: {secs:.2f} s, {steps} "
              f"Adam steps, {secs * 1e3 / steps:.3f} ms a step; MSE {prov['mse']:.4g} = "
              f"{ratio:.3f}x the shipped {ship_mse:.4g}")
    for k, p in shipped.items():
        check(hashlib.sha256(p.read_bytes()).hexdigest() == digests[k],
              f"the shipped artifact {p.name} changed")

    # (c) fit-on-miss on the card, its table through the GLU kernel
    miss = sfu.TableStore(root=tmp / "miss", fit_on_miss=True,
                          fit_config=gen_tables.fit_config(fast=True))
    check(miss.fit_device == "cuda", "fit-on-miss must default to the card")
    table, secs, steps = _timed(torch, lambda: miss.get(fn="gelu_tanh",
                                                        n_breakpoints=FIT_MISS_BP))
    prov = miss.provenance("gelu_tanh", FIT_MISS_BP)
    check(prov is not None and prov["trigger"] == "fit-on-miss", "fit-on-miss provenance")
    check(table.n_breakpoints == FIT_MISS_BP and bool(torch.all(table.bp[1:] > table.bp[:-1])),
          "fit-on-miss table")
    spec = F.get("gelu_tanh")
    uniform = pwl.mse(pwl.make_uniform_table(spec, FIT_MISS_BP), spec, *spec.default_range)
    check(prov["mse"] < uniform, f"fit-on-miss MSE {prov['mse']:.4g} >= uniform {uniform:.4g}")
    out["miss"] = {"seconds": secs, "steps": steps, "mse": prov["mse"]}
    print(f"[smoke] fit-on-miss gelu_tanh {FIT_MISS_BP} bp on the card: {secs:.2f} s, {steps} "
          f"Adam steps, {secs * 1e3 / steps:.3f} ms a step; MSE {prov['mse']:.4g} (uniform "
          f"{uniform:.4g})")
    torch.backends.cuda.matmul.allow_tf32 = False
    plan, tables = plan_and_operands(table)
    tables = tuple(t.cuda() for t in tables)
    gen = torch.Generator(device="cuda").manual_seed(17)
    scale = 1.0 / math.sqrt(K_DIM)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        wg = (torch.randn(K_DIM, N_DIM, generator=gen, device="cuda") * scale).to(dtype)
        wu = (torch.randn(K_DIM, N_DIM, generator=gen, device="cuda") * scale).to(dtype)
        for M in (4, TRAIN_TOKENS):
            x = torch.randn(M, K_DIM, generator=gen, device="cuda").to(dtype)
            n0 = fused_glu.launches
            got = fused_glu(x, wg, wu, table=table)
            check(fused_glu.launches == n0 + 1, f"fit-on-miss GLU M={M} {dtype}: no launch")
            want = fused_glu_plain(x, wg, wu, plan, tables)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), atol=tol, rtol=tol),
                f"fit-on-miss GLU M={M} {dtype}: max err {err} > {tol}")
            k_ms = time_ms(torch, lambda i: fused_glu(x, wg, wu, table=table))
            p_ms = time_ms(torch, lambda i: fused_glu_plain(x, wg, wu, plan, tables), reps=5)
            out[f"glu {M} {dtype}"] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err}
            print(f"[smoke] fused_glu with the fit-on-miss table (gelu_tanh {FIT_MISS_BP} bp) "
                  f"M={M} K={K_DIM} N={N_DIM} {dtype}: max_abs_err {err:.3g} (tol {tol}), "
                  f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us")

    # (d) the model path under a uniform table and under the fallback
    for tag, changes, n_warn in (("uniform", {"fit": sfu.FIT_UNIFORM}, 0),
                                 ("fallback", {"n_segments": FIT_MISS_BP + 1}, 1)):
        path = _edited_plan(tmp, f"{tag}_plan.json", **changes)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            counts = serve_phase(torch, ["--plan", path], no_attention_kernels)
        got = [str(w.message) for w in rec if UNIFORM_FALLBACK in str(w.message)]
        check(len(got) == n_warn, f"{tag} plan: {len(got)} uniform-fallback warnings, "
                                  f"not {n_warn}: {got}")
        for name in ("fused_glu", "rope_write_prompt_pages_", "rope_append_kv_"):
            check(counts[name] == default_counts[name],
                  f"{tag} plan: {name} launches {counts[name]} != the default session's "
                  f"{default_counts[name]}")
        out[f"serve {tag}"] = counts
    print(f"[smoke] fitting phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# slice 18: tables above 64 breakpoints (the wide instantiation of every table kernel)

WIDE_BPS = (65, 128)  # past the 64 breakpoints of the shared-memory build
WIDE_SEGMENTS = 129   # the wide serve session's plan: 128 breakpoints


def _wide_table(fn: str, n_bp: int):
    """A uniform table of ``fn`` (``fit="uniform"``: no fit, any size)."""
    from repro_torch import sfu

    return sfu.get_store().get(fn=fn, n_breakpoints=n_bp, fit="uniform")


@contextlib.contextmanager
def _all_wide():
    """Every table through the kernels' wide instantiation, however few its
    breakpoints (the shared-memory cap set to 0 in ``epilogue.is_wide``)."""
    from repro_torch.kernels.fused import epilogue

    prev, epilogue.PWL_MAX_BP = epilogue.PWL_MAX_BP, 0
    try:
        yield
    finally:
        epilogue.PWL_MAX_BP = prev


def _wide_families(torch) -> list[dict]:
    """Every kernel family at one shape: ``run(table, plain)`` gives its
    outputs on the card, through the kernel wrappers (their launches
    counted) or through the plain versions on the same tensors; ``fwd``
    times the forward kernel; ``bound`` is the forward's least time (the
    bytes it must move against its products' or decodes' operations);
    ``on_path`` marks the family and shape a served model's 129-segment
    session runs.
    Integer-grid inputs (``_igrid``) wherever a product feeds the decode, so
    every pre-activation is an exact f32 sum in any order and the kernel
    decodes the plain version's segment."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import pwl_act as P
    from repro_torch.kernels.fused import (
        fused_flash_attention,
        fused_glu,
        fused_linear,
        fused_moe_glu,
        fused_pwl_softmax,
        fused_rmsnorm,
        paged_flash_decode,
    )
    from repro_torch.kernels.fused import attention as A
    from repro_torch.kernels.fused import glu as G
    from repro_torch.kernels.fused import linear as L
    from repro_torch.kernels.fused import norm as N
    from repro_torch.kernels.fused import softmax as S
    from repro_torch.kernels.fused.decoding import paged_flash_decode_plain
    from repro_torch.kernels.fused.epilogue import device_operands

    gen = torch.Generator(device="cuda").manual_seed(28)

    def grid(*shape, dtype=torch.bfloat16, span=4, step=1 / 16):
        return _igrid(torch, gen, shape, dtype, span=span, step=step)

    def ops_of(table):
        return device_operands(table, None, "cuda")

    fams = []

    def glu_family(dtype, M):
        x, g = grid(M, K_DIM, dtype=dtype), grid(M, N_DIM, dtype=dtype)
        wg, wu = grid(K_DIM, N_DIM, dtype=dtype), grid(K_DIM, N_DIM, dtype=dtype)

        def run(table, plain):
            plan, tabs = ops_of(table)
            if plain:
                return (G.fused_glu_plain(x, wg, wu, plan, tabs),
                        *G.fused_glu_bwd_plain(x, wg, wu, g, plan, tabs))
            return (fused_glu(x, wg, wu, table=table), *G.fused_glu_bwd(x, wg, wu, g, plan, tabs))

        esize, bf16 = x.element_size(), dtype == torch.bfloat16
        return {"name": "fused_glu", "lib": "glu", "fn": "gelu_tanh", "run": run,
                "shape": f"M={M} K={K_DIM} N={N_DIM} {str(dtype).split('.')[-1]}",
                "fwd": lambda table: fused_glu(x, wg, wu, table=table),
                "plain": lambda table: G.fused_glu_plain(x, wg, wu, *ops_of(table)),
                "bound": (_bound if bf16 else _f32_bound)(
                    (M * K_DIM + 2 * K_DIM * N_DIM + M * N_DIM) * esize, 4.0 * M * K_DIM * N_DIM),
                "on_path": bf16, "tol": 1e-2 if bf16 else 1e-4, "replaces": "glu.py:30"}

    fams.append(glu_family(torch.bfloat16, 512))
    fams.append(glu_family(torch.float32, 32))

    C = 40  # olmoe's bucket capacity at a 256-token prefill
    xb, gb = grid(MOE_E, C, MOE_K), grid(MOE_E, C, MOE_N)
    wgm, wum = grid(MOE_E, MOE_K, MOE_N), grid(MOE_E, MOE_K, MOE_N)

    def moe_run(table, plain):
        plan, tabs = ops_of(table)
        if plain:
            return (G.fused_glu_plain(xb, wgm, wum, plan, tabs),
                    *G.fused_glu_bwd_plain(xb, wgm, wum, gb, plan, tabs))
        return (fused_moe_glu(xb, wgm, wum, table=table),
                *G.fused_glu_bwd(xb, wgm, wum, gb, plan, tabs, fused_moe_glu))

    fams.append({"name": "fused_moe_glu", "lib": "glu", "fn": "silu", "run": moe_run,
                 "shape": f"E={MOE_E} C={C} K={MOE_K} N={MOE_N} bf16",
                 "fwd": lambda table: fused_moe_glu(xb, wgm, wum, table=table),
                 "plain": lambda table: G.fused_glu_plain(xb, wgm, wum, *ops_of(table)),
                 "bound": _bound((MOE_E * C * (MOE_K + MOE_N) + 2 * MOE_E * MOE_K * MOE_N) * 2,
                                 4.0 * MOE_E * C * MOE_K * MOE_N),
                 "tol": 1e-2, "replaces": "moe.py:41"})

    def linear_family(dtype, M):
        x, g = grid(M, K_DIM, dtype=dtype), grid(M, N_DIM, dtype=dtype)
        w, b = grid(K_DIM, N_DIM, dtype=dtype), grid(N_DIM, dtype=dtype)

        def run(table, plain):
            plan, tabs = ops_of(table)
            if plain:
                return (L.fused_linear_plain(x, w, b, plan, tabs),
                        L.fused_linear_bwd_plain(x, w, b, g, plan, tabs))
            return fused_linear(x, w, b, table=table), L.fused_linear_bwd(x, w, b, g, plan, tabs)

        return {"name": "fused_linear", "lib": "glu", "fn": "gelu", "run": run,
                "shape": f"M={M} K={K_DIM} N={N_DIM} {str(dtype).split('.')[-1]}, bias",
                "fwd": lambda table: fused_linear(x, w, b, table=table),
                "plain": lambda table: L.fused_linear_plain(x, w, b, *ops_of(table)),
                "bound": (_bound if dtype == torch.bfloat16 else _f32_bound)(
                    (M * K_DIM + K_DIM * N_DIM + N_DIM + M * N_DIM) * x.element_size(),
                    2.0 * M * K_DIM * N_DIM),
                "tol": 1e-2 if dtype == torch.bfloat16 else 1e-4, "replaces": "linear.py:54"}

    fams.append(linear_family(torch.bfloat16, 512))
    fams.append(linear_family(torch.float32, 32))

    def softmax_family(B, H, Sq, T, causal):
        x = torch.randn(B, H, Sq, T, generator=gen, device="cuda") * 3
        g = torch.randn(B, H, Sq, T, generator=gen, device="cuda")
        x2, g2 = x.reshape(-1, T), g.reshape(-1, T)
        mask = S.static_mask(x2.shape[0], T, Sq, causal, None, device="cuda") if causal else None

        def run(table, plain):
            plan, tabs = ops_of(table)
            if plain:
                return (S.fused_pwl_softmax_plain(x2, mask, plan, tabs),
                        S.fused_pwl_softmax_bwd_plain(x2, mask, g2, plan, tabs))
            return (fused_pwl_softmax(x, table=table, causal=causal).reshape(-1, T),
                    S.fused_pwl_softmax_bwd(x2, None, g2, plan, tabs, Sq, causal))

        return {"name": "fused_pwl_softmax", "lib": "softmax", "fn": "exp", "run": run,
                "shape": f"{B * H}x{Sq} rows x {T}{' causal' if causal else ''} f32",
                "fwd": lambda table: fused_pwl_softmax(x, table=table, causal=causal),
                "plain": lambda table: S.fused_pwl_softmax_plain(x2, mask, *ops_of(table)),
                "bound": _elementwise_bound(x.numel(), 4, SEARCH_OPS), "on_path": causal,
                "tol": 1e-4, "replaces": "softmax.py:69"}

    fams.append(softmax_family(1, HKV, 32, 32, True))
    fams.append(softmax_family(4, HKV, 1, WHISPER_FRAMES, False))

    kv_len = [19, 32, 15, 0]
    n_cols, pages = 4, 17
    rows = _fragmented_table(len(kv_len), n_cols, pages)
    tab = torch.zeros((len(kv_len), n_cols), dtype=torch.int32)
    for b, r in enumerate(rows):
        tab[b, :len(r)] = torch.tensor(r)
    tab = tab.cuda()
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    q1 = grid(len(kv_len), 1, HKV, DH, span=8, step=0.125)
    kp, vp = grid(HKV, pages, PS, DH, span=8, step=0.125), grid(HKV, pages, PS, DH, span=8,
                                                                 step=0.125)

    def decode_run(table, plain):
        if plain:
            return (paged_flash_decode_plain(q1, kp, vp, tab, lens, *ops_of(table), n_cols),)
        return (paged_flash_decode(q1, kp, vp, tab, lens, table=table),)

    fams.append({"name": "paged_flash_decode", "lib": "decoding", "fn": "exp", "run": decode_run,
                 "shape": f"B=4 Hkv={HKV} dh={DH} ps={PS} bf16 pools, kv_len 19/32/15/0",
                 "fwd": lambda table: paged_flash_decode(q1, kp, vp, tab, lens, table=table),
                 "plain": lambda table: paged_flash_decode_plain(q1, kp, vp, tab, lens,
                                                                 *ops_of(table), n_cols),
                 "bound": _f32_bound(2 * (q1.numel() * 2 + sum(kv_len) * HKV * DH * 2),
                                     sum(kv_len) * HKV * (4.0 * DH + SEARCH_OPS)),
                 "on_path": True, "tol": 1e-2, "replaces": "decoding.py:72"})

    def flash_family(dtype, Sq):
        q = grid(1, Sq, HKV, DH, dtype=dtype, span=8, step=0.125)
        k = grid(1, Sq, HKV, DH, dtype=dtype, span=8, step=0.125)
        v = grid(1, Sq, HKV, DH, dtype=dtype, span=8, step=0.125)
        dout = grid(1, Sq, HKV, DH, dtype=dtype, span=8, step=0.125)
        kw = {"causal": True, "window": None, "q_offset": 0, "kv_valid_len": None}

        def run(table, plain):
            plan, tabs = ops_of(table)
            if plain:
                out, m = A.fused_flash_attention_plain(q, k, v, plan, tabs, **kw)
                return (out, m, *A.fused_flash_attention_bwd_plain(q, k, v, dout, m, plan, tabs,
                                                                   **kw))
            out = fused_flash_attention(q, k, v, table=table, causal=True)
            m = A._launch(q, k, v, plan, tabs, True, None, 0, None, True)[1]  # the saved row max
            return (out, m, *A.fused_flash_attention_bwd(q, k, v, dout, m, plan, tabs, **kw))

        return {"name": "fused_flash_attention", "lib": "attention", "fn": "exp", "run": run,
                "shape": f"S=T={Sq} causal H={HKV} dh={DH} {str(dtype).split('.')[-1]}",
                "fwd": lambda table: fused_flash_attention(q, k, v, table=table, causal=True),
                "plain": lambda table: A.fused_flash_attention_plain(q, k, v, *ops_of(table),
                                                                     **kw)[0],
                "bound": (_bound if dtype == torch.bfloat16 else _f32_bound)(
                    4 * q.numel() * q.element_size(), 2.0 * HKV * Sq * Sq * DH),
                "tol": 1e-2 if dtype == torch.bfloat16 else 1e-4, "replaces": "attention.py:100"}

    fams.append(flash_family(torch.bfloat16, 1024))
    fams.append(flash_family(torch.float32, 256))

    xn = torch.randn(TRAIN_TOKENS, K_DIM, generator=gen, device="cuda").to(torch.bfloat16)
    sn = torch.randn(K_DIM, generator=gen, device="cuda") * 0.1
    gn = torch.randn(TRAIN_TOKENS, K_DIM, generator=gen, device="cuda").to(torch.bfloat16)

    def norm_run(table, plain):
        plan, tabs = ops_of(table)
        if plain:
            return (N.fused_rmsnorm_plain(xn, sn, plan, tabs, NORM_EPS),
                    *N.fused_rmsnorm_bwd_plain(xn, sn, gn, plan, tabs, NORM_EPS))
        return (fused_rmsnorm(xn, sn, table=table),
                *N.fused_rmsnorm_bwd(xn, sn, gn, plan, tabs, NORM_EPS))

    fams.append({"name": "fused_rmsnorm", "lib": "norm", "fn": "gelu", "run": norm_run,
                 "shape": f"M={TRAIN_TOKENS} D={K_DIM} bf16", "norm": (xn, sn, gn),
                 "fwd": lambda table: fused_rmsnorm(xn, sn, table=table),
                 "plain": lambda table: N.fused_rmsnorm_plain(xn, sn, *ops_of(table), NORM_EPS),
                 "bound": _norm_bound(TRAIN_TOKENS, K_DIM, 2, 128, False), "tol": 1e-2,
                 "replaces": "norm.py:31"})

    xa = torch.randn(TRAIN_TOKENS, N_DIM, generator=gen, device="cuda").to(torch.bfloat16) * 3

    def act_run(table, plain):
        plan, tabs = ops_of(table)
        if plain:
            return (P.pwl_nonuniform_plain(xa, *tabs),)
        return (ops.pwl_activation(xa, table),)

    fams.append({"name": "pwl_activation", "lib": "pwl_act", "fn": "gelu_tanh", "run": act_run,
                 "shape": f"{TRAIN_TOKENS} x {N_DIM} bf16", "bitwise": True,
                 "fwd": lambda table: ops.pwl_activation(xa, table),
                 "plain": lambda table: P.pwl_nonuniform_plain(xa, *ops_of(table)[1]),
                 "bound": _elementwise_bound(xa.numel(), 2, SEARCH_OPS), "tol": 0.0,
                 "replaces": "pwl_act.py:40"})

    xu = torch.randn(TRAIN_TOKENS, N_DIM, generator=gen, device="cuda").to(torch.bfloat16) * 6

    on_card = {}

    def uniform_args(table):
        """The uniform baseline's (m, q, lo, hi) from a uniform table, m and
        q copied to the card once (a graph capture copies nothing): its
        inner segments span [bp_0, bp_-1] in equal widths."""
        if id(table) not in on_card:
            on_card[id(table)] = (table, table.m.cuda(), table.q.cuda())
        _, m, q = on_card[id(table)]
        return m, q, float(table.bp[0]), float(table.bp[-1])

    def uni_plain(table):
        m, q, lo, hi = uniform_args(table)
        return P.pwl_uniform_plain(xu, ops.pack_uniform(m, q), lo, hi)

    def uni_run(table, plain):
        return (uni_plain(table) if plain
                else ops.pwl_activation_uniform(xu, *uniform_args(table)),)

    fams.append({"name": "pwl_activation_uniform", "lib": "pwl_act", "fn": "sigmoid",
                 "run": uni_run, "shape": f"{TRAIN_TOKENS} x {N_DIM} bf16", "bitwise": True,
                 "fwd": lambda table: ops.pwl_activation_uniform(xu, *uniform_args(table)),
                 "plain": uni_plain,
                 "bound": _elementwise_bound(xu.numel(), 2, SEARCH_OPS), "tol": 0.0,
                 "replaces": "pwl_act.py:52"})
    return fams


def wide_table_phase(torch) -> dict:
    """Tables above 64 breakpoints through every kernel family (the wide
    instantiation, ``csrc/pwl_decode.cuh``), forward and backward where the
    family has one, each at one shape:

    (a) at 32 breakpoints, the wide instantiations (every table sent there)
        give bitwise the outputs of the shared-memory ones: the two decodes
        are one function;
    (b) at 65 and 128 breakpoints (uniform tables) each family's outputs
        against its plain version on the same tensors, with today's
        tolerances (bf16 1e-2, f32 1e-4 of each output's max; the
        standalone kernels bitwise; the RMSNorm's dx by ``_norm_band``),
        each launch counted (the shared-memory instantiation refuses more
        than 64 breakpoints, so a launch that runs took the wide one);
    (c) the GLU's recorded digests (``GLU_DIGESTS``) once more, and every
        forward timed at 32 (shared memory) and 128 breakpoints (wide),
        with the plain version at 128.

    Returns the 128-breakpoint row of each family for the kernels line."""
    t0 = time.perf_counter()
    fams = _wide_families(torch)
    rows = {}
    for fam in fams:
        what = f"wide {fam['name']} {fam['shape']}"
        t32 = _wide_table(fam["fn"], 32)
        narrow = fam["run"](t32, False)
        with _all_wide():
            wide = fam["run"](t32, False)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(narrow, wide)):
            _bitwise(torch, b, a, f"{what} output {i}: wide vs shared-memory instantiation")
        errs = {}
        for n_bp in WIDE_BPS:
            table = _wide_table(fam["fn"], n_bp)
            before = read_counters()
            got = fam["run"](table, False)
            launched = {k: v - before[k] for k, v in read_counters().items() if v != before[k]}
            want = fam["run"](table, True)
            torch.cuda.synchronize()
            check(launched, f"{what} at {n_bp}: no launch counted")
            err = 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                tag = f"{what} at {n_bp} breakpoints, output {i}"
                if fam.get("bitwise"):
                    _bitwise(torch, a, b, tag)
                elif "norm" in fam and i == 1:  # dx: a slope may flip in the rounding band
                    xn, sn, gn = fam["norm"]
                    plan, tabs = _epilogue_operands(torch, {"table": table})[1]
                    e, line = _norm_band(torch, xn, sn, gn, a, b, plan, tabs, fam["tol"], tag)
                    print(f"[smoke]   {tag}: {line}")
                    err = max(err, e)
                    continue
                else:
                    err = max(err, _compare_scaled(torch, a, b, fam["tol"], tag))
            errs[n_bp] = err
        ms32 = time_ms(torch, lambda i: fam["fwd"](t32))
        table = _wide_table(fam["fn"], 128)
        ms128 = time_ms(torch, lambda i: fam["fwd"](table))
        plain_ms = time_ms(torch, lambda i: fam["plain"](table), reps=3, iters=3)
        bound = fam["bound"]
        print(f"[smoke] {what}: wide instantiation bitwise the shared-memory one at 32 "
              "breakpoints; "
              f"max_abs_err {errs[65]:.3g} (65), {errs[128]:.3g} (128) against the plain version; "
              f"forward {ms32 * 1e3:.2f} us at 32 (shared memory), {ms128 * 1e3:.2f} us at 128 "
              f"(wide), plain {plain_ms * 1e3:.2f} us, bound {bound['bound_ms'] * 1e3:.2f} us "
              f"({bound['bound_by']})")
        rows.setdefault(fam["name"], []).append({
            "shape": fam["shape"], "replaces": fam["replaces"], "max_abs_err": errs[128],
            "ms": ms128, "ms32": ms32, "plain_ms": plain_ms, **bound, "library_ms": None,
            "on_path": fam.get("on_path", False)})
    digests = glu_digests(torch)
    check(digests == GLU_DIGESTS, f"GLU digests changed: {digests}")
    secs = time.perf_counter() - t0
    print(f"[smoke] wide_table_phase: {len(fams)} families at {WIDE_BPS} breakpoints, GLU "
          f"digests unchanged, {secs:.1f}s")
    return rows


# ---------------------------------------------------------------------------
# slice 18: the guard and the faults on the paged serving path

# The default repro-100m session (serve's defaults, guard off, 19 model
# calls) on the parent commit b6acc86: its kernel launches (profile_serve.py's
# count, 695.95 a call) and the sha256 of its requests' tokens
# (``_tokens_digest``), alike in both trees' runs of the A/B call that
# measured them on one card (NVIDIA H100 80GB HBM3, 700 W).
PARENT_SESSION_LAUNCHES = 13223
PARENT_TOKENS_SHA256 = "ff65805755f5019e68dd4e728ad569c79559239c57f7cf067c5c3aaaf2f683b0"
GUARD_NAN_STEP = 2  # the decode step whose model call takes the injected NaN


def _tokens_digest(results) -> str:
    """sha256 of a session's tokens, request by request in id order."""
    import hashlib

    rows = sorted((r.request_id, list(r.tokens)) for r in results)
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def _profiled_session(torch, argv: list[str]) -> dict:
    """A full-width serve session under ``torch.profiler`` (the session
    alone), after the same session once unprofiled, as ``profile_serve.py``
    warms up: its kernel launches (``cudaLaunchKernel`` / ``cuLaunchKernel``
    calls, as that script counts them), model calls and tokens' digest."""
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    serve.run(args)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    summary = serve.run(args, session=lambda: prof)
    torch.cuda.synchronize()
    calls = summary["prefills"] + summary["decode_steps"]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return {"launches": launches, "launches_per_call": launches / calls, "calls": calls,
            "tokens_sha256": _tokens_digest(summary["results"]),
            "engine": summary["engine"], "results": summary["results"]}


def _timed_session(torch, model, params, requests, degrade_at=None, witness=None,
                   max_slots=4, **engine_kw) -> dict:
    """One engine session over ``requests`` with every model call timed
    (synchronized before and after: the guard's copy to the host
    synchronizes anyway), and each decode step's logits, active slots and
    their requests kept.  ``degrade_at`` = (step, sites): that decode step
    runs the engine's degraded model (the sites at ``impl="jnp"``) with no
    fault, the reference a faulted session's re-run must reproduce bit for
    bit.  ``witness`` = site: before decode step ``GUARD_NAN_STEP`` runs,
    the same step runs on the same state twice more, on the degraded model
    (the ladder's first rung) and on the fused model with every element of
    the site's kernel output (the GLU hidden the rung replaces) moved one
    ulp up or down at random: what rounding differences of one ulp there
    do to the logits.  Their logits are kept, and layer 0's kernel call of
    the second with its inputs.  Each of those calls writes the rows the
    step writes, and the step itself rewrites them after."""
    from repro_torch.kernels import fused
    from repro_torch.serving import PagedServingEngine

    longest = max(len(r.prompt) + r.max_new_tokens for r in requests)
    eng = PagedServingEngine(model, params, max_slots=max_slots, page_size=PS,
                             max_context=longest + PS, **engine_kw)
    calls = []
    kept = {"logits": {}, "active": {}, "requests": {}}
    device_call, exec_ = eng._device_call, eng._exec

    def timed(fn, args, phase):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = device_call(fn, args, phase)
        torch.cuda.synchronize()
        calls.append((fn, phase, (time.perf_counter() - t) * 1e3))
        return out

    def witnessed(args):
        name = "fused_moe_glu" if witness.startswith("moe.expert:") else "fused_glu"
        glu = getattr(fused, name)
        first = []
        gen = torch.Generator(device="cuda").manual_seed(0)

        def one_ulp_off(*a, **k):
            out = glu(*a, **k)
            if not first:
                first.append((a, k, out))
            bits = {2: torch.int16, 4: torch.int32}[out.element_size()]
            step = torch.randint(0, 2, out.shape, generator=gen, device=out.device,
                                 dtype=bits).mul_(2).sub_(1)
            step = torch.where(out == 0, torch.ones_like(step), step)  # never -0 - 1 (a NaN)
            return (out.view(bits) + step).view(out.dtype)

        rung = eng._degraded_fns((witness,), "jnp")["decode"](eng.params, *args)[0]
        setattr(fused, name, one_ulp_off)
        try:
            ulp = eng._fns["decode"](eng.params, *args)[0]
        finally:
            setattr(fused, name, glu)
        kept["witness"] = {"rung": rung[:, 0].float().clone(), "ulp": ulp[:, 0].float().clone()}
        kept["glu"] = first[0]

    def keeping(phase, args):
        step = eng.decode_steps
        if phase == "decode" and witness is not None and step == GUARD_NAN_STEP:
            witnessed(args)
        logits = exec_(phase, args)
        if phase == "decode":
            active = list(eng.sched.active_slots())
            kept["logits"][step] = logits[:, 0].float().clone()
            kept["active"][step] = active
            kept["requests"][step] = {eng.sched.slot(i).request.request_id: i for i in active}
        return logits

    eng._device_call, eng._exec = timed, keeping
    if degrade_at is not None:
        step, sites = degrade_at
        primary = eng._fns["decode"]

        def decode(*args):
            if eng.decode_steps == step:
                return eng._degraded_fns(sites, "jnp")["decode"](*args)
            return primary(*args)

        eng._fns = {**eng._fns, "decode": decode}
    res = {r.request_id: list(r.tokens) for r in eng.run(requests)}
    degraded = {id(f) for fns in eng._degraded_cache.values() for f in fns.values()}
    return {"engine": eng, "tokens": res, "kept": kept,
            "call_ms": [ms for f, _, ms in calls if id(f) not in degraded],
            "degraded_ms": [ms for f, _, ms in calls if id(f) in degraded]}


def _rung_within_rounding(torch, site: str, plan, kept_glu) -> str:
    """The degrade ladder's first rung (``layers.plain_glu``, the site's
    table at ``impl="jnp"``) against the fused kernel's output on the
    kernel's own inputs at the model's shape (layer 0 at the NaN step):
    every element within one ulp of the kernel's plus the f32 summation
    order's bound, 2.4·(K + 2)·2⁻²⁴·(|x|@|w_gate|)·(|x|@|w_up|) (each f32
    product reordered by at most (K + 2)·2⁻²⁴ of its magnitudes, through an
    activation and a slope of at most 1.2).  Returns the line to print."""
    import dataclasses

    from repro_torch import sfu
    from repro_torch.models import layers

    (x, wg, wu), kw, kernel = kept_glu
    spec = dataclasses.replace(plan.spec(site), impl="jnp")
    act = sfu.ActivationPlan(sites=((site, spec),)).act(site)
    got = layers.plain_glu(act, x, wg, wu)
    xa = x.float().abs()
    bound = 2.4 * (x.shape[-1] + 2) * 2.0 ** -24 * (xa @ wg.float().abs()) * (xa @ wu.float().abs())
    ulp = torch.finfo(kernel.dtype).eps * kernel.float().abs()
    err = (got.float() - kernel.float()).abs()
    check(bool((err <= ulp + bound + torch.finfo(torch.float32).tiny).all()),
          f"{site}: the unfused rung is not within rounding of the fused kernel "
          f"(largest difference {float(err.max()):.4g})")
    differ = int((err > 0).sum())
    return (f"the first rung's GLU hidden against the kernel's (layer 0, {tuple(kernel.shape)}): "
            f"{differ} of {kernel.numel()} elements differ, by at most "
            f"{float((err / ulp.clamp_min(1e-30)).max()):.3g} ulp")


def _token_gate(torch, site: str, clean, faulted) -> str:
    """The faulted session's tokens against the fault-free session's: a
    request may change its tokens only from the NaN step on, and only at a
    step where the fault-free top-2 logit margin of its row lies within the
    band that rounding alone opens: the largest logit change a row that
    one-ulp differences in the site's kernel output made at the NaN step
    (``_timed_session``'s witness).  The first rung's own change there is
    held to 4 times that band, the factor of the repo's nudge rule
    (``_nudge_tol``).  Returns the line to print."""
    kc = clean["kept"]
    rows = kc["active"][GUARD_NAN_STEP]
    lc = kc["logits"][GUARD_NAN_STEP][rows]
    change = {k: (v[rows] - lc).abs().amax(dim=-1) for k, v in kc["witness"].items()}
    band = float(change["ulp"].max())

    def margin(step, slot):
        top2 = torch.topk(kc["logits"][step][slot], 2).values
        return float(top2[0] - top2[1])

    check(float(change["rung"].max()) <= 4 * band,
          f"{site}: the first rung moves the logits by {float(change['rung'].max()):.4g}, "
          f"more than 4 x the one-ulp band {band:.4g}")
    flips = {}
    for rid, got in faulted["tokens"].items():
        want = clean["tokens"][rid]
        if got == want:
            continue
        i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        step = i - 1  # token 0 comes from the prefill, token i from decode step i - 1
        check(step >= GUARD_NAN_STEP, f"{site}: {rid} changes its token {i}, before the NaN step")
        check(rid in kc["requests"].get(step, {}), f"{site}: {rid} changes its token {i}, "
              "past the fault-free session's end")
        m = margin(step, kc["requests"][step][rid])
        check(m <= band, f"{site}: {rid} changes its token {i} at decode step {step}, where the "
              f"fault-free top-2 margin {m:.4g} is outside the one-ulp band {band:.4g}")
        flips[rid] = (step, m)
    fmt = lambda t: ", ".join(f"{float(v):.4g}" for v in t)  # noqa: E731
    return (f"fault-free top-2 margins at step {GUARD_NAN_STEP}: "
            f"{fmt(margin(GUARD_NAN_STEP, r) for r in rows)}; the largest logit change a row "
            f"there of the first rung: {fmt(change['rung'])}, of one ulp at the site: "
            f"{fmt(change['ulp'])} (band {band:.4g}); {len(flips)} of {len(clean['tokens'])} "
            "requests change tokens"
            + "".join(f", {rid} from step {st} (margin {m:.4g})" for rid, (st, m) in flips.items()))


def _chaos_requests(cfg, with_deadline: bool):
    """``serve --chaos``'s requests at CI's shape (3 x 30 + 8), prompts as
    serve draws them; the last request's deadline 2 ticks when asked."""
    import numpy as np

    from repro_torch.serving import GenRequest

    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(3, 30),
                                                dtype=np.int64).astype(np.int32)
    return [GenRequest(request_id=f"req{i}", prompt=prompts[i].tolist(), max_new_tokens=8,
                       deadline_ticks=2 if (with_deadline and i == 2) else None)
            for i in range(3)]


def guard_phase(torch) -> dict:
    """``sfu.guard`` and ``serving.faults`` at full width (slice 18):

    (a) the default repro-100m session with the guard off under the
        profiler: its launches and tokens bitwise the parent's
        (``PARENT_*``); the same session with ``--guard``: the same tokens,
        its extra launches printed;
    (b) ``serve --guard`` and ``serve --chaos 0`` at CI's chaos shape
        (``--max-slots 2 --batch 3 --prompt-len 30 --max-new 8``) through
        ``serve.serve``: rc 0 each (no fused fallback; the chaos session's
        requests token-identical to its fault-free run, as JAX's rule
        demands), and the same chaos session replayed through the engine
        with req0 and req1 token-identical to a fault-free session that
        runs the NaN step degraded;
    (c) repro-100m and (d) olmoe-1b-7b (4 x 32 + 16) under the guard with a
        NaN at ``mlp:gelu_tanh`` / ``moe.expert:silu`` at decode step
        ``GUARD_NAN_STEP`` (olmoe also a kernel failure and a dropped tick):
        recovered once; tokens bitwise those of the fault-free session that
        runs that step degraded; the first rung's GLU hidden within
        rounding of the kernel's (``_rung_within_rounding``); tokens against
        the fault-free session changed only where rounding alone could
        change them (``_token_gate``); the degraded re-run's ms beside a
        call's.
    """
    import io

    import numpy as np

    from repro_torch import sfu
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import FaultInjector, FaultSpec, GenRequest, chaos_specs

    t0 = time.perf_counter()
    off = _profiled_session(torch, [])
    on = _profiled_session(torch, ["--guard"])
    print(f"[smoke] guard off: {off['launches']} launches in {off['calls']} model calls "
          f"({off['launches_per_call']:.2f} a call; the parent {PARENT_SESSION_LAUNCHES}), tokens "
          f"sha256 {off['tokens_sha256']}; guard on: {on['launches']} "
          f"({on['launches_per_call'] - off['launches_per_call']:.2f} more a call), clamped "
          f"{on['engine'].health_summary()['clamped']}")
    check(off["launches"] == PARENT_SESSION_LAUNCHES,
          f"guard off: {off['launches']} launches, the parent {PARENT_SESSION_LAUNCHES}")
    check(off["tokens_sha256"] == PARENT_TOKENS_SHA256,
          "guard off: the tokens are not bitwise the parent's")
    check(on["tokens_sha256"] == off["tokens_sha256"], "guard on: the tokens changed")
    check(not off["engine"].health_summary()["clamped"], "guard off: clamp counts kept")

    chaos_argv = ["--chaos", "0", "--max-slots", "2", "--batch", "3", "--prompt-len", "30",
                  "--max-new", "8"]
    rcs = {}
    for name, argv in (("--guard", ["--guard"]), ("--chaos 0", chaos_argv)):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rcs[name] = serve.serve(argv)
        text = out.getvalue() + err.getvalue()
        for ln in text.splitlines():
            if any(w in ln for w in ("health", "chaos", "fallbacks", "CHAOS")):
                print(f"[smoke]   serve {name}: {ln}")
        failures = [ln for ln in text.splitlines() if "CHAOS FAILURE" in ln]
        check(rcs[name] == 0 and not failures, f"serve {name} at full width: rc {rcs[name]}, "
              f"{failures}")
        if name == "--chaos 0":
            check("chaos session OK" in text, "serve --chaos 0 did not finish")
        print(f"[smoke] serve {name} at full width: rc {rcs[name]}")

    results = {}
    cfg = get_config("repro-100m", act_impl="fused")
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    site = sfu.site_key(sfu.SITE_MLP, cfg.activation)
    specs = chaos_specs(0, site, max_step=7)
    nan_step = next(s.step for s in specs if s.kind == "nan")
    alloc = [s for s in specs if s.kind == "alloc_exhaust"]
    kw = dict(max_slots=2, guard=True, policy="optimistic")
    chaos = _timed_session(torch, model, params, _chaos_requests(cfg, True),
                           faults=FaultInjector(specs), **kw)
    ref = _timed_session(torch, model, params, _chaos_requests(cfg, True),
                         faults=FaultInjector(alloc), degrade_at=(nan_step, (site,)), **kw)
    h = chaos["engine"].health_summary()
    check(h["nonfinite_recoveries"] == {site: 1} and h["preemptions"] >= 1 and h["timeouts"] >= 1,
          f"chaos replay: {h['nonfinite_recoveries']}, {h['preemptions']} preemptions, "
          f"{h['timeouts']} timeouts")
    for rid in ("req0", "req1"):
        check(chaos["tokens"][rid] == ref["tokens"][rid],
              f"chaos replay {rid}: {chaos['tokens'][rid]} != the degraded-step reference's "
              f"{ref['tokens'][rid]}")
    print(f"[smoke] chaos 0 replayed (NaN at step {nan_step}, a grow-scoped allocator fault at "
          f"step {alloc[0].step}, req2's deadline): req0, req1 token-identical to the fault-free "
          f"session that runs step {nan_step} degraded")
    del chaos, ref

    for arch, site in (("repro-100m", "mlp:gelu_tanh"), ("olmoe-1b-7b", "moe.expert:silu")):
        if arch != "repro-100m":
            cfg = get_config(arch, act_impl="fused")
            model = Model(cfg, device="cuda")
            params = model.init(seed=0)
        check(sfu.plan_for(cfg).spec(site).impl == "fused", f"{arch}: {site} is not fused")
        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(4, 32),
                                                    dtype=np.int64).astype(np.int32)

        def reqs():
            return [GenRequest(request_id=f"req{i}", prompt=prompts[i].tolist(),
                               max_new_tokens=16) for i in range(4)]

        specs = [FaultSpec("nan", GUARD_NAN_STEP, site)]
        if arch == "olmoe-1b-7b":
            specs += [FaultSpec("kernel_fail", 1), FaultSpec("drop_tick", 4)]
        clean = _timed_session(torch, model, params, reqs(), witness=site, guard=True)
        faulted = _timed_session(torch, model, params, reqs(), guard=True,
                                 faults=FaultInjector(specs))
        ref = _timed_session(torch, model, params, reqs(), guard=True,
                             degrade_at=(GUARD_NAN_STEP, (site,)))
        h = faulted["engine"].health_summary()
        kinds = [i["kind"] for i in h["incidents"]]
        check(h["nonfinite_recoveries"] == {site: 1}, f"{arch}: recoveries {h['nonfinite_recoveries']}")
        check("nonfinite_unrecovered" not in kinds, f"{arch}: unrecovered {kinds}")
        check({f["kind"] for f in h["faults_fired"]} == {s.kind for s in specs},
              f"{arch}: fired {h['faults_fired']}")
        check(faulted["tokens"] == ref["tokens"],
              f"{arch}: the faulted session's tokens are not those of the fault-free session that "
              "runs the NaN step degraded")
        rung = _rung_within_rounding(torch, site, sfu.plan_for(cfg), clean["kept"]["glu"])
        tokens = _token_gate(torch, site, clean, faulted)
        call_ms = float(np.median(clean["call_ms"]))
        results[arch] = {"call_ms": call_ms, "degraded_ms": faulted["degraded_ms"],
                         "incidents": kinds}
        print(f"[smoke] {arch} guard session, NaN at {site} step {GUARD_NAN_STEP}: incidents "
              f"{kinds}, recoveries {h['nonfinite_recoveries']}, clamped {h['clamped']}; tokens "
              f"bitwise the degraded-step reference's; a guarded call {call_ms:.2f} ms median, the "
              f"degraded re-run {', '.join(f'{ms:.2f}' for ms in faulted['degraded_ms'])} ms; "
              f"{rung}; {tokens}")
        del model, params, clean, faulted, ref
        _release(torch)
    secs = time.perf_counter() - t0
    print(f"[smoke] guard_phase: {secs:.1f}s")
    return {"off": off["launches_per_call"], "on": on["launches_per_call"], "chaos_rc": rcs,
            **results, "seconds": secs}


def wide_serve_phase(torch, tmp: pathlib.Path) -> dict:
    """Full-width repro-100m served under a dumped plan whose ``mlp`` and
    ``attn.softmax`` sites are fused at ``WIDE_SEGMENTS`` uniform segments
    (128 breakpoints): every GLU, row softmax and paged decode of the
    session on the kernels' wide instantiation (the shared-memory one
    refuses such a table, so every counted launch took the wide one)."""
    from repro_torch.kernels.fused import epilogue

    path = pathlib.Path(dump_plan(tmp / "wide_plan.json"))
    plan = json.loads(path.read_text())
    for _, spec in plan["sites"]:
        spec.update(n_segments=WIDE_SEGMENTS, fit="uniform")
    path.write_text(json.dumps(plan, indent=2))
    check(epilogue.is_wide(WIDE_SEGMENTS - 1), f"{WIDE_SEGMENTS} segments fit shared memory")
    return serve_phase(torch, ["--plan", str(path)], short_prompt_attention)


# ---------------------------------------------------------------------------
# slice 19: the per-site plan autotuner and the analytic roofline

AUTOTUNE_RUNS = (  # (tag, the autotune command line's arguments): full width
    ("repro-100m", ["--arch", "repro-100m", "--pwl-softmax"]),
    ("olmoe-1b-7b", ["--arch", "olmoe-1b-7b", "--quick"]),
    ("mamba2-2.7b", ["--arch", "mamba2-2.7b", "--quick"]),
)
AUTOTUNE_KERNELS = ("fused_glu", "fused_moe_glu", "fused_flash_attention")


def _glu_forward_band(torch, x, wg, wu, got, plan, tables, tol, what) -> tuple[float, str]:
    """The GLU's (or the MoE GLU's, batched) forward against its plain
    value ``PWL(zg) * zu`` in f32, element by element, at ``tol``
    (``torch.allclose``'s atol = rtol).  A table whose values jump at a
    breakpoint (an int8 table's independently rounded m and q) turns a
    pre-activation that the kernel's summation order moves across a
    breakpoint into an error the size of the jump, so an element off by
    more than ``tol`` must lie within the order band of a breakpoint of the
    plain pre-activation (``_order_band``'s) and take there, within ``tol``,
    the value of one of the breakpoint's two segments; at most
    ``MAX_FLIP_SHARE`` of the elements may.  Returns the max abs error
    outside those elements and a line to print."""
    u = 2.0 ** -24
    K = x.shape[-1]
    xf = x.float()
    zg, zu = xf @ wg.float(), xf @ wu.float()
    mag = xf.abs() @ wg.float().abs()
    g = got.float()

    def off(z):
        want = plan.apply_value_and_slope(z, *tables)[0] * zu
        return (g - want).abs() > tol + tol * want.abs()

    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    marked = off(zg)
    near, b = _near_breakpoint(torch, zg, tables, ORDER_BAND_C * (K + 1) * u * mag)
    wrong = marked & off(b) & off(torch.nextafter(b, torch.full_like(b, math.inf)))
    outside, n_wrong, flips = int((marked & ~near).sum()), int(wrong.sum()), int(marked.sum())
    check(outside == 0, f"{what}: {outside} outputs off the plain value outside the order band "
                        "of a breakpoint")
    check(n_wrong == 0, f"{what}: {n_wrong} outputs are neither segment's at their breakpoint")
    check(flips <= MAX_FLIP_SHARE * zg.numel(), f"{what}: {flips} outputs flipped a segment")
    want = plan.apply_value_and_slope(zg, *tables)[0] * zu
    err = (g - want).abs().masked_fill(marked, 0).max().item()
    return err, f"{flips} in the order band took the neighbouring segment"


def _flash_forward_band(torch, q, k, v, got, plan, tables, tol, what) -> tuple[float, str]:
    """The causal flash forward (B, S, H, dh with H = Hkv, one chain block:
    S = T <= 512) against its plain version at ``tol`` (allclose), widened
    row by row for the jumps of the table at its breakpoints: the kernel's
    shifted score s - m of a key lies within twice the order band of the
    plain one's (``ORDER_BAND_C`` (dh + 1) 2^-24 |q|.|k|, s and the row
    max each), and where that puts it within reach of a breakpoint its
    probability may take either segment's value, a change of at most the
    table's jump J there.  A row's output may then move by
    sum J |v - out| / (l - sum J) over those keys; a row with none is held
    at ``tol`` alone.  Returns the max abs error and a line to print."""
    from repro_torch.kernels.fused.attention import fused_flash_attention_plain
    from repro_torch.kernels.fused.softmax import pwl_exp

    u = 2.0 ** -24
    S, dh = q.shape[1], q.shape[3]
    check(k.shape[1] == S <= 512 and k.shape[2] == q.shape[2], f"{what}: not one chain block")
    want = fused_flash_attention_plain(q, k, v, plan, tables, causal=True, window=None,
                                       q_offset=0, kv_valid_len=None)[0].float()
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / math.sqrt(dh)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    s = torch.where(keep, s, -math.inf)
    x = s - s.amax(dim=-1, keepdim=True)
    mag = torch.einsum("bshd,bthd->bhst", qf.abs(), kf.abs()) * scale
    band = 2 * ORDER_BAND_C * (dh + 1) * u * mag.masked_fill(~keep, 0).amax(dim=-1, keepdim=True)
    p = torch.where(keep, pwl_exp(x.clamp(min=-1e4), plan, tables), 0.0)
    jump = torch.zeros_like(x)
    bps = tables[0].reshape(-1).float()
    right = torch.nextafter(bps, torch.full_like(bps, math.inf))
    jumps = (pwl_exp(right, plan, tables) - pwl_exp(bps, plan, tables)).abs()
    for b, j in zip(bps.tolist(), jumps.tolist()):
        jump = torch.where(keep & ((x - b).abs() <= band), jump.clamp(min=j), jump)
    l = p.sum(dim=-1)                                   # (B, H, S)
    j_sum = jump.sum(dim=-1)
    out = want.permute(0, 2, 1, 3)                      # (B, H, S, dh)
    dev = (vf.permute(0, 2, 1, 3)[:, :, None, :, :] - out[:, :, :, None, :]).abs()
    allow = torch.einsum("bhst,bhstd->bhsd", jump, dev) / (l - j_sum).clamp(min=1e-30)[..., None]
    g = got.float().permute(0, 2, 1, 3)
    err = (g - out).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    bad = int((err > tol + tol * out.abs() + allow).sum())
    check(bad == 0, f"{what}: {bad} outputs off the plain version by more than {tol} and the "
                    f"table's jumps within the order band")
    rows = int((j_sum > 1e-6).sum())
    return err.max().item(), f"{rows} rows with a key within the order band of a jump"


def _autotune_cfg(argv: list[str]):
    """The autotune command line's parsed arguments and the full-width
    config it searches."""
    from repro_torch.launch import autotune as cli
    from repro_torch.sfu.autotune import driver

    args = cli.build_parser().parse_args(argv)
    cfg = driver._model_cfg(driver.AutotuneConfig(arch=args.arch, quick=args.quick,
                                                  pwl_softmax=args.pwl_softmax))
    check((cfg.d_model, cfg.n_layers, cfg.n_experts) == FULL_WIDTH[args.arch],
          f"not full-width {args.arch}")
    return args, cfg


def _fused_candidates_against_plain(torch, argv: list[str]) -> list[str]:
    """Every fused candidate of one autotune run's sweep (all of them, not
    only those within the budget) through its kernel once at the site's
    workload, on the workload's inputs, held against the kernel's plain
    version there at 1e-2 (bf16), widened only where an int8 table's jumps
    at its breakpoints turn a summation-order flip into a jump-sized error:
    the GLU and the MoE GLU by ``_glu_forward_band``, the flash attention
    by ``_flash_forward_band``.  Returns a line a candidate: kernel,
    breakpoints, table format, max abs error."""
    from repro_torch import sfu
    from repro_torch.kernels.fused.epilogue import plan_and_operands
    from repro_torch.sfu.autotune import measure, space

    args, cfg = _autotune_cfg(argv)
    ran = []
    for key, _ in sfu.compile_plan(cfg).items():
        site, _, fn = key.partition(":")
        wl = measure.workload_for(cfg, site, quick=args.quick)
        check(wl.dtype == "bf16", f"{key}: workload in {wl.dtype}, not the config's bf16")
        for cand in space.candidates(site, fn, quick=args.quick):
            if cand.impl != "fused":
                continue
            run, inputs = measure._latency_thunk(cand, None, wl, "cuda")
            kernel = run.kernel
            n0 = kernel.launches
            got = run(*inputs)
            check(kernel.launches == n0 + 1, f"{key} {cand.to_json()}: kernel not launched")
            plan, tables = plan_and_operands(sfu.get_store().get(cand))
            tables = tuple(t.cuda() for t in tables)
            what = (f"autotune {args.arch} {key}: {kernel.__name__}, {cand.n_breakpoints} bp "
                    f"{cand.dtype} table, {tuple(inputs[0].shape)} bf16")
            band = _flash_forward_band if site == "attn.softmax" else _glu_forward_band
            err, note = band(torch, *inputs, got, plan, tables, 1e-2, what)
            ran.append(f"{what}: max_abs_err {err:.3g}; {note}")
            del got, inputs
    return ran


def _autotune_run(torch, argv: list[str], out: pathlib.Path, cache: pathlib.Path,
                  power: str) -> tuple[dict, dict, float]:
    """One ``python -m repro_torch.launch.autotune`` command line, called in
    this process (``launch.autotune.run``) with the launch counters reset
    before it and read after it.  Checks rc 0, the report's provenance (the
    card, its power limit, no interpret mode), that each site's chosen spec
    (the latency argmin) is within its budget and at most the baseline's µs,
    and that the plan's spec (the accuracy-first one after the e2e gate's
    fallback) is within its budget.  Returns the report, the counts and the
    seconds."""
    from repro_torch.launch import autotune as cli

    report = out.with_suffix(".report.json")
    reset_counters()
    t0 = time.perf_counter()
    rc = cli.run(argv + ["--out", str(out), "--report", str(report), "--cache-dir", str(cache)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counters()
    check(rc == 0, f"autotune {' '.join(argv)}: rc {rc}")
    rpt = json.loads(report.read_text())
    check(rpt["backend"] == "cuda" and not rpt["interpret_mode"] and not rpt["reduced"],
          f"autotune {' '.join(argv)}: backend {rpt['backend']}")
    check(rpt["device"] == torch.cuda.get_device_name(0) and rpt["power_limit"] == power,
          f"autotune provenance names {rpt['device']}, {rpt['power_limit']}")
    which = "accuracy_first" if rpt["accuracy_fallback"] else "chosen"
    for e in rpt["sites"]:
        c, b = e["chosen"], e["baseline"]
        check(c["mse"] <= e["budget_mse"] * (1 + 1e-9) and c["us"] <= b["us"],
              f"autotune {e['site']}: chosen mse {c['mse']} (budget {e['budget_mse']}), "
              f"{c['us']} us (baseline {b['us']})")
        check(e[which]["mse"] <= e["budget_mse"] * (1 + 1e-9) and c["block"] is None,
              f"autotune {e['site']}: the plan's mse {e[which]['mse']}, block {c['block']}")
    return rpt, counts, secs


def autotune_phase(torch, tmp: pathlib.Path, power: str) -> dict:
    """The autotuner on the card at full width (``AUTOTUNE_RUNS``): each
    run's fused candidates held against their plain versions first
    (``_fused_candidates_against_plain``), then the command line on a fresh
    cache directory; repro-100m's full sweep again on its warm cache (the
    plan byte-identical, no miss); mamba2's ``ssm:silu`` exact (budget 0);
    then ``serve --plan`` with repro-100m's emitted plan (serve's exit code
    0), whose counters must show each site's kernels launched where the plan
    chose ``fused`` and not where it chose ``jnp`` or ``exact``.  Prints each
    site's choice, µs, baseline µs, MSE and budget, the e2e metrics, the
    cache's hits and misses and each run's launches of the sweep's kernels.
    Where the e2e
    gate fell back to the accuracy-first plan, prints the e2e metrics of
    the latency argmin plan it refused, and serves repro-100m under that
    plan too (rc 0, its kernels launched where it says ``fused``)."""
    from repro_torch import sfu
    from repro_torch.sfu.autotune import driver, measure

    out = {}
    for tag, argv in AUTOTUNE_RUNS:
        t0 = time.perf_counter()
        ran = _fused_candidates_against_plain(torch, argv)
        for line in ran:
            print(f"[smoke] {line}")
        print(f"[smoke] autotune {tag}: {len(ran)} fused candidates within 1e-2 of their plain "
              f"versions ({time.perf_counter() - t0:.1f}s)")
        _release(torch)
        plan_path = tmp / f"autotune_{tag}.json"
        rpt, counts, secs = _autotune_run(torch, argv, plan_path, tmp / f"cache_{tag}", power)
        which = "accuracy_first" if rpt["accuracy_fallback"] else "chosen"
        for e in rpt["sites"]:
            c, b = e["chosen"], e["baseline"]
            s = c["spec"]
            print(f"[smoke] autotune {tag} {e['site']}: {s['impl']}/{s['n_segments'] - 1}bp/"
                  f"{s['dtype']} {c['us']:.3f} us (baseline {b['spec']['impl']}/"
                  f"{b['spec']['n_segments'] - 1}bp/{b['spec']['dtype']} {b['us']:.3f} us), mse "
                  f"{c['mse']:.4e} (budget {e['budget_mse']:.4e}), {e['n_within_budget']} of "
                  f"{e['n_candidates']} candidates within budget; in the plan "
                  f"{e[which]['spec']['impl']}/{e[which]['spec']['n_segments'] - 1}bp/"
                  f"{e[which]['spec']['dtype']}")
        print(f"[smoke] autotune {tag}: e2e {rpt['e2e']}, accuracy fallback "
              f"{rpt['accuracy_fallback']}; cache {rpt['cache']['hits']} hits, "
              f"{rpt['cache']['misses']} misses; {secs:.1f}s; launches "
              f"{ {k: counts[k] for k in AUTOTUNE_KERNELS} } ({rpt['device']}, "
              f"{rpt['power_limit']})")
        if rpt["accuracy_fallback"]:  # what the gate saw before it fell back
            e2e = measure.e2e_logit_check(_autotune_cfg(argv)[1],
                                          driver._assemble(rpt["sites"], "chosen"),
                                          seed=rpt["seed"])
            print(f"[smoke] autotune {tag}: e2e of the latency argmin plan {e2e} (min top-1 "
                  f"{rpt['objective']['min_top1']})")
        out[tag] = {"report": rpt, "counts": counts, "seconds": secs, "plan": plan_path}
        _release(torch)

    tag, argv = AUTOTUNE_RUNS[0]
    warm, _, secs = _autotune_run(torch, argv, tmp / f"autotune_{tag}_warm.json",
                                  tmp / f"cache_{tag}", power)
    check(warm["cache"]["misses"] == 0, f"warm rerun: {warm['cache']['misses']} misses")
    check((tmp / f"autotune_{tag}_warm.json").read_bytes() == out[tag]["plan"].read_bytes(),
          "warm rerun: the plan is not byte-identical")
    print(f"[smoke] autotune {tag} warm rerun: plan byte-identical, cache "
          f"{warm['cache']['hits']} hits, {warm['cache']['misses']} misses, {secs:.1f}s")

    mamba = out["mamba2-2.7b"]["report"]
    silu = next(e for e in mamba["sites"] if e["site"] == "ssm:silu")
    check(silu["budget_mse"] == 0.0 and silu["chosen"]["spec"]["impl"] == "exact",
          f"mamba2 ssm:silu chose {silu['chosen']['spec']} at budget {silu['budget_mse']}")

    # the sessions: the emitted plan, and the latency argmin where the gate fell back from it
    rpt = out[tag]["report"]
    plans = {"emitted": out[tag]["plan"]}
    if rpt["accuracy_fallback"]:
        plans["latency argmin"] = sfu.dump_plan(driver._assemble(rpt["sites"], "chosen"),
                                                tmp / f"autotune_{tag}_argmin.json")
    for what, path in plans.items():
        plan = sfu.load_plan(path)
        softmax = plan.get("attn.softmax:exp")
        attention = (short_prompt_attention if softmax is not None and softmax.impl == "fused"
                     else no_attention_kernels)
        fused_mlp = plan.spec("mlp:gelu_tanh").impl == "fused"
        print(f"[smoke] autotune {tag}: serve --plan <the {what} plan> {plan.fingerprint}")
        out[f"serve {what}"] = serve_phase(torch, ["--plan", str(path)], attention,
                                           ffn_layers=None if fused_mlp else 0, rc0=True)
    return out


def roofline_lines(trained: dict, long_trained: dict, session: dict, card: str) -> list[str]:
    """The analytic roofline (``repro_torch.roofline``) of runs already
    timed: model FLOPs of repro-100m's 8 x 512 and 1 x 4096 steps and their
    ``mfu``, model_flops_train / (989e12 x the median step seconds); the
    memory-bound time of the default serve session's decode call (4 slots,
    a cache of 32 + 16 positions) beside its measured ms a model call."""
    from repro_torch.configs import get_config
    from repro_torch.models import ShapeCell
    from repro_torch.roofline import model as roof

    cfg = get_config("repro-100m")
    lines = []
    for what, run, tokens in ((f"{TRAIN_BATCH} x {TRAIN_SEQ}", trained, TRAIN_TOKENS),
                              (f"{LONG_BATCH} x {LONG_SEQ}", long_trained,
                               LONG_BATCH * LONG_SEQ)):
        flops = roof.model_flops_train(cfg, tokens)
        mfu = flops / (roof.PEAK_FLOPS * run["step_ms"] * 1e-3)
        lines.append(f"[smoke] roofline repro-100m train {what}: model_flops_train {flops:.6g}, "
                     f"median step {run['step_ms']:.3f} ms, mfu {mfu:.6f} of "
                     f"{roof.PEAK_FLOPS:.4g} bf16 FLOP/s ({card})")
    cell = ShapeCell("serve decode", seq_len=32 + 16, global_batch=4, kind="decode")
    nbytes = roof.analytic_memory_traffic(cfg, cell, {})
    flops = roof.model_flops_decode(cfg, cell.global_batch, cell.seq_len)
    lines.append(f"[smoke] roofline repro-100m default serve decode call (B=4, cache "
                 f"{cell.seq_len}): {nbytes:.6g} bytes, memory-bound "
                 f"{nbytes / roof.HBM_BW * 1e6:.3f} us at {roof.HBM_BW:.4g} B/s "
                 f"({flops:.6g} FLOP, {flops / roof.PEAK_FLOPS * 1e6:.4f} us at the bf16 peak); "
                 f"measured {session['ms_per_call']:.3f} ms a model call ({card})")
    return lines


# ---------------------------------------------------------------------------
# slice 20: distribution.  The card is one, so the mesh's collectives are
# held on the CPU (tests/test_torch_mesh_*.py); here every fused kernel runs
# at the local shapes a rank of the (data=2, model=2) mesh hands it.

SHARD_MESH = ((2, 2), ("data", "model"))
SHARD_ARCHS = ("repro-100m", "olmoe-1b-7b", "qwen2.5-32b")
SHARD_DECODE_SLOTS = 4  # the paged decode cell: 4 slots (the page writes' B)


def shard_shapes(cfg, mesh, cell) -> dict:
    """The local shapes of the fused sites of ``cfg`` that a rank sees under
    ``make_cell_rules(cfg, mesh, cell)``, each from ``shard_spec`` of the
    site's operands as the model's call sites place them: x and the GLU
    weights (``_mlp_hidden_sharded``), the per-shard experts and their
    capacity (``_moe_layer_shardmap``), q and k/v in whole GQA groups
    (``_shard_attention``; ``cache_kv`` for the paged decode), and the page
    writes' whole batch (``kv_cache._sharded_rope_write``)."""
    from repro_torch.distributed import shard_fused as shf
    from repro_torch.launch.steps import make_cell_rules
    from repro_torch.models.moe import capacity

    rules = make_cell_rules(cfg, mesh, cell)
    sizes = shf.mesh_axis_sizes(rules)
    B = cell.global_batch
    S = cell.seq_len if cell.kind == "train" else 1
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def local(axes, shape):
        return shf.local_shape(rules, shf.shard_spec(rules, axes, shape), shape)

    out = {"rules": rules, "x": local(("batch", None, None), (B, S, D))}
    if cfg.n_experts:
        tp = sizes.get("model", 1)
        e_loc = cfg.n_experts // tp if cfg.n_experts % tp == 0 else cfg.n_experts
        out["experts"] = (e_loc, capacity(cfg, out["x"][0] * S), D, cfg.moe_d_ff)
    else:
        out["w"] = local((None, "mlp"), (D, cfg.d_ff))
    kv_axis = "act_kv" if cell.kind == "train" else "cache_kv"
    h, hk = shf.gqa_shard_entries(rules, "act_heads", H, kv_axis, Hkv)
    b = shf.batch_entry(rules, B)
    out["q"] = shf.local_shape(rules, shf.P(b, None, h, None), (B, S, H, dh))
    out["kv"] = shf.local_shape(rules, shf.P(b, None, hk, None), (B, S, Hkv, dh))
    out["write_heads"] = (out["q"][2], out["kv"][2])  # the writes' batch stays whole
    return out


def shard_shapes_phase(torch, card: str) -> list:
    """Every fused kernel at the local shapes of full-width repro-100m
    (``force_dp_only=False``), olmoe-1b-7b and qwen2.5-32b under
    ``make_cell_rules`` on a (data=2, model=2) mesh built as a shape only
    (no process group): an 8 x 512 training step and a paged decode of 4
    slots at 1024 keys.  The GLU forward and backward at d_ff / 2 columns,
    the MoE GLU forward and backward at 32 of 64 experts, the flash forward
    and backward at half the heads in whole GQA groups, the row softmax,
    the paged decode and both page writes at half the KV heads; each
    against its plain version at the tolerance of its own phase (bf16 1e-2;
    the backward's dzg without its slope mismatches, each checked within
    the order band, and dzu whole; the page writes bitwise), timed beside
    its bound.  Builds no model and loads no weights.  Then the production
    mesh's (16 x 16) local shapes of qwen2.5-32b, whose 40 heads do not
    divide 16: the rules take sequence-parallel attention.  Slice 21 adds
    the kernels the SSM and encoder-decoder caches' per-shard bodies
    launch on a rank's block of the decode cell (2 of its 4 slots): the
    standalone PWL kernel on mamba2-2.7b's one-step dt softplus at 40 of
    its 80 heads (bitwise), and the row softmax on whisper-small's cached
    decode at 6 of its 12 KV heads, over a 448-slot self-attention cache
    with a valid prefix and over the 1500 frames of the cross-attention.
    Returns the rows of the kernels line (no launches: one card runs no
    mesh)."""
    import torch.nn.functional as F

    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.kernels.fused import (
        fused_flash_attention,
        fused_glu,
        fused_moe_glu,
        fused_pwl_softmax,
        paged_flash_decode,
    )
    from repro_torch.kernels.fused import attention as A
    from repro_torch.kernels.fused.decoding import paged_flash_decode_plain
    from repro_torch.kernels.fused.glu import fused_glu_bwd, fused_glu_bwd_plain, fused_glu_plain
    from repro_torch.kernels.fused.softmax import fused_pwl_softmax_plain, static_mask
    from repro_torch.launch.steps import make_cell_rules
    from repro_torch.models import ShapeCell

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    mesh = AbstractMesh(*SHARD_MESH)
    train = ShapeCell("train 8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    decode = ShapeCell("paged decode", 1024, SHARD_DECODE_SLOTS, "decode")
    exp_table, exp_plan, exp_tables = _exp_table(torch)
    rows = []

    def row(name, src, rep, shape, err, k_ms, p_ms, l_ms, bound):
        rows.append({"name": f"{name}[2x2 shard: {shape}]", "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}", "replaces": rep,
                     "shape": f"{shape}, a rank's block on the (data=2, model=2) mesh (on no "
                              "path of one card)",
                     "launches": 0, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, **bound})
        print(f"[smoke] shard {name} {shape}: max_abs_err {err:.3g}, kernel {k_ms * 1e3:.2f} us, "
              f"plain {p_ms * 1e3:.2f} us, library "
              + ("-" if l_ms is None else f"{l_ms * 1e3:.2f} us")
              + f", bound {bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}); {card}")

    def glu(arch, act, M, K, N, bwd):
        table, plan, tables = _table(torch, act)
        s = 1.0 / math.sqrt(K)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        wg = (torch.randn(K, N, generator=gen, device=dev) * s).to(torch.bfloat16)
        wu = (torch.randn(K, N, generator=gen, device=dev) * s).to(torch.bfloat16)
        shape = f"{arch} M={M} K={K} N={N} bf16"
        n0 = fused_glu.launches
        got = fused_glu(x, wg, wu, table=table)
        check(fused_glu.launches == n0 + 1, f"shard GLU {shape}: not launched")
        err = _compare(torch, got, fused_glu_plain(x, wg, wu, plan, tables), 1e-2,
                       f"shard GLU {shape}")
        wcat = torch.cat([wg, wu], dim=1)
        row("fused_glu", "glu.cu", "src/repro/kernels/fused/glu.py:30", shape, err,
            time_ms(torch, lambda i: fused_glu(x, wg, wu, table=table), reps=5, iters=4),
            time_ms(torch, lambda i: fused_glu_plain(x, wg, wu, plan, tables), reps=2, iters=2),
            time_ms(torch, lambda i: torch.matmul(x, wcat), reps=5, iters=4),
            _bound((M * K + 2 * K * N + M * N) * 2, 4.0 * M * K * N))
        if not bwd:
            return
        g = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
        dzg, dzu = fused_glu_bwd(x, wg, wu, g, plan, tables)
        wdzg, wdzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
        # past K = 2048 the band holds more than MAX_BAND_SHARE (qwen2.5-32b's
        # shard, K = 5120), so its share is not bounded there, as in
        # arch_glu_phase; dzu = g·act(zg) has no slope jump and is held whole
        marked, near, allow, band = _order_band(
            torch, x, (wg, wu), None, g, dzg, plan, tables, f"shard GLU backward {shape}",
            max_band=MAX_BAND_SHARE if K <= MOE_K else None, parts=True)
        err = max(_compare_flips(torch, dzg, wdzg, marked, near, allow, 1e-2,
                                 f"shard GLU dzg {shape}"),
                  _compare_scaled(torch, dzu, wdzu, 1e-2, f"shard GLU dzu {shape}"))
        del wdzg, wdzu, marked, near, allow
        print(f"[smoke] shard fused_glu_bwd {shape}: order band {band}")
        row("fused_glu_bwd", "glu.cu", "src/repro/kernels/fused/glu.py:97", shape, err,
            time_ms(torch, lambda i: fused_glu_bwd(x, wg, wu, g, plan, tables), reps=5, iters=4),
            time_ms(torch, lambda i: fused_glu_bwd_plain(x, wg, wu, g, plan, tables),
                    reps=2, iters=2),
            time_ms(torch, lambda i: torch.matmul(x, wcat), reps=5, iters=4),
            _bound((M * K + 2 * K * N + M * N) * 2 + 2 * M * N * 4, 4.0 * M * K * N))

    def moe(E, C, K, N, bwd):
        table, plan, tables = _table(torch, "silu")
        s = 1.0 / math.sqrt(K)
        x = torch.randn(E, C, K, generator=gen, device=dev).to(torch.bfloat16)
        wg = (torch.randn(E, K, N, generator=gen, device=dev) * s).to(torch.bfloat16)
        wu = (torch.randn(E, K, N, generator=gen, device=dev) * s).to(torch.bfloat16)
        shape = f"olmoe-1b-7b E={E} of {MOE_E} C={C} K={K} N={N} bf16"
        n0 = fused_moe_glu.launches
        got = fused_moe_glu(x, wg, wu, table=table)
        check(fused_moe_glu.launches == n0 + 1, f"shard MoE GLU {shape}: not launched")
        err = _compare_scaled(torch, got, fused_glu_plain(x, wg, wu, plan, tables), 1e-2,
                              f"shard MoE GLU {shape}")
        wcat = torch.cat([wg, wu], dim=2)
        row("fused_moe_glu", "glu.cu", "src/repro/kernels/fused/moe.py:41", shape, err,
            time_ms(torch, lambda i: fused_moe_glu(x, wg, wu, table=table), reps=5, iters=4),
            time_ms(torch, lambda i: fused_glu_plain(x, wg, wu, plan, tables), reps=2, iters=2),
            time_ms(torch, lambda i: torch.bmm(x, wcat), reps=5, iters=4),
            _bound(_moe_bytes(E, C, K, N, 2), 4.0 * E * C * K * N))
        if not bwd:
            return
        g = torch.randn(E, C, N, generator=gen, device=dev).to(torch.bfloat16)

        def kbwd(i):
            return fused_glu_bwd(x, wg, wu, g, plan, tables, counter=fused_moe_glu)

        dzg, dzu = kbwd(0)
        wdzg, wdzu = fused_glu_bwd_plain(x, wg, wu, g, plan, tables)
        marked, near, allow, band = _order_band(torch, x, (wg, wu), None, g, dzg, plan, tables,
                                                f"shard MoE GLU backward {shape}", parts=True)
        err = max(_compare_flips(torch, dzg, wdzg, marked, near, allow, 1e-2,
                                 f"shard MoE dzg {shape}"),
                  _compare_scaled(torch, dzu, wdzu, 1e-2, f"shard MoE dzu {shape}"))
        del wdzg, wdzu, marked, near, allow
        print(f"[smoke] shard fused_moe_glu_bwd {shape}: {band}")
        row("fused_moe_glu_bwd", "glu.cu", "src/repro/kernels/fused/moe.py:107", shape, err,
            time_ms(torch, kbwd, reps=5, iters=4),
            time_ms(torch, lambda i: fused_glu_bwd_plain(x, wg, wu, g, plan, tables),
                    reps=2, iters=2),
            time_ms(torch, lambda i: torch.bmm(x, wcat), reps=5, iters=4),
            _bound(_moe_bytes(E, C, K, N, 2, f32_outputs=2), 4.0 * E * C * K * N))

    def flash(arch, B, S, H, hkv, dh):
        shape = f"{arch} B={B} S=T={S} causal H={H} Hkv={hkv} dh={dh} bf16"
        q = _igrid(torch, gen, (B, S, H, dh), torch.bfloat16)
        k = _igrid(torch, gen, (B, S, hkv, dh), torch.bfloat16)
        v = _igrid(torch, gen, (B, S, hkv, dh), torch.bfloat16)
        dout = _igrid(torch, gen, (B, S, H, dh), torch.bfloat16)
        kw = {"causal": True, "window": None, "q_offset": 0, "kv_valid_len": None}
        n0 = fused_flash_attention.launches
        got = fused_flash_attention(q, k, v, table=exp_table, causal=True)
        check(fused_flash_attention.launches == n0 + 1, f"shard flash {shape}: not launched")
        want, _ = A.fused_flash_attention_plain(q, k, v, exp_plan, exp_tables, **kw)
        err = _compare(torch, got, want, 1e-2, f"shard flash {shape}")
        qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        rep = hkv != H
        sdpa = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=rep), reps=5, iters=4)
        pairs = B * H * S * (S + 1) / 2
        nbytes = (2 * q.numel() + 2 * k.numel()) * 2
        row("fused_flash_attention", "attention.cu", "src/repro/kernels/fused/attention.py:100",
            shape, err,
            time_ms(torch, lambda i: fused_flash_attention(q, k, v, table=exp_table,
                                                           causal=True), reps=5, iters=4),
            time_ms(torch, lambda i: A.fused_flash_attention_plain(
                q, k, v, exp_plan, exp_tables, **kw), reps=2, iters=2),
            sdpa, _bound(nbytes, 4.0 * pairs * dh))
        _, m = A._launch(q, k, v, exp_plan, exp_tables, True, None, 0, None, True)
        b0 = fused_flash_attention.bwd_launches
        grads = A.fused_flash_attention_bwd(q, k, v, dout, m, exp_plan, exp_tables, **kw)
        check(fused_flash_attention.bwd_launches == b0 + 1, f"shard flash bwd {shape}: not "
                                                           "launched")
        wants = A.fused_flash_attention_bwd_plain(q, k, v, dout, m, exp_plan, exp_tables, **kw)
        err = max(_compare_scaled(torch, g_, w_, 1e-2, f"shard flash bwd {shape} d{n}")
                  for n, g_, w_ in zip("qkv", grads, wants))
        del grads, wants
        row("fused_flash_attention_bwd", "attention_bwd.cu",
            "src/repro/kernels/fused/attention.py:334/396/445/498", shape, err,
            time_ms(torch, lambda i: A.fused_flash_attention_bwd(
                q, k, v, dout, m, exp_plan, exp_tables, **kw), reps=5, iters=4),
            time_ms(torch, lambda i: A.fused_flash_attention_bwd_plain(
                q, k, v, dout, m, exp_plan, exp_tables, **kw), reps=2, iters=2),
            None, _bound(nbytes * 2, 10.0 * pairs * dh))

    def softmax(arch, B, hkv, S):
        shape = f"{arch} {B}x{hkv}x{S} rows x {S} causal f32"
        x = torch.randn((B, 1, hkv, S, S), generator=gen, device=dev) * 3.0
        x2 = x.reshape(-1, S)
        mask2 = static_mask(x2.shape[0], S, S, True, None, device=dev)
        n0 = fused_pwl_softmax.launches
        got = fused_pwl_softmax(x, table=exp_table, causal=True)
        check(fused_pwl_softmax.launches == n0 + 1, f"shard softmax {shape}: not launched")
        want = fused_pwl_softmax_plain(x2, mask2, exp_plan, exp_tables).reshape(x.shape)
        live = mask2 > 0
        err = _compare_probs(torch, got, want, live, 1e-5, f"shard softmax {shape}")
        n_live = int(live.sum())
        row("fused_pwl_softmax", "softmax.cu", "src/repro/kernels/fused/softmax.py:69", shape,
            err, time_ms(torch, lambda i: fused_pwl_softmax(x, table=exp_table, causal=True)),
            time_ms(torch, lambda i: fused_pwl_softmax_plain(x2, mask2, exp_plan, exp_tables),
                    reps=5, iters=4),
            time_ms(torch, lambda i: torch.softmax(x, dim=-1)),
            _bound(_softmax_bytes(x.numel(), n_live, 1, False), 0.0))

    def paged(arch, B, H, hkv, dh, context):
        # a rank's block of the decode cell: its B slots at the cell's
        # context (the last page partial), held and timed; then the same
        # block with its last slot inactive, held (its rows exact zeros)
        shape = f"{arch} B={B} kv_len ~{context} H={H} Hkv={hkv} dh={dh} ps={PS} bf16 pools"
        n_cols = -(-context // PS)
        P = B * n_cols + 1
        rows_ = _fragmented_table(B, n_cols, P)
        tab = torch.zeros((B, n_cols), dtype=torch.int32)
        for i, r in enumerate(rows_):
            tab[i, :len(r)] = torch.tensor(r)
        tab = tab.to(dev)
        q = torch.randn(B, 1, H, dh, generator=gen, device=dev).to(torch.bfloat16)
        kp = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(torch.bfloat16)
        vp = torch.randn(hkv, P, PS, dh, generator=gen, device=dev).to(torch.bfloat16)
        live = [context - 13 * i for i in range(B)]
        eff = min(2048 // PS, n_cols)
        err = 0.0
        for kv_len in (live, live[:-1] + [0]):
            lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            n0 = paged_flash_decode.launches
            got = paged_flash_decode(q, kp, vp, tab, lens, table=exp_table)
            check(paged_flash_decode.launches == n0 + 1, f"shard decode {shape}: not launched")
            want = paged_flash_decode_plain(q, kp, vp, tab, lens, exp_plan, exp_tables, eff)
            err = max(err, _compare(torch, got, want, 1e-2, f"shard decode {shape} {kv_len}"))
            check(not bool(got[lens == 0].any()), f"shard decode {shape}: kv_len 0 not zeros")
        lens = torch.tensor(live, dtype=torch.int32, device=dev)
        live_pages = sum(-(-n // PS) for n in live)
        nbytes = 2 * live_pages * PS * dh * hkv * 2 + 2 * q.numel() * 2 + tab.numel() * 4 + B * 4
        row("paged_flash_decode", "decoding.cu", "src/repro/kernels/fused/decoding.py:72",
            shape, err,
            time_ms(torch, lambda i: paged_flash_decode(q, kp, vp, tab, lens, table=exp_table)),
            time_ms(torch, lambda i: paged_flash_decode_plain(
                q, kp, vp, tab, lens, exp_plan, exp_tables, eff), reps=3, iters=3),
            _decode_sdpa_ms(torch, q, kp, vp, tab, lens),
            _bound(nbytes, 4.0 * int(lens.sum()) * H * dh))

    from repro_torch.configs import get_config

    for arch in SHARD_ARCHS:
        # repro-100m's default (force_dp_only None) drops tensor parallelism
        cfg = get_config(arch, force_dp_only=False if arch == "repro-100m" else None)
        tr, de = shard_shapes(cfg, mesh, train), shard_shapes(cfg, mesh, decode)
        print(f"[smoke] shard {arch} {SHARD_MESH[0]} train 8x512 local: x {tr['x']}, "
              + (f"experts {tr['experts']}" if cfg.n_experts else f"w {tr['w']}")
              + f", q {tr['q']}, kv {tr['kv']}; paged decode local: q {de['q']}, pools' heads "
              f"{de['kv'][2]}, writes' heads {de['write_heads']}; {card}")
        M = tr["x"][0] * tr["x"][1]
        if cfg.n_experts:
            E, C, K, N = tr["experts"]
            check(E == MOE_E // 2, f"shard {arch}: {E} local experts, want {MOE_E // 2}")
            moe(E, C, K, N, bwd=True)
            moe(*de["experts"], bwd=False)
        else:
            check(tr["w"][1] == cfg.d_ff // 2, f"shard {arch}: GLU columns {tr['w']}")
            glu(arch, cfg.activation, M, cfg.d_model, tr["w"][1], bwd=True)
            glu(arch, cfg.activation, de["x"][0], cfg.d_model, de["w"][1], bwd=False)
        B, S, H, dh = tr["q"]
        hkv = tr["kv"][2]
        check(H == cfg.n_heads // 2 and hkv == cfg.n_kv_heads // 2,
              f"shard {arch}: heads {H} / {hkv}")
        if arch == "repro-100m":  # its 8 x 512 step takes the row softmax
            softmax(arch, B, hkv, S)
        else:
            flash(arch, B, S, H, hkv, dh)
        Bd, _, Hd, _ = de["q"]
        paged(arch, Bd, Hd, de["kv"][2], dh, decode.seq_len)
        for Bw, Sw in ((SHARD_DECODE_SLOTS, 1), (1, 32)):
            r = _rope_case(torch, arch, Bw, Sw, H=de["write_heads"][0], hkv=de["write_heads"][1])
            name = "rope_append_kv_" if Sw == 1 else "rope_write_prompt_pages_"
            rows.append({"name": f"{name}[2x2 shard: {arch} {r['shape']}]", "route": "cuda",
                         "source": "src/repro_torch/csrc/kv_cache.cu",
                         "replaces": "src/repro/serving/kv_cache.py:"
                                     + ("212" if Sw == 1 else "129"),
                         **r, "shape": f"{arch} {r['shape']}, a rank's heads on the (data=2, "
                                       "model=2) mesh, the whole batch (on no path of one card)",
                         "launches": 0})
    # slice 21: the SSM and encoder-decoder caches' per-shard bodies at a
    # rank's block of the paged decode cell's slots
    from repro_torch import sfu
    from repro_torch.distributed import shard_fused as shf
    from repro_torch.kernels import ops, pwl_act
    from repro_torch.kernels.fused.epilogue import pack_table
    from repro_torch.models import encdec, ssm

    mamba = get_config(MAMBA)
    rules = make_cell_rules(mamba, mesh, decode)
    state = shf.local_shape(rules, ssm.cache_spec(rules, mamba, decode.global_batch)["ssm"],
                            (decode.global_batch, MAMBA_H, mamba.ssm_head_dim, mamba.ssm_state))
    check(state[:2] == (SHARD_DECODE_SLOTS // 2, MAMBA_H // 2),
          f"shard {MAMBA}: the decode's local state {state}")
    # the one-step body's dt softplus on the standalone kernel (the table of
    # mamba2_plan(..., softplus_kernel=True)): f32 (rows, 1, heads) of the rank
    sp = sfu.get_store().get(sfu.compile_plan(get_config(MAMBA, act_impl="fused")).spec(
        "ssm:softplus"))
    sp_ops = tuple(a.to(dev) for a in pack_table(sp))
    x = torch.randn((state[0], 1, state[1]), generator=gen, device=dev) * 2.0
    shape = f"{MAMBA} decode dt {state[0]} x 1 x {state[1]} f32, softplus"
    n0 = ops.pwl_activation.launches
    got = ops.pwl_activation(x, sp)
    check(ops.pwl_activation.launches == n0 + 1, f"shard pwl_activation {shape}: not launched")
    _bitwise(torch, got, pwl_act.pwl_nonuniform_plain(x, *sp_ops), f"shard pwl {shape}")
    row("pwl_activation", "pwl_act.cu", "src/repro/kernels/pwl_act.py:40", shape, 0.0,
        time_ms(torch, lambda i: ops.pwl_activation(x, sp)),
        time_ms(torch, lambda i: pwl_act.pwl_nonuniform_plain(x, *sp_ops)), None,
        _elementwise_bound(x.numel(), x.element_size(), SEARCH_OPS + 2))

    whisper = get_config("whisper-small")
    rules = make_cell_rules(whisper, mesh, decode)
    kv = shf.local_shape(rules, encdec.cache_specs(rules, whisper, decode.global_batch)["xk"],
                         (whisper.n_layers, decode.global_batch, WHISPER_FRAMES,
                          whisper.n_kv_heads, whisper.resolved_head_dim))
    Bl, hl = kv[1], kv[3]
    check((Bl, hl) == (SHARD_DECODE_SLOTS // 2, whisper.n_kv_heads // 2),
          f"shard whisper-small: the decode's local cross K/V {kv}")
    # the dense-cache body's decode over the self-attention cache (a valid
    # prefix), then the cross-attention over the 1500 frames, both on the
    # row softmax kernel
    for what, x, mask in (
            ("self", torch.randn((Bl, hl, 1, WHISPER_TRAIN_SEQ), generator=gen, device=dev) * 3,
             (torch.arange(WHISPER_TRAIN_SEQ, device=dev) <= WHISPER_SELF_POS)[None, None,
                                                                             None, :]),
            ("cross", torch.randn((Bl, 1, hl, 1, WHISPER_FRAMES), generator=gen, device=dev) * 3,
             None)):
        N = x.shape[-1]
        shape = f"whisper-small {what}-attention decode {Bl}x{hl} rows x {N} f32"
        x2 = x.reshape(-1, N)
        mask2 = (None if mask is None else
                 torch.broadcast_to(mask.to(torch.float32), x.shape).reshape(-1, N))
        n0 = fused_pwl_softmax.launches
        got = fused_pwl_softmax(x, table=exp_table, mask=mask)
        check(fused_pwl_softmax.launches == n0 + 1, f"shard softmax {shape}: not launched")
        want = fused_pwl_softmax_plain(x2, mask2, exp_plan, exp_tables).reshape(x.shape)
        live = torch.ones_like(x2, dtype=torch.bool) if mask2 is None else mask2 > 0
        err = _compare_probs(torch, got, want, live, 1e-5, f"shard softmax {shape}")
        row("fused_pwl_softmax", "softmax.cu", "src/repro/kernels/fused/softmax.py:69", shape,
            err, time_ms(torch, lambda i: fused_pwl_softmax(x, table=exp_table, mask=mask)),
            time_ms(torch, lambda i: fused_pwl_softmax_plain(x2, mask2, exp_plan, exp_tables),
                    reps=5, iters=4),
            time_ms(torch, lambda i: torch.softmax(x, dim=-1)),
            _bound(_softmax_bytes(x.numel(), int(live.sum()), 1, mask is not None), 0.0))

    # the production mesh: qwen2.5-32b's 40 heads do not divide 16
    from repro_torch.models import SHAPE_CELLS

    qwen = get_config("qwen2.5-32b")
    prod = AbstractMesh((16, 16), ("data", "model"))
    for name in ("train_4k", "decode_32k"):
        sh = shard_shapes(qwen, prod, SHAPE_CELLS[name])
        t = sh["rules"].table
        check(t["act_heads"] is None and t["cache_seq"] == "model" and t["mlp"] == "model",
              f"qwen2.5-32b on 16 x 16 {name}: rules {t}")
        print(f"[smoke] shard qwen2.5-32b (16, 16) {name} local: x {sh['x']}, w {sh['w']}, "
              f"q {sh['q']}, kv {sh['kv']} (sequence-parallel attention: heads whole, "
              f"cache_seq over model)")
    print(f"[smoke] shard_shapes_phase {time.perf_counter() - t0:.1f}s; {card}")
    return rows


# the full-width dry-run rows' collectives by kind that tests/test_torch_dryrun.py
# pins on the CPU (its FULL_WIDTH_PINS)
DRYRUN_PINS = {
    "repro-100m__decode_32k__multi": {"all-gather": 89, "all-reduce": 13},
}
DRYRUN_RUNS = (  # the dry run's arguments, one process each, all started together
    ("--arch", "repro-100m"),
    ("--arch", MAMBA, "--shape", "decode_32k", "--singlepod-only"),
    ("--arch", MAMBA, "--shape", "long_500k", "--singlepod-only"),
    ("--arch", "whisper-small", "--shape", "decode_32k", "--singlepod-only"),
    ("--arch", "jamba-v0.1-52b", "--shape", "decode_32k", "--singlepod-only"),
    ("--arch", "qwen2.5-32b", "--shape", "train_4k", "--multipod-only"),
)
DRYRUN_TIMEOUT_S = 900
DRYRUN_SKIP = "SKIP (full attention at 500k — DESIGN.md Sec. 5)"


_DRYRUN: dict = {}  # the running dry run: its processes, rows' folder, start time


def dryrun_start() -> dict:
    """Start ``python -m repro_torch.launch.dryrun`` on this machine's torch,
    each run of ``DRYRUN_RUNS`` in a subprocess of its own (the fake
    512-rank process group never enters this process;
    ``CUDA_VISIBLE_DEVICES`` empty: everything is on the meta device), at
    the lowest CPU priority (``nice`` 19), so that they run beside the
    kernel phases, which use one core of the host, and take no wall time of
    their own.  :func:`dryrun_phase` collects them; :func:`dryrun_stop`
    ends any still running."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_"))
    procs = []
    for i, args in enumerate(DRYRUN_RUNS):  # each log to a file: no pipe fills unread
        with open(out / f"run{i}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(out)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(19)))
    _DRYRUN.update(procs=procs, out=out, t0=time.time())
    return _DRYRUN


def dryrun_stop() -> None:
    """Kill the dry-run processes still running and remove their rows."""
    for p in _DRYRUN.pop("procs", []):
        if p.poll() is None:
            p.kill()
        p.wait()
    if "out" in _DRYRUN:
        shutil.rmtree(_DRYRUN["out"], ignore_errors=True)
    _DRYRUN.clear()


def dryrun_phase(card: str, started: dict) -> dict:
    """Wait for the runs :func:`dryrun_start` started: repro-100m's four
    shapes on both meshes (``long_500k`` JAX's SKIP row), mamba2-2.7b
    ``decode_32k`` and ``long_500k``, whisper-small ``decode_32k``,
    full-width jamba-v0.1-52b ``decode_32k`` on 16 x 16 and qwen2.5-32b
    ``train_4k`` on 2 x 16 x 16.  Each row reads ``ok`` or the SKIP row,
    the pinned cells' collectives equal ``DRYRUN_PINS``, and ``python -m
    repro_torch.roofline.report`` renders the rows (printed).  Returns the
    rows by tag, the seconds from the start to the last row and the seconds
    this call waited."""
    t_wait = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = started["out"]
    try:
        logs = []
        for i, (args, p) in enumerate(zip(DRYRUN_RUNS, started["procs"])):
            p.wait(timeout=DRYRUN_TIMEOUT_S)
            logs.append((out / f"run{i}.log").read_text())
            check(p.returncode == 0, f"dryrun {' '.join(args)}: rc {p.returncode}\n"
                  + logs[-1][-3000:])
        waited = time.perf_counter() - t_wait
        for log in logs:
            for line in log.splitlines():
                if line.startswith(("[ok]", "[skip]", "[FAIL]", "done:")):
                    print(f"[smoke] dryrun {line}")
        rows = {p.stem: json.loads(p.read_text()) for p in sorted(out.glob("*.json"))}
        seconds = max(p.stat().st_mtime for p in out.glob("*.json")) - started["t0"]
        check(len(rows) == 13, f"dryrun: {len(rows)} rows, want 13: {sorted(rows)}")
        for tag, r in rows.items():
            want_skip = r["shape"] == "long_500k" and r["arch"] == "repro-100m"
            check(r["status"] == (DRYRUN_SKIP if want_skip else "ok"),
                  f"dryrun {tag}: status {r['status']!r}")
            if tag in DRYRUN_PINS:
                check(r["collective_counts"] == DRYRUN_PINS[tag],
                      f"dryrun {tag}: collectives {r['collective_counts']}, pinned "
                      f"{DRYRUN_PINS[tag]}")
        check(rows["qwen2.5-32b__train_4k__multi"]["chips"] == 512, "dryrun: qwen's mesh")
        rep = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report", "--dir",
                              str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        check(rep.returncode == 0 and "### Roofline (single-pod)" in rep.stdout,
              f"report: rc {rep.returncode}\n{rep.stderr[-2000:]}")
        print(rep.stdout)
    finally:
        dryrun_stop()
    print(f"[smoke] dryrun_phase {seconds:.1f}s from its start to its last row, "
          f"{waited:.1f}s waited for ({len(rows)} rows; {card})")
    return {"rows": rows, "seconds": seconds, "waited": waited}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(f"[smoke] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    def mark(phase: str) -> None:
        print(f"[smoke] -- {phase} done at {time.perf_counter() - t_start:.1f}s")

    try:
        build_s = build_phase()
        dry_started = dryrun_start()  # runs beside the kernel phases below
        glu = glu_phase(torch)
        moe = moe_phase(torch)
        glu_decode_phase(torch)
        moe_skip = moe_skip_phase(torch)
        kv = kv_phase(torch)
        sm = softmax_phase(torch)
        dec = decode_phase(torch)
        fl = flash_phase(torch)
        pwl = pwl_act_phase(torch)
        lin = linear_phase(torch)
        bf16_table_phase(torch)
        wide = wide_table_phase(torch)
        mark("forward kernel phases")
        glu_bwd = glu_bwd_phase(torch)
        moe_bwd = moe_bwd_phase(torch)
        sm_bwd = softmax_bwd_phase(torch)
        fl_bwd = flash_bwd_phase(torch)
        lin_bwd = linear_bwd_phase(torch)
        mark("backward kernel phases")
        nrm = norm_phase(torch)
        norm_counts = norm_path(torch)
        exact = exact_epilogue_phase(torch)
        exact_counts = exact_path(torch)
        d256 = dh256_phase(torch)
        d256_counts = dh256_path(torch)
        mark("slice 7 phases (RMSNorm, exact and identity epilogues, head dim 256)")
        arch_glu = arch_glu_phase(torch)
        arch_kv = arch_kv_phase(torch)
        mark("slice 15 kernel phases (the new architectures' shapes)")
        shard_rows = shard_shapes_phase(torch, card)
        mark("slice 20 shard_shapes_phase (every fused kernel at a 2 x 2 mesh rank's shapes)")
        dry = dryrun_phase(card, dry_started)
        mark(f"slice 21 dryrun_phase ({dry['seconds']:.1f}s, {dry['waited']:.1f}s waited for)")
        main_counts = serve_phase(torch, [], no_attention_kernels)
        serve_phase(torch, ["--batch", "8", "--prompt-len", "256", "--max-new", "32"],
                    no_attention_kernels)
        with tempfile.TemporaryDirectory() as tmp:
            plan = dump_plan(pathlib.Path(tmp) / "fused_softmax_plan.json")
            short = serve_phase(torch, ["--plan", plan], short_prompt_attention)
            long = serve_phase(torch, ["--plan", plan, "--batch", "2", "--prompt-len", "4096",
                                       "--max-new", "8"], long_prompt_attention)
            serve_phase(torch, ["--plan", plan, "--mode", "dense"], dense_loop_attention)
            kernel_plan = dump_plan(pathlib.Path(tmp) / "kernel_plan.json", pwl_softmax=False,
                                    act_impl="kernel")
            kernel_counts = serve_phase(torch, ["--plan", kernel_plan], no_attention_kernels,
                                        ffn="pwl_activation")
            bf16_plan = dump_plan(pathlib.Path(tmp) / "bf16_table_plan.json", table_dtype="bf16")
            serve_phase(torch, ["--plan", bf16_plan], short_prompt_attention)
            mark("repro-100m serve phases")
            fitted = fit_phase(torch, pathlib.Path(tmp), main_counts)
            mark("slice 17 fitting phase (fits on the card, fit-on-miss, uniform tables)")
            t18 = time.perf_counter()
            wide_counts = wide_serve_phase(torch, pathlib.Path(tmp))
            guard = guard_phase(torch)
            mark(f"slice 18 phases (the 129-segment session, guard and faults; "
                 f"{time.perf_counter() - t18:.1f}s)")
            olmoe = ["--arch", "olmoe-1b-7b"]
            with _bucket_census(torch) as census:
                moe_counts = serve_phase(torch, olmoe, no_attention_kernels)
            check(census["calls"] > 0, "the olmoe session made no MoE GLU call at C = 1")
            live_mean = float(census["live"]) / census["calls"]
            print(f"[smoke] olmoe default session: {live_mean:.2f} of {MOE_E} buckets "
                  f"non-empty on average over its {census['calls']} MoE GLU calls at C = 1 "
                  f"(its decode steps)")
            serve_phase(torch, olmoe + ["--batch", "8", "--prompt-len", "256", "--max-new", "32"],
                        no_attention_kernels)
            moe_softmax_plan = dump_plan(pathlib.Path(tmp) / "olmoe_fused_softmax_plan.json",
                                         "olmoe-1b-7b")
            serve_phase(torch, olmoe + ["--plan", moe_softmax_plan], short_prompt_attention)
            mark("olmoe-1b-7b serve phases")
            qwen_init = qwen_init_phase(torch)
            gemma_plan = dump_plan(pathlib.Path(tmp) / "gemma_fused_softmax_plan.json",
                                   "gemma3-1b")
            arch = arch_serve_phases(torch, pathlib.Path(tmp), gemma_plan)
            vision_counts = internvl_vision_phase(torch)
            mark("slice 15 serve phases (olmo, stablelm, qwen, gemma3, internvl)")
            trained = train_phase(torch, plan, str(pathlib.Path(tmp) / "ckpt"))
            mark("train phase")
            long_trained = long_train_phase(torch, plan, str(pathlib.Path(tmp) / "ckpt_long"))
            mark("long-context train phase")
            grad_phase(torch, plan)
            mark("grad phase")
            moe_plan = dump_plan(pathlib.Path(tmp) / "olmoe_fused_plan.json", "olmoe-1b-7b",
                                 pwl_softmax=False)
            moe_trained = moe_train_phase(torch, moe_plan)
            moe_grad_phase(torch)
            moe_reference_phase(torch, moe_plan)
            mark("MoE train and grad phases")
            whisper_plan = dump_plan(pathlib.Path(tmp) / "whisper_plan.json", "whisper-small")
            whisper_counts = whisper_serve_phase(torch, whisper_plan)
            whisper_trained = whisper_train_phase(torch, whisper_plan)
            whisper_grad_phase(torch, whisper_plan)
            whisper_reference_phase(torch, whisper_plan)
            mark("whisper-small phases")
            olmo_trained = olmo_train_phase(torch, pathlib.Path(tmp))
            gemma_trained = gemma_train_phase(torch, gemma_plan)
            mark("slice 15 train phases (olmo-1b 8 x 512 with a resume, gemma3-1b 1 x 4096)")
            mamba_serve = mamba2_serve_phases(torch, pathlib.Path(tmp))
            mamba_trained = mamba2_train_phase(torch, pathlib.Path(tmp))
            mark("slice 16 phases (mamba2-2.7b serve, and train 8 x 512 with a resume)")
            _release(torch)
            autotuned = autotune_phase(torch, pathlib.Path(tmp), card.rsplit(",", 1)[1].strip())
            mark("slice 19 autotune phase (repro-100m full sweep and warm rerun, olmoe-1b-7b "
                 "and mamba2-2.7b quick, serve --plan)")
            arch_reference_phase(torch)
            ssm_ref = ssm_reference_phase(torch)
        reference_phase(torch)
        # the launches of each kernel on the path that runs it
        path_counts = {name: main_counts[name]
                       for name in ("fused_glu", "rope_write_prompt_pages_", "rope_append_kv_")}
        path_counts["fused_moe_glu"] = moe_counts["fused_moe_glu"]
        path_counts["fused_moe_glu_bwd"] = moe_trained["fused_moe_glu_bwd"]
        path_counts["fused_pwl_softmax"] = short["fused_pwl_softmax"]
        path_counts["paged_flash_decode"] = short["paged_flash_decode"]
        path_counts["fused_flash_attention"] = long["fused_flash_attention"]
        path_counts["fused_glu_bwd"] = trained["counts"]["fused_glu_bwd"]
        path_counts["fused_pwl_softmax_bwd"] = trained["counts"]["fused_pwl_softmax_bwd"]
        path_counts["fused_flash_attention_bwd"] = \
            long_trained["counts"]["fused_flash_attention_bwd"]
        path_counts["pwl_activation"] = kernel_counts["pwl_activation"]
        path_counts["fused_linear"] = whisper_counts["fused_linear"]
        path_counts["fused_linear_bwd"] = whisper_trained["counts"]["fused_linear_bwd"]
        for name in ("fused_rmsnorm", "fused_rmsnorm_bwd"):
            path_counts[name] = norm_counts[K_DIM][name]
        for name, n in exact_counts.items():
            if n:
                path_counts[f"{name} exact"] = n
        for name, n in d256_counts.items():
            if n:
                path_counts[f"{name} dh256"] = n
        for a in NEW_ARCHS:
            path_counts[f"fused_glu {a}"] = arch[a]["fused_glu"]
        for a in ("olmo-1b", "stablelm-1.6b", "qwen2.5-32b", "internvl2-1b"):
            path_counts[f"rope_write_prompt_pages_ {a}"] = arch[a]["rope_write_prompt_pages_"]
            path_counts[f"rope_append_kv_ {a}"] = arch[a]["rope_append_kv_"]
        for a in ("qwen2.5-32b", "internvl2-1b"):
            path_counts[f"paged_flash_decode {a}"] = arch[f"{a} softmax"]["paged_flash_decode"]
        path_counts["fused_glu internvl2-1b vision"] = vision_counts["fused_glu"]
        for name in ("fused_glu", "fused_glu_bwd", "fused_pwl_softmax", "fused_pwl_softmax_bwd"):
            path_counts[f"{name} olmo-1b train"] = olmo_trained["counts"][name]
        for name in ("fused_glu", "fused_glu_bwd", "fused_pwl_softmax", "fused_pwl_softmax_bwd",
                     "fused_flash_attention", "fused_flash_attention_bwd"):
            path_counts[f"{name} gemma3-1b train"] = gemma_trained["counts"][name]
        dense2048 = arch["gemma3-1b dense 2048"]
        for name in ("fused_pwl_softmax", "fused_flash_attention"):
            path_counts[f"{name} gemma3-1b dense 2048"] = dense2048[name]
        path_counts["pwl_activation mamba2-2.7b"] = mamba_serve["kernel"]["pwl_activation"]
        for name in ("fused_glu", "fused_moe_glu", "fused_pwl_softmax"):
            path_counts[f"{name} reduced jamba"] = ssm_ref["jamba-v0.1-52b"][name]
        for tag in ("uniform", "fallback"):
            path_counts[f"fused_glu {tag} table"] = fitted[f"serve {tag}"]["fused_glu"]
        for name in ("fused_glu", "fused_pwl_softmax", "paged_flash_decode"):
            path_counts[f"{name} 128 breakpoints"] = wide_counts[name]
        for name, n in path_counts.items():
            check(n > 0, f"{name} never launched on its serving or training path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        dryrun_stop()

    g = glu[(4, torch.bfloat16)]
    kernels = [
        {"name": "fused_glu", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/glu.py:30",
         "shape": f"M=4 K={K_DIM} N={N_DIM} bf16 (decode step)",
         "launches": path_counts["fused_glu"], **g},
        {"name": "fused_moe_glu", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/moe.py:41",
         "shape": f"E={MOE_E} C=1 K={MOE_K} N={MOE_N} bf16 (olmoe-1b-7b decode step), every "
                  "bucket full",
         "launches": path_counts["fused_moe_glu"], **moe[1]},
        {"name": "fused_moe_glu[decode occupancy]", "route": "cuda",
         "source": "src/repro_torch/csrc/glu.cu", "replaces": "src/repro/kernels/fused/moe.py:41",
         "shape": f"E={MOE_E} C=1 K={MOE_K} N={MOE_N} bf16, every other bucket empty (the "
                  f"olmoe default session's decode calls: {live_mean:.2f} of {MOE_E} non-empty "
                  f"on average); launches: that session's MoE GLU calls at C = 1",
         "launches": census["calls"], **next(iter(moe_skip.values()))},
        *({"name": f"rope_write_prompt_pages_{tag}", "route": "cuda",
           "source": "src/repro_torch/csrc/kv_cache.cu",
           "replaces": "src/repro/serving/kv_cache.py:129",
           "launches": n, **kv[f"rope_write_prompt_pages_{tag}"],
           "shape": kv[f"rope_write_prompt_pages_{tag}"]["shape"] + note}
          for tag, n, note in (
              ("", path_counts["rope_write_prompt_pages_"],
               " (prefill; rotates q and k, writes K/V)"),
              ("[olmoe]", moe_counts["rope_write_prompt_pages_"],
               " (olmoe-1b-7b prefill); launches: the olmoe default session"),
              ("[2x4096]", long["rope_write_prompt_pages_"],
               " (largest prefill); launches: the 4096-token session"))),
        *({"name": f"rope_append_kv_{tag}", "route": "cuda",
           "source": "src/repro_torch/csrc/kv_cache.cu",
           "replaces": "src/repro/serving/kv_cache.py:212",
           "launches": n, **kv[f"rope_append_kv_{tag}"],
           "shape": kv[f"rope_append_kv_{tag}"]["shape"] + note}
          for tag, n, note in (
              ("", path_counts["rope_append_kv_"], " (decode step; rotates q and k)"),
              ("[olmoe]", moe_counts["rope_append_kv_"],
               " (olmoe-1b-7b decode step); launches: the olmoe default session"))),
        {"name": "write_prompt_pages_", "route": "cuda",
         "source": "src/repro_torch/csrc/kv_cache.cu",
         "replaces": "src/repro/serving/kv_cache.py:129",
         "shape": f"B=1 S=32 Hkv={HKV} dh={DH} bf16, the write alone (on no model path: the "
                  "paged calls rotate in rope_write_prompt_pages_)",
         "launches": main_counts["write_prompt_pages_"], **kv["write_prompt_pages_"]},
        {"name": "append_kv_", "route": "cuda", "source": "src/repro_torch/csrc/kv_cache.cu",
         "replaces": "src/repro/serving/kv_cache.py:212",
         "shape": f"B=4 Hkv={HKV} dh={DH} bf16, the write alone (on no model path: the paged "
                  "calls rotate in rope_append_kv_)",
         "launches": main_counts["append_kv_"], **kv["append_kv_"]},
        {"name": "fused_pwl_softmax", "route": "cuda",
         "source": "src/repro_torch/csrc/softmax.cu",
         "replaces": "src/repro/kernels/fused/softmax.py:69",
         "shape": "12x32 rows x 32 causal f32 (prefill, B=1)",
         "launches": path_counts["fused_pwl_softmax"], **sm["prefill B=1 12x32 x 32 causal"]},
        {"name": "fused_pwl_softmax[48x1500]", "route": "cuda",
         "source": "src/repro_torch/csrc/softmax.cu",
         "replaces": "src/repro/kernels/fused/softmax.py:69",
         "shape": f"4x{HKV} rows x {WHISPER_FRAMES} f32, a cluster of "
                  f"{sm[WHISPER_CROSS_SOFTMAX]['cluster']} blocks a row (whisper-small's decode "
                  "cross-attention); launches: every row softmax of the whisper session",
         "launches": whisper_counts["fused_pwl_softmax"], **sm[WHISPER_CROSS_SOFTMAX]},
        {"name": "paged_flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/decoding.cu",
         "replaces": "src/repro/kernels/fused/decoding.py:72",
         "shape": f"B=4 Hkv={HKV} dh={DH} ps={PS} bf16 pools, kv_len 19/32/15/0",
         "launches": path_counts["paged_flash_decode"], **dec["B=4 kv_len {19,32,15,0}"]},
        {"name": "fused_flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/attention.cu",
         "replaces": "src/repro/kernels/fused/attention.py:100",
         "shape": f"S=T=4096 causal H={HKV} dh={DH} bf16 (prefill, B=1)",
         "launches": path_counts["fused_flash_attention"], **fl["S=T=4096 causal H=12"]},
        {"name": "fused_glu_bwd", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/glu.py:97",
         "shape": f"M={TRAIN_TOKENS} K={K_DIM} N={N_DIM} bf16 (train step, batch 8 x 512)",
         "launches": path_counts["fused_glu_bwd"], **glu_bwd[(TRAIN_TOKENS, torch.bfloat16)]},
        {"name": "fused_moe_glu_bwd", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/moe.py:107",
         "shape": f"E={MOE_E} C={MOE_TRAIN_C} K={MOE_K} N={MOE_N} bf16 (olmoe-1b-7b, 8 x 512 "
                  "tokens); launches from reduced olmoe training",
         "launches": path_counts["fused_moe_glu_bwd"], **moe_bwd[MOE_TRAIN_C]},
        {"name": "fused_pwl_softmax_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/softmax.cu",
         "replaces": "src/repro/kernels/fused/softmax.py:213",
         "shape": f"{TRAIN_SOFTMAX} f32 (train step)",
         "launches": path_counts["fused_pwl_softmax_bwd"], **sm_bwd[TRAIN_SOFTMAX]},
        {"name": "fused_flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/attention_bwd.cu",
         "replaces": "src/repro/kernels/fused/attention.py:334/396/445/498",
         "shape": f"S=T={LONG_SEQ} causal H={HKV} dh={DH} bf16 (train step, batch 1 x {LONG_SEQ})",
         "launches": path_counts["fused_flash_attention_bwd"],
         **fl_bwd[f"S=T={LONG_SEQ} causal H=12"]},
        {"name": "pwl_activation", "route": "cuda", "source": "src/repro_torch/csrc/pwl_act.cu",
         "replaces": "src/repro/kernels/pwl_act.py:40",
         "shape": f"4 x {N_DIM} bf16, gelu_tanh 32 breakpoints (impl='kernel' decode step)",
         "launches": path_counts["pwl_activation"], **pwl["decode 4 x 3072 bf16"]},
        {"name": "pwl_activation[4096x3072]", "route": "cuda",
         "source": "src/repro_torch/csrc/pwl_act.cu",
         "replaces": "src/repro/kernels/pwl_act.py:40",
         "shape": f"{TRAIN_TOKENS} x {N_DIM} bf16, gelu_tanh 32 breakpoints; launches: the "
                  "impl='kernel' session's",
         "launches": path_counts["pwl_activation"], **pwl["4096 x 3072 bf16"]},
        {"name": "pwl_activation_uniform", "route": "cuda",
         "source": "src/repro_torch/csrc/pwl_act.cu",
         "replaces": "src/repro/kernels/pwl_act.py:52",
         "shape": "32 x 384 f32, sigmoid 32 breakpoints (the paper's uniform baseline; on no "
                  "model path)",
         "launches": 0, **pwl["uniform 32 x 384 f32"]},
        {"name": "pwl_activation_uniform[4096x3072]", "route": "cuda",
         "source": "src/repro_torch/csrc/pwl_act.cu",
         "replaces": "src/repro/kernels/pwl_act.py:52",
         "shape": f"{TRAIN_TOKENS} x {N_DIM} bf16, sigmoid 32 breakpoints (on no model path)",
         "launches": 0, **pwl["uniform 4096 x 3072 bf16"]},
        {"name": "fused_linear", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/linear.py:54",
         "shape": f"M=4 K={K_DIM} N={N_DIM} bf16 with bias (whisper-small decode step)",
         "launches": path_counts["fused_linear"], **lin[4]},
        {"name": "fused_linear_bwd", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/linear.py:137",
         "shape": f"M={WHISPER_TRAIN_BATCH * WHISPER_FRAMES} K={K_DIM} N={N_DIM} bf16 with bias "
                  "(whisper-small train step, the encoder)",
         "launches": path_counts["fused_linear_bwd"],
         **lin_bwd[WHISPER_TRAIN_BATCH * WHISPER_FRAMES]},
    ]
    # slice 7: kernels 17-18 (on no model path: launches from the op's own
    # path at the row's width), the exact and identity epilogues (launches of each wrapper in
    # the exact-epilogue path, both kinds together) and head dim 256
    norm_src, fused_src = "src/repro_torch/csrc/norm.cu", "src/repro/kernels/fused"
    for D, ep, tag in ((K_DIM, "gelu PWL f32", ""), (MOE_K, "gelu PWL f32", "[D=2048]"),
                       (QWEN_D, "gelu PWL f32", "[D=5120]"),
                       (K_DIM, "identity", "[identity]"), (K_DIM, "exact gelu", "[act=gelu]")):
        counts = norm_counts[D] if ep == "gelu PWL f32" else exact_counts
        r = nrm[(f"{TRAIN_TOKENS} x {D} bf16", ep)]
        for bwd, line in ((False, 31), (True, 102)):
            suffix = "_bwd" if bwd else ""
            kernels.append({
                "name": f"fused_rmsnorm{suffix}{tag}", "route": "cuda", "source": norm_src,
                "replaces": f"{fused_src}/norm.py:{line}",
                "shape": f"M={TRAIN_TOKENS} D={D} bf16, {ep} (repro-100m's training rows; "
                         "olmoe's width at D=2048, qwen2.5-32b's at D=5120)",
                "launches": counts[f"fused_rmsnorm{suffix}"], **r["bwd" if bwd else "fwd"]})
    variants = [  # (name, source, replaces, shape, counter, row of exact_epilogue_phase)
        ("fused_glu[act=gelu]", "glu.cu", "glu.py:30", f"M={TRAIN_TOKENS} K={K_DIM} N={N_DIM} bf16",
         "fused_glu", "fused_glu"),
        ("fused_glu[identity]", "glu.cu", "glu.py:30", f"M={TRAIN_TOKENS} K={K_DIM} N={N_DIM} bf16",
         "fused_glu", "fused_glu identity"),
        ("fused_glu_bwd[act=gelu]", "glu.cu", "glu.py:97",
         f"M={TRAIN_TOKENS} K={K_DIM} N={N_DIM} bf16", "fused_glu_bwd", "fused_glu_bwd"),
        ("fused_moe_glu[act=gelu]", "glu.cu", "moe.py:41",
         f"E={MOE_E} C=1 K={MOE_K} N={MOE_N} bf16", "fused_moe_glu", "fused_moe_glu"),
        ("fused_linear[act=gelu]", "glu.cu", "linear.py:54", f"M=4 K={K_DIM} N={N_DIM} bf16, bias",
         "fused_linear", "fused_linear"),
        ("fused_linear_bwd[act=gelu]", "glu.cu", "linear.py:137",
         f"M={WHISPER_TRAIN_BATCH * WHISPER_FRAMES} K={K_DIM} N={N_DIM} bf16, bias",
         "fused_linear_bwd", "fused_linear_bwd"),
        ("fused_pwl_softmax[act=exp]", "softmax.cu", "softmax.py:69", f"{TRAIN_SOFTMAX} f32",
         "fused_pwl_softmax", "fused_pwl_softmax"),
        ("fused_pwl_softmax_bwd[act=exp]", "softmax.cu", "softmax.py:213", f"{TRAIN_SOFTMAX} f32",
         "fused_pwl_softmax_bwd", "fused_pwl_softmax_bwd"),
        ("paged_flash_decode[act=exp]", "decoding.cu", "decoding.py:72",
         f"B=4 Hkv={HKV} dh={DH} ps={PS} bf16, kv_len 19/32/15/0", "paged_flash_decode",
         "paged_flash_decode"),
        ("fused_flash_attention[act=exp]", "attention.cu", "attention.py:100",
         f"S=T={LONG_SEQ} causal H={HKV} dh={DH} bf16", "fused_flash_attention",
         "fused_flash_attention"),
        ("fused_flash_attention_bwd[act=exp]", "attention_bwd.cu",
         "attention.py:334/396/445/498", f"S=T={LONG_SEQ} causal H={HKV} dh={DH} bf16",
         "fused_flash_attention_bwd", "fused_flash_attention_bwd"),
    ]
    for name, src, rep, shape, counter, key in variants:
        kernels.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                        "replaces": f"{fused_src}/{rep}", "shape": shape,
                        "launches": exact_counts[counter], **exact[key]})
    gemma = f"B=1 S=T={GEMMA_SEQ} H={GEMMA_H} Hkv={GEMMA_HKV} dh={GEMMA_DH} bf16 (gemma3-1b)"
    for key, tag in ((f"S=T={GEMMA_SEQ} causal window {GEMMA_WINDOW}", "window 512"),
                     (f"S=T={GEMMA_SEQ} causal", "causal")):
        for bwd in (False, True):
            suffix = "_bwd" if bwd else ""
            kernels.append({
                "name": f"fused_flash_attention{suffix}[dh=256, {tag}]", "route": "cuda",
                "source": f"src/repro_torch/csrc/attention{suffix}.cu",
                "replaces": f"{fused_src}/attention.py:" + ("334/396/445/498" if bwd else "100"),
                "shape": f"{gemma}, causal" + (f", window {GEMMA_WINDOW}" if "window" in tag
                                               else ""),
                "launches": d256_counts[f"fused_flash_attention{suffix}"],
                **d256[key + (" bwd" if bwd else "")]})
    kernels.append({"name": "paged_flash_decode[dh=256]", "route": "cuda",
                    "source": "src/repro_torch/csrc/decoding.cu",
                    "replaces": f"{fused_src}/decoding.py:72",
                    "shape": f"B=4 H={GEMMA_H} Hkv={GEMMA_HKV} dh={GEMMA_DH} ps={PS} bf16, kv_len "
                             "19/32/15/2100",
                    "launches": d256_counts["paged_flash_decode"], **d256["decode"]})
    # slice 15: the kernels at the new architectures' shapes, launches from
    # the session or run that puts each on a model path
    from repro_torch.configs import get_config as get_config_full

    glu_src, glu_rep = "src/repro_torch/csrc/glu.cu", f"{fused_src}/glu.py"
    for a in NEW_ARCHS:
        c = get_config_full(a)
        kernels.append({"name": f"fused_glu[{a} decode]", "route": "cuda", "source": glu_src,
                        "replaces": f"{glu_rep}:30",
                        "shape": f"M=4 K={c.d_model} N={c.d_ff} {c.activation} bf16 ({a} decode "
                                 "step); launches: its default serve session",
                        "launches": arch[a]["fused_glu"], **arch_glu[(a, 4, "fwd")]})
    for a, run in (("olmo-1b", olmo_trained), ("gemma3-1b", gemma_trained)):
        c = get_config_full(a)
        for bwd, line in ((False, 30), (True, 97)):
            suffix = "_bwd" if bwd else ""
            kernels.append({
                "name": f"fused_glu{suffix}[{a} train]", "route": "cuda", "source": glu_src,
                "replaces": f"{glu_rep}:{line}",
                "shape": f"M=4096 K={c.d_model} N={c.d_ff} {c.activation} bf16 ({a} train step); "
                         "launches: its train run",
                "launches": run["counts"][f"fused_glu{suffix}"],
                **arch_glu[(a, 4096, "bwd" if bwd else "fwd")]})
    for a, g in (("qwen2.5-32b", 5), ("internvl2-1b", 7)):
        for name, line, what in (("rope_append_kv_", 212, "decode step"),
                                 ("rope_write_prompt_pages_", 129, "prefill")):
            row = arch_kv[f"{name}[{a}]"]
            kernels.append({"name": f"{name}[{a} G={g}]", "route": "cuda",
                            "source": "src/repro_torch/csrc/kv_cache.cu",
                            "replaces": f"src/repro/serving/kv_cache.py:{line}",
                            "shape": row["shape"] + f" ({a} {what}); launches: its default session",
                            "launches": arch[a][name], **row})
        key = DECODE_G5 if g == 5 else DECODE_G7
        kernels.append({"name": f"paged_flash_decode[{a} G={g}]", "route": "cuda",
                        "source": "src/repro_torch/csrc/decoding.cu",
                        "replaces": f"{fused_src}/decoding.py:72",
                        "shape": key + " bf16 pools; launches: its fused-softmax session",
                        "launches": arch[f"{a} softmax"]["paged_flash_decode"], **dec[key]})
    gemma_train = f"B=1 S=T={GEMMA_TRAIN_SEQ} H={GEMMA_H} Hkv={GEMMA_HKV} dh={GEMMA_DH} bf16"
    for bwd in (False, True):
        suffix = "_bwd" if bwd else ""
        kernels.append({
            "name": f"fused_flash_attention{suffix}[gemma3-1b train, window 512]",
            "route": "cuda", "source": f"src/repro_torch/csrc/attention{suffix}.cu",
            "replaces": f"{fused_src}/attention.py:" + ("334/396/445/498" if bwd else "100"),
            "shape": f"{gemma_train}, causal, window {GEMMA_WINDOW} (gemma3-1b's local layers "
                     "in training); launches: its train run",
            "launches": gemma_trained["counts"][f"fused_flash_attention{suffix}"],
            **d256[GEMMA_TRAIN_FLASH + (" bwd" if bwd else "")]})
    for window in (None, GEMMA_WINDOW):
        key = GEMMA_TRAIN_SOFTMAX + ("" if window is None else f" window {GEMMA_WINDOW}")
        for bwd, line, rows_ in ((False, 69, sm), (True, 213, sm_bwd)):
            suffix = "_bwd" if bwd else ""
            launches = (gemma_trained["counts"][f"fused_pwl_softmax{suffix}"] if window is None
                        else 0)
            kernels.append({
                "name": f"fused_pwl_softmax{suffix}[{key.removeprefix('gemma3-1b train ')}]",
                "route": "cuda", "source": "src/repro_torch/csrc/softmax.cu",
                "replaces": f"{fused_src}/softmax.py:{line}",
                "shape": key + " f32" + ("; launches: the gemma3-1b train run (its global "
                                         "layers)" if window is None else
                                         "; on no model path of this script: a local layer "
                                         "takes it when its window covers half the keys"),
                "launches": launches, **rows_[key]})
    # slice 16: kernel 19 at mamba2-2.7b's dt shapes, launches from the
    # session under the plan with ssm:softplus on the standalone kernel
    for name in MAMBA_DT:
        kernels.append({"name": f"pwl_activation[mamba2 {name.removesuffix(' f32')}]",
                        "route": "cuda", "source": "src/repro_torch/csrc/pwl_act.cu",
                        "replaces": "src/repro/kernels/pwl_act.py:40",
                        "shape": f"{name.removeprefix('dt ')}, softplus 32 breakpoints "
                                 "(mamba2-2.7b's dt, impl='kernel' plan); launches: that "
                                 "serve session's",
                        "launches": mamba_serve["kernel"]["pwl_activation"], **pwl[name]})
    # slice 18: every family at 128 breakpoints on its wide instantiation, launches
    # from the 129-segment session where it is on that session's path
    src_of = {"fused_glu": "glu.cu", "fused_moe_glu": "glu.cu", "fused_linear": "glu.cu",
              "fused_pwl_softmax": "softmax.cu", "paged_flash_decode": "decoding.cu",
              "fused_flash_attention": "attention.cu", "fused_rmsnorm": "norm.cu",
              "pwl_activation": "pwl_act.cu", "pwl_activation_uniform": "pwl_act.cu"}
    for name, rows in wide.items():
        for r in rows:
            kernels.append({
                "name": f"{name}[128 breakpoints, wide, {r['shape']}]", "route": "cuda",
                "source": f"src/repro_torch/csrc/{src_of[name]}",
                "replaces": f"{fused_src}/{r['replaces']}".replace(
                    "fused/pwl_act.py", "pwl_act.py"),
                "shape": f"{r['shape']}, a uniform table of 128 breakpoints (the wide "
                         "instantiation); "
                         + ("launches: the 129-segment session's" if r["on_path"]
                            else "on no model path at this shape"),
                "launches": wide_counts[name] if r["on_path"] else 0, **r})
    # slice 20: every fused kernel at the local shapes of a (data=2, model=2)
    # mesh rank; one card runs no mesh, so none is on a path here
    kernels.extend(shard_rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(f"[smoke] whisper-small train step {whisper_trained['step_ms']:.1f} ms median, "
          f"{whisper_trained['tokens_per_s']:.0f} target tokens/s")
    print(f"[smoke] train step {trained['step_ms']:.1f} ms median, "
          f"{trained['tokens_per_s']:.0f} tokens/s; long-context ({LONG_BATCH} x {LONG_SEQ}) "
          f"{long_trained['step_ms']:.1f} ms median, {long_trained['tokens_per_s']:.0f} tokens/s")
    for a in NEW_ARCHS:
        ses = arch[a]["session"]
        print(f"[smoke] {a} default session: {ses['tok_per_s']:.1f} tok/s, "
              f"{ses['ms_per_call']:.2f} ms a model call, peak {ses['peak_bytes'] / 1e9:.2f} GB")
    print(f"[smoke] qwen2.5-32b: init {qwen_init['seconds']:.1f} s, peak "
          f"{qwen_init['peak_bytes'] / 1e9:.2f} GB; fused-softmax session peak "
          f"{arch['qwen2.5-32b softmax']['session']['peak_bytes'] / 1e9:.2f} GB")
    print(f"[smoke] olmo-1b train step {olmo_trained['step_ms']:.1f} ms median, "
          f"{olmo_trained['tokens_per_s']:.0f} tokens/s; gemma3-1b (1 x {GEMMA_TRAIN_SEQ}) "
          f"{gemma_trained['step_ms']:.1f} ms median, {gemma_trained['tokens_per_s']:.0f} tokens/s")
    for tag, ses in mamba_serve.items():
        ses = ses["session"]
        print(f"[smoke] {MAMBA} {tag} session: {ses['tok_per_s']:.1f} tok/s, "
              f"{ses['ms_per_call']:.2f} ms a model call, peak {ses['peak_bytes'] / 1e9:.2f} GB")
    print(f"[smoke] {MAMBA} train step (8 x 512) {mamba_trained['step_ms']:.1f} ms median, "
          f"{mamba_trained['tokens_per_s']:.0f} tokens/s, peak "
          f"{mamba_trained['peak_bytes'] / 1e9:.2f} GB")
    for line in roofline_lines(trained, long_trained, main_counts["session"], card):
        print(line)
    for tag, run in autotuned.items():
        if not tag.startswith("serve"):
            print(f"[smoke] autotune {tag}: {run['seconds']:.1f}s, e2e top1 "
                  f"{run['report']['e2e']['top1_agree']:.4f}, plan "
                  f"{run['report']['plan_fingerprint']}, launches "
                  f"{ {k: run['counts'][k] for k in AUTOTUNE_KERNELS} }")
    print(f"[smoke] guard: {guard['off']:.2f} launches a call off, {guard['on']:.2f} on; "
          f"repro-100m call {guard['repro-100m']['call_ms']:.2f} ms, degraded re-run "
          f"{guard['repro-100m']['degraded_ms']} ms; olmoe call "
          f"{guard['olmoe-1b-7b']['call_ms']:.2f} ms, degraded re-run "
          f"{guard['olmoe-1b-7b']['degraded_ms']} ms")
    print(f"[smoke] total {time.perf_counter() - t_start:.1f}s (build {build_s:.1f}s)")
    print(card_line())
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
