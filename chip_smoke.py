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
   olmoe's width in bf16 and at odd widths in f32, with identity, PWL (f32,
   bf16, int8 tables) and exact epilogues, and drives it once through its
   autograd (no model calls it); holds every kernel that takes an epilogue
   plan under exact (``act=``) and identity plans, forward and backward,
   on grids that hit the kinks, and drives each through its public entry
   point; holds the flash forward and backward at head dim 256 (gemma3-1b's
   attention, causal with and without its 512 window) and the split-KV
   decode at dh 256;
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
   NaN and all).

Every failed check exits non-zero.  The last two lines of standard output
are the kernels' JSON line and ``{"ok": true, "device": {...}}``; the card's
name and power limit are printed before them.  Needs a CUDA GPU and the
repository around this file; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOP_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
SMS = 132                      # H100 SXM streaming multiprocessors
SM_CLOCK_HZ = 1.98e9           # H100 SXM boost clock (NVIDIA data sheet)
SEARCH_SHARED_LOADS = 6        # shared loads of one breakpoint-search decode
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
            print(f"[smoke]   SASS glu: {len(funcs)} kernels, {hmma} HMMA instructions")
            check(hmma > 0, "the GLU library's SASS has no tensor-core (HMMA) instruction")
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


def _order_band(torch, x, weights, bias, g, got, plan, tables, what):
    """The backward kernel's slopes against the plain version's, element by
    element: ``got`` is dzg of the GLU (``weights`` (wg, wu)) or dz of the
    linear layer (``weights`` (w,), ``bias``).  An element is marked where
    it differs from g * zu * slope_plain (or g * slope_plain) by more than
    the rounding of zu over the order band and of the products.  Every marked
    element must lie within the order band of a breakpoint of the plain
    pre-activation and take there the slope of one of the breakpoint's two
    segments.  Bounds the marked share by ``MAX_FLIP_SHARE`` and the share
    within the band by ``MAX_BAND_SHARE``.  Returns the mask of the elements
    within the band, which the caller leaves out of its tolerance check, and
    the line to print."""
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
    bps = tables[0].reshape(-1).float()
    dist = torch.full_like(z[0], math.inf)
    nearest = torch.zeros_like(z[0], dtype=torch.long)
    for i, b in enumerate(bps.tolist()):
        d = (z[0] - b).abs()
        closer = d < dist
        dist = torch.where(closer, d, dist)
        nearest = torch.where(closer, i, nearest)
    near = dist <= ORDER_BAND_C * (K + 1) * u * mag[0]
    b = bps[nearest]
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
    check(flips <= MAX_FLIP_SHARE and in_band <= MAX_BAND_SHARE,
          f"{what}: slope mismatch share {flips:.3g}, share within the band {in_band:.3g}")
    return near, (f"slope mismatches {flips:.3g} of the elements, each within the order band "
                  f"(c = {ORDER_BAND_C}) of a breakpoint with a neighbouring segment's slope; "
                  f"the band holds {in_band:.3g}, left out of the tolerance")


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
# "M dtype": f32, and bf16 at M = 4 (the CUDA-core kernel), as the dense-only
# GLU kernel of commit 94d8fb7 (before the expert axis went in) computed them;
# bf16 at M = 32 and 4096 as the tensor-core kernel that replaced the
# CUDA-core bf16 kernel of 7183c4b computes them (one summation order in
# every tile configuration); both on an H100 80GB HBM3 (700 W)
GLU_DIGESTS = {
    "4 bfloat16": "86f443aed05d36103de67183554a231d5b3116689e239c90d2598ea669f90880",
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


def _compare_rows(torch, got, want, live, tol, what) -> float:
    """Gradient rows on their own scale: in each row max |got - want| at most
    ``tol`` times that row's max |want|, and every entry outside ``live``
    exactly 0.  Returns the max abs error."""
    N = got.shape[-1]
    g, w = got.float().reshape(-1, N), want.float().reshape(-1, N)
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs().amax(dim=-1)
    scale = w.abs().amax(dim=-1)
    bad = int((err > tol * scale).sum())
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
    too), and equal elsewhere."""
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
    cases = [  # (name, score shape, kwargs)
        (train, (B, 1, HKV, S, S), {"causal": True}),
        ("96 rows x 2048 mask", (8, HKV, 2048), {"mask": True}),
        ("512 rows x 512 three-way argmax ties", (512, 512), {"ties": True}),
        ("48 x 32768 mask, three-way ties, 12 rows all masked", (4, HKV, 32768),
         {"ties": True, "lens": [32768, 20000, 5, 0]}),
    ]
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
            fkw["causal"] = True
            mask2 = static_mask(x.numel() // N, N, S, True, None, device=dev)
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
        err = _compare_rows(torch, got2[some], want[some], live[some], 1e-5,
                            f"softmax bwd {name}")
        line = (f"[smoke] fused_pwl_softmax backward {name} (cluster "
                f"{_split_plan(x2.shape[0], N).cluster}): max_abs_err {err:.3g} (row tol 1e-5)")
        if not bool(some.all()):
            _same_or_nan(torch, got2[~some], want[~some], f"softmax bwd {name} all-masked rows")
            line += (f"; {int((~some).sum())} all-masked rows equal to the plain version's "
                     f"(NaN share {torch.isnan(want[~some]).float().mean().item():.3g})")
        if name == train:
            def library(i):
                return torch.autograd.grad(torch.softmax(xr, dim=-1), xr, g)

            k_ms = time_ms(torch, lambda i: fused_pwl_softmax_bwd(
                x2, None, g2, plan, tables, S, True), reps=5, iters=4)
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
    """Both page-write kernels vs their plain versions, bitwise outside the
    sentinel page, at the serve shapes (bf16 pools of one layer):
    repro-100m's 12 KV heads of dim 64 and olmoe-1b-7b's 16 of dim 128.
    Returns repro-100m's rows."""
    out = _kv_case(torch, HKV, DH)
    _kv_case(torch, MOE_HKV, MOE_DH)
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
    against the plain version's f32 result on the same scores."""
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
    step under the fused-softmax plan (16 KV heads of dim 128, G = 1)."""
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
    from repro_torch.serving.kv_cache import append_kv_, write_prompt_pages_

    return {"fused_glu": (fused.fused_glu, "launches"),
            "fused_linear": (fused.fused_linear, "launches"),
            "pwl_activation": (ops.pwl_activation, "launches"),
            "pwl_activation_uniform": (ops.pwl_activation_uniform, "launches"),
            "fused_moe_glu": (fused.fused_moe_glu, "launches"),
            "write_prompt_pages_": (write_prompt_pages_, "launches"),
            "append_kv_": (append_kv_, "launches"),
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


FULL_WIDTH = {  # arch: (d_model, layers, experts) of its published config
    "repro-100m": (768, N_LAYERS, 0),
    "olmoe-1b-7b": (MOE_K, MOE_LAYERS, MOE_E),
}


def serve_phase(torch, argv: list[str], attention, ffn: str | None = None) -> dict:
    """One full-width session through the serve entry point; returns the
    launch counts of exactly that session.  ``attention(steps)`` gives the
    expected softmax / paged-decode / flash launches from the session's
    ``{"prefills", "decode_steps", "layers"}`` (the dense loop: one prefill
    and ``max_new`` decode steps).  Every layer of every model call runs its
    FFN's kernel: the GLU for repro-100m, the MoE GLU (and no GLU) for an
    MoE arch, or ``ffn`` (the standalone PWL kernel under an
    ``impl="kernel"`` plan), and no other FFN kernel.  Prints tok/s, the
    mean time of a model call and the session's peak of allocated device
    memory (weights included), as serve measures it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    check(args.device == "cuda", "serve must default to cuda")
    cfg = get_config(args.arch)
    check((cfg.d_model, cfg.n_layers, cfg.n_experts) == FULL_WIDTH[args.arch],
          f"not full-width {args.arch}")
    reset_counters()
    summary = serve.run(args)
    torch.cuda.synchronize()
    counts = read_counters()
    peak = summary["peak_bytes"]
    check(len(summary["results"]) == args.batch, "a request is missing")
    L = cfg.n_layers
    if args.mode == "dense":
        for row in summary["results"]:
            check(len(row) == args.max_new, f"dense row of {len(row)} tokens")
        pf, ds = 1, args.max_new
        check(counts["write_prompt_pages_"] == 0 and counts["append_kv_"] == 0,
              "the dense loop wrote pages")
    else:
        eng = summary["engine"]
        for r in summary["results"]:
            check(len(r.tokens) == args.max_new and r.finish_reason == "length",
                  f"{r.request_id}: {len(r.tokens)} tokens ({r.finish_reason})")
        check(eng.health_summary()["nonfinite_logits"] == 0, "non-finite logits")
        pf, ds = summary["prefills"], summary["decode_steps"]
        check(counts["write_prompt_pages_"] == L * pf,
              f"write_prompt_pages_ launches {counts['write_prompt_pages_']} != {L} x {pf}")
        check(counts["append_kv_"] == L * ds,
              f"append_kv_ launches {counts['append_kv_']} != {L} x {ds}")
    ffn = ffn or ("fused_moe_glu" if cfg.n_experts else "fused_glu")
    check(counts[ffn] == L * (pf + ds), f"{ffn} launches {counts[ffn]} != {L} x ({pf} + {ds})")
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
    return counts


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
    the CUDA cores (~3 a breakpoint)."""
    return _f32_bound(2.0 * n * esize, n * ops_per_elem)


def _bitwise(torch, got, want, what) -> None:
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    a, b = got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)
    check(bool(torch.equal(a, b)),
          f"{what}: not bitwise, max err {(got.float() - want.float()).abs().max().item()}")


def pwl_act_phase(torch):
    """The standalone PWL kernels (TPU kernels 19 and 20) through their
    wrappers ``ops.pwl_activation`` / ``ops.pwl_activation_uniform`` on CUDA
    tensors against their plain versions, bitwise: kernel 19 at the unfused
    GLU gate of the ``impl="kernel"`` serving session (decode 4 x 3072,
    prefill 32 x 3072, bf16; gelu_tanh, 32 breakpoints), at 4096 x 3072 in
    bf16, f16 and f32, and with bf16 and f16 tables (the plain version on
    the native operands); kernel 20 at tests/test_kernels.py's shape (32 x
    384 f32, sigmoid, 32 breakpoints, uniform) and at 4096 x 3072 bf16."""
    from repro_torch import sfu
    from repro_torch.core import functions as F
    from repro_torch.core.pwl import make_uniform_table
    from repro_torch.kernels import ops, pwl_act
    from repro_torch.kernels.fused.epilogue import pack_table

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    table = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32)
    cases = [  # (name, shape, dtype, table format, timed)
        ("decode 4 x 3072 bf16", (4, 1, N_DIM), torch.bfloat16, "f32", True),
        ("prefill 32 x 3072 bf16", (1, 32, N_DIM), torch.bfloat16, "f32", False),
        ("4096 x 3072 bf16", (TRAIN_TOKENS, N_DIM), torch.bfloat16, "f32", True),
        ("4096 x 3072 f16", (TRAIN_TOKENS, N_DIM), torch.float16, "f32", False),
        ("4096 x 3072 f32", (TRAIN_TOKENS, N_DIM), torch.float32, "f32", False),
        ("4096 x 3072 bf16, bf16 table", (TRAIN_TOKENS, N_DIM), torch.bfloat16, "bf16", False),
        ("4096 x 3072 f32, f16 table", (TRAIN_TOKENS, N_DIM), torch.float32, "f16", False),
    ]
    for name, shape, dtype, fmt, timed in cases:
        t = sfu.get_store().get(fn="gelu_tanh", n_breakpoints=32, dtype=fmt)
        x = (torch.randn(shape, generator=gen, device=dev) * 4.0).to(dtype)
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
                          **_elementwise_bound(x.numel(), x.element_size(), 3 * 32)}
            line += (f", kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
                     f"{rows[name]['bound_ms'] * 1e3:.2f} us ({rows[name]['bound_by']})")
        print(line)

    spec = F.get("sigmoid")
    ut = make_uniform_table(spec, 32)
    um, uq = ut.m.to(dev), ut.q.to(dev)  # on the card: a graph capture copies nothing
    lo, hi = spec.default_range
    mq = ops.pack_uniform(um, uq)
    for name, shape, dtype in (("32 x 384 f32", (32, 384), torch.float32),
                               ("4096 x 3072 bf16", (TRAIN_TOKENS, N_DIM), torch.bfloat16)):
        x = (torch.randn(shape, generator=gen, device=dev) * 6.0).to(dtype)
        n0 = ops.pwl_activation_uniform.launches
        got = ops.pwl_activation_uniform(x, um, uq, lo, hi)
        check(ops.pwl_activation_uniform.launches == n0 + 1,
              f"pwl_activation_uniform {name}: not launched")
        want = pwl_act.pwl_uniform_plain(x, mq, lo, hi)
        torch.cuda.synchronize()
        _bitwise(torch, got, want, f"pwl_activation_uniform {name}")
        k_ms = time_ms(torch, lambda i: ops.pwl_activation_uniform(x, um, uq, lo, hi))
        p_ms = time_ms(torch, lambda i: pwl_act.pwl_uniform_plain(x, mq, lo, hi), reps=3,
                       iters=3)
        # the affine index (~6 operations) and the 32 delta steps (3 each)
        rows[f"uniform {name}"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                                   "max_abs_err": 0.0,
                                   **_elementwise_bound(x.numel(), x.element_size(), 6 + 3 * 32)}
        r = rows[f"uniform {name}"]
        print(f"[smoke] pwl_activation_uniform {name}: bitwise its plain version, kernel "
              f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} "
              f"us ({r['bound_by']})")
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
NORM_EPS = 1e-6


def _epilogue_kwargs(name: str) -> dict:
    """``table=`` or ``act=`` of a named epilogue: "identity", "exact <fn>" or
    "<fn> PWL <format>" (32 breakpoints)."""
    from repro_torch import sfu

    if name == "identity":
        return {}
    if name.startswith("exact "):
        return {"act": name.split()[1]}
    fn, _, fmt = name.split()
    return {"table": sfu.get_store().get(fn=fn, n_breakpoints=32, dtype=fmt)}


def _epilogue_operands(torch, kw: dict):
    """``(plan, operands)`` twice for an epilogue's kwargs: as the plain
    versions take them (a bf16 table in its native layout) and as the kernel
    wrappers take them (the f32 delta layout), both on the card."""
    from repro_torch.kernels.fused.epilogue import device_operands, plan_and_operands

    plan, tables = plan_and_operands(kw.get("table"), kw.get("act"))
    kplan, ktables = device_operands(kw.get("table"), kw.get("act"), "cuda")
    return (plan, tuple(t.cuda() for t in tables)), (kplan, ktables)


def _norm_bound(M: int, D: int, esize: int, n_bp: int, backward: bool) -> dict:
    """The fused RMSNorm's least time: x read and y written once (the
    backward: x and g read, dx written in f32, ds written), scale read once;
    against ~4 f32 operations an element for the normalisation (10 for the
    backward) and ~3 a breakpoint for a PWL decode.  An exact function's
    libm operations are not counted (at 4096 x 768 they would need over 60
    an element to pass the bytes)."""
    if backward:
        nbytes = M * D * (2 * esize + 4) + 2 * D * 4
    else:
        nbytes = 2 * M * D * esize + D * 4
    return _f32_bound(nbytes, M * D * ((10 if backward else 4) + 3 * n_bp))


def norm_phase(torch):
    """``fused_rmsnorm`` (TPU kernels 17-18) on CUDA tensors against its
    plain versions: the forward through ``fused_rmsnorm`` (its launches
    counted), the backward through autograd under ``impl_bwd="fused"`` (its
    ``bwd_launches`` counted; the gradient of x must be the kernel's dx) and
    through ``fused_rmsnorm_bwd``; at repro-100m's training rows (4096 x
    768) and olmoe-1b-7b's width (4096 x 2048) in bf16 (1e-2), and at the
    JAX tests' odd widths (33 x 40, 21 x 48) in f32 (forward 1e-5, dx and ds
    1e-4 of each one's max); each with the identity, gelu PWL (f32, bf16 and
    int8 tables) and exact gelu epilogues.  ds must be bitwise the same from
    a second backward.  Timed at 4096 x 768 (every epilogue but the bf16 and
    int8 tables) and at 4096 x 2048 (the f32 table), against
    ``torch.nn.functional.rms_norm`` (weight 1 + scale) and its autograd."""
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
        ("33 x 40 f32", 33, 40, torch.float32),
        ("21 x 48 f32", 21, 48, torch.float32),
    ]
    rows = {}
    for name, M, D, dtype in cases:
        tol, gtol = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
        x = (torch.randn(M, D, generator=gen, device=dev) * 3.0).to(dtype)
        s = torch.randn(D, generator=gen, device=dev) * 0.3
        g = torch.randn(M, D, generator=gen, device=dev).to(dtype)
        for ep in NORM_EPILOGUES:
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
            errs = [_compare_scaled(torch, dx, wdx, gtol, f"{what} dx"),
                    _compare_scaled(torch, ds, wds, gtol, f"{what} ds")]
            check(torch.equal(xr.grad, dx.to(dtype)), f"{what}: autograd's dx is not the kernel's")
            check(torch.equal(ds, ds2), f"{what}: ds differs between two backward calls")
            line = (f"[smoke] fused_rmsnorm {name} {ep}: max_abs_err {err:.3g} (tol {tol}), "
                    f"backward dx {errs[0]:.3g} ds {errs[1]:.3g} (tol {gtol} of each max), ds "
                    "bitwise repeatable")
            timed = (M == TRAIN_TOKENS and ep in ("identity", "gelu PWL f32", "exact gelu")
                     and (D == K_DIM or ep == "gelu PWL f32"))
            if timed:
                n_bp = 32 if "PWL" in ep else 0
                w1 = (1.0 + s).to(dtype)
                k_ms = time_ms(torch, lambda i: fused_rmsnorm(x, s, **kw))
                p_ms = time_ms(torch, lambda i: fused_rmsnorm_plain(x, s, plan, tables,
                                                                    NORM_EPS), reps=5, iters=4)
                l_ms = time_ms(torch, lambda i: Fn.rms_norm(x, (D,), weight=w1, eps=NORM_EPS))
                kb_ms = time_ms(torch, lambda i: fused_rmsnorm_bwd(x, s, g, kplan, ktables))
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
                line += (f"; forward kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
                         f"F.rms_norm {l_ms * 1e3:.2f} us, bound {r['fwd']['bound_ms'] * 1e3:.2f}"
                         f" us ({r['fwd']['bound_by']}); backward kernel {kb_ms * 1e3:.2f} us, "
                         f"plain {pb_ms * 1e3:.2f} us, autograd of F.rms_norm {lb_ms * 1e3:.2f} "
                         f"us, bound {r['bwd']['bound_ms'] * 1e3:.2f} us ({r['bwd']['bound_by']})")
            print(line)
    return rows


def norm_path(torch) -> dict:
    """The slice's own path, the op through its public entry point (no model
    calls it, in the JAX package or here): counters reset, one forward and
    one backward of ``fused_rmsnorm`` under autograd at repro-100m's
    training rows (bf16, the gelu table), counters read."""
    from repro_torch.kernels.fused import fused_rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(TRAIN_TOKENS, K_DIM, generator=gen, device=dev).to(torch.bfloat16)
    s = (torch.randn(K_DIM, generator=gen, device=dev) * 0.3).requires_grad_(True)
    xr = x.requires_grad_(True)
    reset_counters()
    y = fused_rmsnorm(xr, s, **_epilogue_kwargs("gelu PWL f32"))
    torch.cos(y.float()).sum().backward()
    torch.cuda.synchronize()
    counts = read_counters()
    check(bool(torch.isfinite(xr.grad.float()).all()) and bool(torch.isfinite(s.grad).all()),
          "fused_rmsnorm path: non-finite gradients")
    check(counts["fused_rmsnorm"] == 1 and counts["fused_rmsnorm_bwd"] == 1,
          f"fused_rmsnorm path: launches {counts}")
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


GEMMA_H, GEMMA_HKV, GEMMA_DH, GEMMA_WINDOW = 4, 1, 256, 512  # gemma3-1b's attention
GEMMA_SEQ = 2048


def dh256_phase(torch):
    """Head dim 256 at gemma3-1b's attention shape (H = 4, Hkv = 1, bf16):
    the flash forward and backward at B = 1, S = T = 2048, causal, once
    with its 512-token window and once without, against their plain
    versions (integer-grid inputs: the kernel's row max must equal the plain
    chain's bitwise; forward 1e-2, dq, dk, dv 1e-2 of each max), and at
    S = T = 700 in bf16 and f32 (1e-5, 1e-4); random normal bf16 inputs
    with and without the window, where every live row's raw tie count must
    be at least 1; the split-KV decode at dh 256 (bf16 1e-2, f32 1e-5).  Timed in bf16 against ``scaled_dot_product_attention`` over
    the K/V repeated to the 4 query heads (the repeat not timed)."""
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
             ("S=T=700 causal window 128", 700, torch.float32, 128, False)]
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
        glu = glu_phase(torch)
        moe = moe_phase(torch)
        kv = kv_phase(torch)
        sm = softmax_phase(torch)
        dec = decode_phase(torch)
        fl = flash_phase(torch)
        pwl = pwl_act_phase(torch)
        lin = linear_phase(torch)
        bf16_table_phase(torch)
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
            olmoe = ["--arch", "olmoe-1b-7b"]
            moe_counts = serve_phase(torch, olmoe, no_attention_kernels)
            serve_phase(torch, olmoe + ["--batch", "8", "--prompt-len", "256", "--max-new", "32"],
                        no_attention_kernels)
            moe_softmax_plan = dump_plan(pathlib.Path(tmp) / "olmoe_fused_softmax_plan.json",
                                         "olmoe-1b-7b")
            serve_phase(torch, olmoe + ["--plan", moe_softmax_plan], short_prompt_attention)
            mark("olmoe-1b-7b serve phases")
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
        reference_phase(torch)
        # the launches of each kernel on the path that runs it
        path_counts = {name: main_counts[name]
                       for name in ("fused_glu", "write_prompt_pages_", "append_kv_")}
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
            path_counts[name] = norm_counts[name]
        for name, n in exact_counts.items():
            if n:
                path_counts[f"{name} exact"] = n
        for name, n in d256_counts.items():
            if n:
                path_counts[f"{name} dh256"] = n
        for name, n in path_counts.items():
            check(n > 0, f"{name} never launched on its serving or training path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    g = glu[(4, torch.bfloat16)]
    kernels = [
        {"name": "fused_glu", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/glu.py:30",
         "shape": f"M=4 K={K_DIM} N={N_DIM} bf16 (decode step)",
         "launches": path_counts["fused_glu"], **g},
        {"name": "fused_moe_glu", "route": "cuda", "source": "src/repro_torch/csrc/glu.cu",
         "replaces": "src/repro/kernels/fused/moe.py:41",
         "shape": f"E={MOE_E} C=1 K={MOE_K} N={MOE_N} bf16 (olmoe-1b-7b decode step)",
         "launches": path_counts["fused_moe_glu"], **moe[1]},
        {"name": "write_prompt_pages_", "route": "cuda",
         "source": "src/repro_torch/csrc/kv_cache.cu",
         "replaces": "src/repro/serving/kv_cache.py:129",
         "shape": f"B=1 S=32 Hkv={HKV} dh={DH} bf16",
         "launches": path_counts["write_prompt_pages_"], **kv["write_prompt_pages_"]},
        {"name": "append_kv_", "route": "cuda", "source": "src/repro_torch/csrc/kv_cache.cu",
         "replaces": "src/repro/serving/kv_cache.py:212",
         "shape": f"B=4 Hkv={HKV} dh={DH} bf16",
         "launches": path_counts["append_kv_"], **kv["append_kv_"]},
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
        {"name": "pwl_activation_uniform", "route": "cuda",
         "source": "src/repro_torch/csrc/pwl_act.cu",
         "replaces": "src/repro/kernels/pwl_act.py:52",
         "shape": "32 x 384 f32, sigmoid 32 breakpoints (the paper's uniform baseline; on no "
                  "model path)",
         "launches": 0, **pwl["uniform 32 x 384 f32"]},
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
    # path), the exact and identity epilogues (launches of each wrapper in
    # the exact-epilogue path, both kinds together) and head dim 256
    norm_src, fused_src = "src/repro_torch/csrc/norm.cu", "src/repro/kernels/fused"
    for D, ep, tag in ((K_DIM, "gelu PWL f32", ""), (MOE_K, "gelu PWL f32", "[D=2048]"),
                       (K_DIM, "identity", "[identity]"), (K_DIM, "exact gelu", "[act=gelu]")):
        counts = norm_counts if ep == "gelu PWL f32" else exact_counts
        r = nrm[(f"{TRAIN_TOKENS} x {D} bf16", ep)]
        for bwd, line in ((False, 31), (True, 102)):
            suffix = "_bwd" if bwd else ""
            kernels.append({
                "name": f"fused_rmsnorm{suffix}{tag}", "route": "cuda", "source": norm_src,
                "replaces": f"{fused_src}/norm.py:{line}",
                "shape": f"M={TRAIN_TOKENS} D={D} bf16, {ep} (repro-100m's training rows; "
                         "olmoe's width at D=2048)",
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
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(f"[smoke] whisper-small train step {whisper_trained['step_ms']:.1f} ms median, "
          f"{whisper_trained['tokens_per_s']:.0f} target tokens/s")
    print(f"[smoke] train step {trained['step_ms']:.1f} ms median, "
          f"{trained['tokens_per_s']:.0f} tokens/s; long-context ({LONG_BATCH} x {LONG_SEQ}) "
          f"{long_trained['step_ms']:.1f} ms median, {long_trained['tokens_per_s']:.0f} tokens/s")
    print(f"[smoke] total {time.perf_counter() - t_start:.1f}s (build {build_s:.1f}s)")
    print(card_line())
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
