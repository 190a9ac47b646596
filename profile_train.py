#!/usr/bin/env python3
"""Where a training step of the torch port's time goes, on the GPU.

    python3 profile_train.py [train arguments]

A helper beside ``chip_smoke.py``, not part of the package.  Builds the
train step :mod:`repro_torch.launch.train` would build from the same
arguments (full-width repro-100m at batch 8 x 512 by default; pass the
fused-softmax plan with ``--plan``, and ``--batch 1 --seq 4096`` for a
long-context step through the flash kernels), runs 3 warm-up steps, 10
steps timed with the host clock (each ended by reading the loss, which
waits for the device), then 3 steps under ``torch.profiler`` with CPU and
CUDA activity, and prints:

* the median step time and tokens/s without the profiler;
* the kernels' summed device time per profiled step against that step
  time, so the device's busy share is visible;
* the top kernels by device time, and the port's own kernels (the GLU's
  forward and backward, bf16 at M = 4096 on the tensor cores:
  ``glu_tc_kernel`` instantiated with ``ForwardEpi`` or ``BackwardEpi``;
  the row softmax's ``softmax_narrow_kernel`` and
  ``softmax_bwd_narrow_kernel`` (rows up to 1024 wide; wider rows
  ``softmax_wide_kernel`` and ``softmax_bwd_wide_kernel``); the flash
  forward ``flash_kernel`` and its backward ``flash_bwd_stats_kernel``,
  ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``) with calls per
  step, mean device time and their share of the step.

It needs a CUDA GPU.
"""
from __future__ import annotations

import pathlib
import re
import statistics
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.data.pipeline import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOP = 15  # rows of the kernel table
PORT_KERNELS = (  # (label, the kernel function's name, a fragment of its template arguments)
    ("glu_tc_kernel forward", "glu_tc_kernel", "ForwardEpi"),
    ("glu_tc_kernel backward", "glu_tc_kernel", "BackwardEpi"),
    ("softmax_narrow_kernel", "softmax_narrow_kernel", ""),
    ("softmax_bwd_narrow_kernel", "softmax_bwd_narrow_kernel", ""),
    ("softmax_wide_kernel", "softmax_wide_kernel", ""),
    ("softmax_bwd_wide_kernel", "softmax_bwd_wide_kernel", ""),
    ("flash_kernel", "flash_kernel", ""),
    ("flash_bwd_stats_kernel", "flash_bwd_stats_kernel", ""),
    ("flash_bwd_dq_kernel", "flash_bwd_dq_kernel", ""),
    ("flash_bwd_dkv_kernel", "flash_bwd_dkv_kernel", ""),
)
WARM, TIMED, PROFILED = 3, 10, 3


def _is_kernel(evt) -> bool:
    """A device-side event (a kernel or a memcpy), not a host operator."""
    return str(evt.device_type).endswith("CUDA")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernel_name(key: str) -> str:
    """``void (anonymous namespace)::softmax_narrow_kernel<16, true>(float
    const*, ...)`` -> ``softmax_narrow_kernel``: the function's own name."""
    m = re.search(r"::(\w+)\s*[<(]", key) or re.match(r"(?:void\s+)?(\w+)", key)
    return m.group(1) if m else key


def main(argv=None) -> int:
    args = train.build_parser().parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_train.py profiles the train step on cuda")
    device = train.resolve_device(args.device)
    cfg = train.resolve_config(args)
    # the launcher's in-place update: full-width mamba2-2.7b holds one state only
    step_fn = build_train_step(cfg, device, opt_cfg=adamw.AdamWConfig(lr=args.lr),
                               in_place=True)
    state = adamw.init_state(Model(cfg, device=device).init(seed=0, master=True))
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))
    batches = [{k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}
               for i in range(4)]

    def step(i):
        nonlocal state
        state, metrics = step_fn(state, batches[i % len(batches)])
        return float(metrics["loss"])  # waits for the step

    for i in range(WARM):
        step(i)
    secs = []
    for i in range(TIMED):
        t0 = time.perf_counter()
        step(i)
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    tokens = args.batch * args.seq
    print(f"[profile] {cfg.name} {cfg.n_layers} layers, batch {args.batch} x seq {args.seq}, "
          f"remat {cfg.remat}: median step {med * 1e3:.2f} ms over {TIMED} steps "
          f"(min {min(secs) * 1e3:.2f}, max {max(secs) * 1e3:.2f}), {tokens / med:.0f} tokens/s")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(PROFILED):
            step(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    per_step = sum(_device_us(e) for e in kernels) / PROFILED / 1e3
    print(f"[profile] kernels busy {per_step:.2f} ms per step, {100 * per_step / (med * 1e3):.1f}% "
          "of the median step without the profiler")
    print("[profile] top kernels by device time: name | calls per step | ms per step | mean us")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        d = _device_us(e)
        print(f"[profile]   {e.key[:70]} | {e.count / PROFILED:g} | {d / PROFILED / 1e3:.3f} | "
              f"{d / max(e.count, 1):.2f}")
    print("[profile] the port's kernels: name | calls per step | mean device us | "
          "ms per step | share of the step")
    for label, name, frag in PORT_KERNELS:
        hits = [e for e in kernels if _kernel_name(e.key) == name and frag in e.key]
        n = sum(e.count for e in hits)
        d = sum(_device_us(e) for e in hits) / 1e3 / PROFILED
        print(f"[profile]   {label} | {n / PROFILED:g} | {d * 1e3 * PROFILED / max(n, 1):.2f} | "
              f"{d:.3f} | {100 * d / (med * 1e3):.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
