#!/usr/bin/env python3
"""Where a serving session of the torch port's time goes, on the GPU.

    python3 profile_serve.py [serve arguments]

A helper beside ``chip_smoke.py``, not part of the package.  Runs a warm-up
session of :mod:`repro_torch.launch.serve` (the same arguments, e.g.
``--arch olmoe-1b-7b``; a session in the dense loop too, asked for with
``--mode dense`` or taken by serve's fallback, as for ``--arch
mamba2-2.7b``), the same session again for its wall time, then
once more with ``torch.profiler`` (CPU and CUDA activity) recording the
engine's session alone, not the weights' random init before it, and prints:

* the kernels' summed device time against the session's wall time without
  the profiler (the same work), so the device's busy share is visible;
* the kernel launches of the session (``cudaLaunchKernel*`` and
  ``cuLaunchKernel*`` calls) per model call, and the sha256 of its tokens
  (request by request in id order), to hold two trees' sessions alike;
* the top operators by host (self CPU) time and by device time;
* the port's own kernels by name (the dense GLU's and the MoE experts'
  alike: ``glu_tc_kernel`` in bf16, ``glu_pwl_kernel`` in f32;
  ``page_write_kernel`` (the page writes, which rotate q and k), and
  under a plan with the softmax site fused ``softmax_narrow_kernel`` and
  ``softmax_wide_kernel`` (rows up to 1024 wide, and wider), the paged
  decode's ``split_kernel``, ``page_scores_kernel``, ``page_pv_kernel``,
  ``recurrence_kernel`` and ``merge_kernel``, ``flash_kernel``) with their
  call counts and mean device time.

It needs a CUDA GPU.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.launch import serve  # noqa: E402

TOP = 15  # rows per table


def _is_kernel(evt) -> bool:
    """A device-side event (a kernel or a memcpy), not a host operator; host
    operators also carry the device time of what they launched, so device
    totals sum kernel events only."""
    return str(evt.device_type).endswith("CUDA")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    args = serve.build_parser().parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_serve.py profiles a session on cuda")
    serve.run(args)  # warm-up: kernel builds, cuBLAS handles, allocator
    plain_wall = serve.run(args)["seconds"]  # the same session, no profiler
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    t0 = time.perf_counter()
    summary = serve.run(args, session=lambda: prof)  # the profiler on for the session only
    wall = time.perf_counter() - t0
    if summary["mode"] == "paged":
        calls = summary["prefills"] + summary["decode_steps"]
    else:  # the dense loop (asked for, or serve's fallback): one prefill, then the steps
        calls = 1 + args.max_new
    events = prof.key_averages()
    kernels = [e for e in events if _is_kernel(e)]
    device_total = sum(_device_us(e) for e in kernels)
    print(f"[profile] {calls} model calls; kernels busy {device_total / 1e3:.1f} ms; wall "
          f"{plain_wall * 1e3:.1f} ms without the profiler ({plain_wall * 1e3 / calls:.2f} "
          f"ms per call, device busy {100 * device_total / 1e6 / plain_wall:.1f}%), "
          f"{summary['seconds'] * 1e3:.1f} ms under it ({wall * 1e3:.1f} ms with the weights' "
          "init and the profiler's post-processing)")
    ops = [e for e in events if not _is_kernel(e)]
    launches = {e.key: e.count for e in ops
                if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    n_launch = sum(launches.values())
    print(f"[profile] launches {launches}: {n_launch} in all, {n_launch / calls:.0f} per model "
          "call")
    rows = (sorted((r.request_id, list(r.tokens)) for r in summary["results"])
            if summary["mode"] == "paged" else summary["results"])
    print(f"[profile] tokens sha256 {hashlib.sha256(json.dumps(rows).encode()).hexdigest()}")
    by_cpu = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP]
    print("[profile] top host operators by self CPU time: name | calls | self CPU ms | "
          "device ms of its kernels")
    for e in by_cpu:
        print(f"[profile]   {e.key[:60]} | {e.count} | {e.self_cpu_time_total / 1e3:.2f} | "
              f"{_device_us(e) / 1e3:.2f}")
    by_dev = sorted(kernels, key=_device_us, reverse=True)[:TOP]
    print("[profile] top kernels by device time: name | calls | device ms | mean us")
    for e in by_dev:
        d = _device_us(e)
        print(f"[profile]   {e.key[:60]} | {e.count} | {d / 1e3:.3f} | "
              f"{d / max(e.count, 1):.2f}")
    print("[profile] serving-path kernels: name | calls | mean device us")
    for frag in ("glu_pwl_kernel", "glu_tc_kernel", "page_write_kernel",
                 "softmax_narrow_kernel", "softmax_wide_kernel",
                 "split_kernel", "page_scores_kernel", "page_pv_kernel", "recurrence_kernel",
                 "merge_kernel", "flash_kernel"):
        hits = [e for e in kernels if frag in e.key]
        n = sum(e.count for e in hits)
        d = sum(_device_us(e) for e in hits)
        print(f"[profile]   {frag} | {n} | {d / max(n, 1):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
