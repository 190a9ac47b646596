"""The traced run: ``torch.profiler`` (CPU and CUDA activity) over the
measured window, reduced to arrays that the per-layer metric readers
read, and the ``breakdown`` of the result line."""
from __future__ import annotations

import re
import time

import numpy as np
import torch

# the longest idle gaps are labelled one by one; the rest are summed as one
LABELLED_GAPS = 4000


class Tracer:
    def __init__(self):
        self.prof = None
        self.wall_s = 0.0

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """{"window_s", "busy_s", "dev_names", "dev_idx", "dev_start",
        "dev_dur" (seconds from the trace's start), "device_ops",
        "idle_gaps"}."""
        res = self.prof.profiler.kineto_results
        origin = res.trace_start_ns()
        window = self.wall_s
        dnames, didx, dstart, ddur = {}, [], [], []
        cnames, cidx, cstart, cend = {}, [], [], []
        for e in res.events():
            dt = e.device_type()
            if dt == torch.autograd.DeviceType.CUDA:
                didx.append(dnames.setdefault(e.name(), len(dnames)))
                dstart.append(e.start_ns() - origin)
                ddur.append(e.duration_ns())
            elif dt == torch.autograd.DeviceType.CPU:
                cidx.append(cnames.setdefault(e.name(), len(cnames)))
                cstart.append(e.start_ns() - origin)
                cend.append(e.start_ns() - origin + e.duration_ns())
        out = {"window_s": window, "dev_names": list(dnames), "dev_idx": np.asarray(didx, np.int64),
               "dev_start": np.asarray(dstart, np.float64) * 1e-9,
               "dev_dur": np.asarray(ddur, np.float64) * 1e-9}
        busy, gaps = _union(out["dev_start"], out["dev_dur"], window)
        out["busy_s"] = busy
        out["device_ops"] = _top_ops(out)
        out["idle_gaps"] = _label_gaps(gaps, list(cnames), np.asarray(cidx, np.int64),
                                       np.asarray(cstart, np.float64) * 1e-9,
                                       np.asarray(cend, np.float64) * 1e-9)
        return out


def _union(start: np.ndarray, dur: np.ndarray, window: float):
    """Seconds of [0, window] covered by device intervals, and the gaps
    between them (start, end)."""
    if start.size == 0:
        return 0.0, [(0.0, window)]
    order = np.argsort(start)
    s = np.clip(start[order], 0.0, window)
    e = np.clip(start[order] + dur[order], 0.0, window)
    run_end = np.maximum.accumulate(e)
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > run_end[:-1]
    seg_start = s[new]
    idx = np.flatnonzero(new)
    seg_end = np.append(run_end[idx[1:] - 1], run_end[-1])
    busy = float(np.sum(seg_end - seg_start))
    gaps = [(0.0, float(seg_start[0]))] if seg_start[0] > 0 else []
    gaps += list(zip(seg_end[:-1].tolist(), seg_start[1:].tolist()))
    if seg_end[-1] < window:
        gaps.append((float(seg_end[-1]), window))
    return busy, gaps


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    name = re.sub(r"\(.*$", "", name.replace("void ", "", 1)) or name
    return name[:width]


def _top_ops(tr: dict, n: int = 10) -> list:
    if not tr["dev_names"]:
        return []
    tot = np.bincount(tr["dev_idx"], weights=tr["dev_dur"], minlength=len(tr["dev_names"]))
    by = {}
    for i, t in enumerate(tot):
        key = short_name(tr["dev_names"][i])
        by[key] = by.get(key, 0.0) + float(t)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _label_gaps(gaps, names, idx, start, end, n: int = 10) -> list:
    """The idle time grouped by the innermost host operation running at
    each gap's middle ("host: no operator" where none runs)."""
    if not gaps:
        return []
    lengths = np.asarray([b - a for a, b in gaps])
    order = np.argsort(-lengths)
    by: dict[str, float] = {}
    o = np.argsort(start, kind="stable")
    st, en, ix = start[o], end[o], idx[o]
    for k in order[:LABELLED_GAPS]:
        a, b = gaps[k]
        mid = 0.5 * (a + b)
        j = int(np.searchsorted(st, mid, side="right")) - 1
        label = "host: no operator"
        for jj in range(j, max(j - 64, -1), -1):  # the latest-starting op that spans mid
            if en[jj] >= mid:
                label = names[ix[jj]]
                break
        by[label] = by.get(label, 0.0) + float(lengths[k])
    rest = float(lengths[order[LABELLED_GAPS:]].sum())
    if rest > 0:
        by["shorter gaps"] = by.get("shorter gaps", 0.0) + rest
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def family(tr: dict, pattern: str) -> tuple[np.ndarray, np.ndarray]:
    """(names, durations) of the device events whose name matches
    ``pattern`` (a regular expression)."""
    rx = re.compile(pattern)
    keep = np.asarray([bool(rx.search(nm)) for nm in tr["dev_names"]], bool)
    if keep.size == 0:
        return np.asarray([], object), np.asarray([], np.float64)
    sel = keep[tr["dev_idx"]]
    names = np.asarray(tr["dev_names"], object)[tr["dev_idx"][sel]]
    return names, tr["dev_dur"][sel]
