"""Straggler mitigation + step-time monitoring.

The torch port's copy of ``repro/distributed/monitor.py`` (pure Python in
both packages).  A step's time is the host clock around work that the
caller ends with a device synchronisation (the train launcher reads the
loss, which waits for the step).

On a 1000+-node fleet the common failure modes between hard crashes are slow
hosts (thermal throttle, failing HBM, network flap).  This monitor:

  * tracks a rolling step-time distribution and flags steps beyond
    `threshold` x median (straggler events),
  * exposes a per-host heartbeat file the cluster scheduler can watch
    (missing heartbeat => reschedule the host),
  * recommends action after `patience` consecutive straggler events —
    the launcher then checkpoints and exits non-zero so the scheduler
    replaces the node (checkpoint/restart makes this cheap).

Wall-clock decisions happen outside the step, so this composes with any step fn.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import time
from collections import deque
from typing import Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float


class StepMonitor:
    def __init__(
        self,
        window: int = 50,
        threshold: float = 2.0,
        patience: int = 5,
        heartbeat_path: Optional[str] = None,
    ):
        self.window = deque(maxlen=window)
        self.threshold = threshold
        self.patience = patience
        self.events: list[StragglerEvent] = []
        self._consecutive = 0
        self._t0 = None
        self.heartbeat_path = pathlib.Path(heartbeat_path) if heartbeat_path else None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> Optional[StragglerEvent]:
        dt = time.perf_counter() - self._t0
        self.heartbeat(step)
        if len(self.window) >= 10:
            med = statistics.median(self.window)
            if dt > self.threshold * med:
                ev = StragglerEvent(step=step, step_time=dt, median=med)
                self.events.append(ev)
                self._consecutive += 1
                self.window.append(dt)
                return ev
        self._consecutive = 0
        self.window.append(dt)
        return None

    @property
    def should_evict(self) -> bool:
        """True when this host has been persistently slow — the launcher
        checkpoints and exits so the scheduler can replace the node."""
        return self._consecutive >= self.patience

    def heartbeat(self, step: int):
        if self.heartbeat_path:
            self.heartbeat_path.write_text(
                json.dumps({"step": step, "time": time.time()})
            )

    def summary(self) -> dict:
        return {
            "steps": len(self.window),
            "median_s": statistics.median(self.window) if self.window else None,
            "stragglers": len(self.events),
        }
