"""Deterministic fault injection for chaos-testing the serving stack (torch
port of ``repro/serving/faults.py``, the same specs and firing rules).

A ``FaultInjector`` holds a list of seeded, composable ``FaultSpec``s and is
threaded through engine / scheduler / kv_cache.  Every fault is *armed* by a
decode-step index and fires on the first opportunity at or after that step
(allocators only allocate when a request crosses a page boundary, so exact
step matching would silently no-op; >= arming makes chaos sessions
reproducible without tuning step numbers to page geometry).

Fault kinds:

- ``alloc_exhaust``: the next page allocation raises ``PagePoolExhausted``.
  ``site`` optionally restricts the scope: ``"grow"`` only fails decode-time
  growth (guaranteeing a preemption under pressure), ``"admit"`` only fails
  admission, ``""`` fails whichever comes first.
- ``nan``: the fused output of plan site ``site`` (e.g. ``"mlp:gelu_tanh"``)
  has one element replaced with NaN for one decode step — the trigger for
  the ``sfu.guard`` degradation path.
- ``kernel_fail``: the device call for a decode step raises
  ``SimulatedKernelFailure`` (once per remaining count, so ``count=2``
  exercises two retries).
- ``drop_tick``: a decode step's results are discarded after the device call
  (simulating a lost completion); the engine must re-run the step with no
  state drift.

All firing is host-side and deterministic: same specs => same session.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional, Sequence

FAULT_KINDS = ("alloc_exhaust", "nan", "kernel_fail", "drop_tick")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault.

    kind: one of ``FAULT_KINDS``.
    step: decode-step index at which the fault arms (fires at the first
      opportunity at or after this step).
    site: plan-site key for ``nan``; allocation scope for ``alloc_exhaust``
      (``"grow"`` / ``"admit"`` / ``""`` = any).
    count: number of firings before the fault is spent.
    """

    kind: str
    step: int
    site: str = ""
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.count < 1:
            raise ValueError(f"fault count must be >= 1, got {self.count}")


class FaultInjector:
    """Deterministic, host-side fault scheduler consulted by the engine."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = tuple(specs)
        self._remaining = [s.count for s in self.specs]
        self._step = -1
        self.fired: list[dict] = []  # [{kind, site, armed_step, fired_step}]

    def set_step(self, step: int) -> None:
        """Called by the engine at the top of each decode step."""
        self._step = step

    def _consume(self, kind: str, scope: Optional[str] = None) -> Optional[FaultSpec]:
        for i, spec in enumerate(self.specs):
            if spec.kind != kind or self._remaining[i] <= 0:
                continue
            if self._step < spec.step:
                continue
            if scope is not None and spec.site not in ("", scope):
                continue
            self._remaining[i] -= 1
            self.fired.append({
                "kind": spec.kind,
                "site": spec.site,
                "armed_step": spec.step,
                "fired_step": self._step,
            })
            return spec
        return None

    def alloc_should_fail(self, scope: str = "") -> bool:
        return self._consume("alloc_exhaust", scope=scope) is not None

    def kernel_fail_due(self) -> bool:
        return self._consume("kernel_fail") is not None

    def drop_tick_due(self) -> bool:
        return self._consume("drop_tick") is not None

    def nan_site_due(self) -> Optional[str]:
        spec = self._consume("nan")
        return spec.site if spec is not None else None

    @property
    def exhausted(self) -> bool:
        return all(r == 0 for r in self._remaining)


def chaos_specs(seed: int, nan_site: str, max_step: int = 8) -> list[FaultSpec]:
    """The canned chaos mix used by ``launch/serve.py --chaos`` and CI.

    One grow-scoped allocator exhaustion plus one NaN injection at
    ``nan_site``.  The NaN arms at a seed-derived step inside
    ``[1, max_step)``; the alloc fault arms at step 1 or 2 because decode
    growth happens when a request crosses its first page boundary — early
    in its life — and a fault armed past every boundary crossing would
    never get an opportunity to fire.  The deadline-expiry leg of the
    chaos session is request-level (``GenRequest.deadline_ticks``) and
    lives in the caller.
    """
    rng = random.Random(seed)
    hi = max(2, max_step)
    alloc_step = rng.randrange(1, 3)
    nan_step = rng.randrange(1, hi)
    return [
        FaultSpec("alloc_exhaust", step=alloc_step, site="grow"),
        FaultSpec("nan", step=nan_step, site=nan_site),
    ]
