"""Typed errors, finish reasons, and retry/health plumbing for serving.

The port's own copy of ``repro/serving/resilience.py`` (pure Python).  It is
the dependency leaf of ``repro_torch.serving``: it imports nothing from the
rest of the package, so ``kv_cache``, ``scheduler``, ``engine`` and
``models/transformer.py`` can all raise the same typed errors.

Design notes
------------
- ``PagePoolExhausted`` subclasses ``RuntimeError`` and keeps "exhausted" in
  its message so pre-existing callers (`pytest.raises(RuntimeError,
  match="exhausted")`) keep working.
- ``UnsupportedCacheError`` subclasses ``ValueError`` for the same reason
  (the old `make_paged_cache` rejection was a bare ValueError matched on
  "global-attention").
- ``RequestRejected`` carries a machine-readable ``reason`` from
  ``REJECTION_REASONS`` so front-ends (``launch/serve.py``) can surface the
  failure per-request without killing the session.
"""
from __future__ import annotations

import dataclasses

# Every GenResult.finish_reason is one of these.
FINISH_REASONS = ("length", "eos", "timeout", "preempted_unrecoverable")

# Scheduler admission policies.
POLICY_RESERVED = "reserved"
POLICY_OPTIMISTIC = "optimistic"
POLICIES = (POLICY_RESERVED, POLICY_OPTIMISTIC)

REJECTION_REASONS = (
    "empty_prompt",
    "nonpositive_max_new_tokens",
    "nonpositive_deadline",
    "exceeds_page_capacity",
)


class ServingError(Exception):
    """Base class for all typed serving errors."""


class RequestRejected(ServingError):
    """A request failed admission-time validation.

    Attributes:
      request_id: the id of the rejected request.
      reason: one of ``REJECTION_REASONS``.
    """

    def __init__(self, request_id: str, reason: str, message: str):
        assert reason in REJECTION_REASONS, reason
        super().__init__(f"request {request_id!r} rejected ({reason}): {message}")
        self.request_id = request_id
        self.reason = reason


class UnsupportedCacheError(ServingError, ValueError):
    """The model's layer stack cannot back a paged KV cache.

    Raised by ``models.transformer.make_paged_cache`` for sliding-window /
    SSM / encoder-decoder stacks.
    """


class PagePoolExhausted(ServingError, RuntimeError):
    """The page allocator cannot satisfy a request for free pages.

    Under ``policy="reserved"`` this only fires for genuinely invalid asks
    (or injected faults); under ``policy="optimistic"`` it is the normal
    back-pressure signal the engine answers with recompute preemption.
    """


class SimulatedKernelFailure(ServingError, RuntimeError):
    """A simulated (fault-injected) device-step failure."""


class StepRetriesExhausted(ServingError, RuntimeError):
    """A decode step kept failing after the bounded retry budget."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff around a failed decode step."""

    max_retries: int = 2
    backoff_s: float = 0.02

    def backoff(self, attempt: int) -> float:
        return self.backoff_s * (2.0 ** attempt)


# Exceptions the engine treats as transient and retries with backoff.
# Real device-runtime errors (a CUDA launch failure is a RuntimeError, but so
# are many programming errors) are deliberately NOT auto-retried.
RETRYABLE_EXCEPTIONS = (SimulatedKernelFailure,)


def new_health(policy: str, guard: bool) -> dict:
    """The engine health-summary skeleton."""
    return {
        "policy": policy,
        "guard": bool(guard),
        "preemptions": 0,
        "replayed_prefill_tokens": 0,
        "timeouts": 0,
        "rejected": [],            # [{request_id, reason, message}]
        "step_retries": 0,
        "dropped_ticks": 0,
        "clamped": {},             # site key -> inputs outside fitted range
        "nonfinite": {},           # site key -> non-finite outputs observed
        "nonfinite_recoveries": {},  # site key -> degraded re-runs that healed it
        "incidents": [],           # [{kind, step, ...}] chronological
        "faults_fired": [],        # injector log, [] when no injector
    }
