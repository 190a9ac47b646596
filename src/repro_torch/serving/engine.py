"""PagedServingEngine (torch): the device half of the serving stack.

Counterpart of ``repro/serving/engine.py``.  Owns the page pools (on the
model's device), the host page-table / kv_len mirrors, and drives
:class:`~repro_torch.serving.scheduler.ContinuousBatchingScheduler` through
admit -> prefill -> decode -> evict.  The same shape disciplines as the JAX
engine keep the work per step fixed:

* **bucketed prefill** — prompts run one at a time (B=1), padded to the
  next power-of-two multiple of the page size.  Pad positions write into
  the sentinel page and are never attended.
* **fixed-shape decode** — every decode step runs all ``max_slots`` slots;
  only the page-table width varies, bucketed to the next power of two over
  the widest live request.  Inactive slots are an all-sentinel table row
  with ``kv_len == 0``.

Resilience: ``policy="optimistic"`` admits on current free pages and
preempts the youngest active request when the pool runs dry (the restore
replays prefill over ``prompt + tokens[:-1]``, so greedy tokens are
unchanged); ``GenRequest.deadline_ticks`` and ``wall_clock_budget_s`` expire
overdue work; a step that raises a retryable error is retried with bounded
backoff, and a step that keeps failing finishes the live work as
``"preempted_unrecoverable"``.  The page writes are in place, so a retried
step writes the same rows again (the same token's K/V at the same slot).
Before each step the host mirrors go through ``kv_cache.check_targets``, so
a write outside the pools raises here rather than being skipped on the card.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from .kv_cache import check_targets
from .resilience import (
    RETRYABLE_EXCEPTIONS,
    PagePoolExhausted,
    RequestRejected,
    RetryPolicy,
    StepRetriesExhausted,
    new_health,
)
from .scheduler import Admission, ContinuousBatchingScheduler, GenRequest, GenResult


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class PagedServingEngine:
    def __init__(
        self,
        model,
        params,
        *,
        max_slots: int = 8,
        page_size: int = 16,
        max_context: int = 512,
        num_pages: Optional[int] = None,
        policy: str = "reserved",
        max_preemptions: int = 8,
        retry: Optional[RetryPolicy] = None,
        wall_clock_budget_s: Optional[float] = None,
    ):
        if page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        self.model = model
        self.params = params
        self.device = model.device
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_cols = -(-max_context // page_size)
        if num_pages is None:
            # worst case: every slot at max_context, plus the sentinel
            num_pages = max_slots * self.max_cols + 1
        self.num_pages = num_pages
        self.cache = model.make_paged_cache(num_pages, page_size)
        self.sched = ContinuousBatchingScheduler(
            max_slots, page_size, num_pages, policy=policy,
            max_preemptions=max_preemptions)
        # host mirrors: the scheduler mutates these between device steps
        self.page_table = np.zeros((max_slots, self.max_cols), np.int32)
        self.kv_len = np.zeros((max_slots,), np.int32)
        self._cur = np.zeros((max_slots,), np.int32)  # next decode input
        self.retry = retry if retry is not None else RetryPolicy()
        self.wall_clock_budget_s = wall_clock_budget_s
        self.health = new_health(policy, False)
        self.health["nonfinite_logits"] = 0  # steps whose sampled logits were not finite
        self.prefills = 0
        self.decode_steps = 0
        self.generated = 0

    # -- device execution -----------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _incident(self, kind: str, **info) -> None:
        self.health["incidents"].append({"kind": kind, **info})

    def _device_call(self, fn, args, phase: str):
        """One model call under the bounded retry policy."""
        attempt = 0
        while True:
            try:
                return fn(self.params, *args)
            except RETRYABLE_EXCEPTIONS as e:
                if attempt >= self.retry.max_retries:
                    raise StepRetriesExhausted(
                        f"{phase} step failed after {attempt + 1} attempts: {e}") from e
                self.health["step_retries"] += 1
                self._incident("step_retry", phase=phase, attempt=attempt,
                               step=self.decode_steps, error=str(e))
                time.sleep(self.retry.backoff(attempt))
                attempt += 1

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy tokens of (B, 1, V) logits; counts non-finite steps."""
        lf = logits[:, 0]
        tok, finite = lf.argmax(dim=-1), torch.isfinite(lf).all()
        if not bool(finite):
            self.health["nonfinite_logits"] += 1
        return tok.to(torch.int32).cpu().numpy()

    # -- internals ----------------------------------------------------------
    def _prefill(self, adm: Admission) -> bool:
        """Write the page-table row, run bucketed prefill, sample the first
        token (fresh requests) or resume the pre-preemption token (restores).
        Returns True when the request finished AT prefill."""
        slot = adm.slot
        toks_list = adm.prefill_tokens
        n = len(toks_list)
        bucket = max(self.page_size, _next_pow2(n))
        npg = bucket // self.page_size
        row = np.zeros((self.max_cols,), np.int32)
        row[: len(adm.pages)] = adm.pages
        self.page_table[slot] = row
        self.kv_len[slot] = n
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = toks_list
        check_targets(row[None, :npg], self.num_pages, self.page_size)
        args = (self._t(toks), self.cache, self._t(row[None, :npg]),
                self._t(np.asarray([n], np.int32)))
        logits = self._device_call(self.model.prefill_paged, args, "prefill")
        self.prefills += 1
        if adm.resume_tokens:
            # restore after preemption: the replayed prefill only rebuilds the
            # K/V pages; its sampled token IS resume_tokens[-1]
            self._cur[slot] = adm.resume_tokens[-1]
            return False
        tok = int(self._sample(logits)[0])
        self._cur[slot] = tok
        self.generated += 1
        if self.sched.record_prefill_token(slot, tok):
            self._evict(slot)
            return True
        return False

    def _evict(self, slot: int, reason: Optional[str] = None) -> GenResult:
        res = self.sched.evict(slot, reason=reason)
        self.page_table[slot] = 0
        self.kv_len[slot] = 0
        self._cur[slot] = 0
        return res

    def _preempt(self, i: int) -> None:
        rid = self.sched.slot(i).request.request_id
        res = self.sched.preempt(i)
        self.page_table[i] = 0
        self.kv_len[i] = 0
        self._cur[i] = 0
        self._incident("preemption", slot=i, request_id=rid, step=self.decode_steps,
                       unrecoverable=res is not None)

    def _grow_with_preemption(self, active: list[int]) -> list[int]:
        """Allocate boundary pages for this step; under pressure, preempt the
        youngest active request until the allocation succeeds."""
        for i in active:
            while self.sched.slots[i] is not None:
                try:
                    page = self.sched.grow(i)
                except PagePoolExhausted:
                    self._preempt(self.sched.youngest_active())
                    continue
                if page is not None:
                    self.page_table[i, len(self.sched.slot(i).pages) - 1] = page
                break
        return [i for i in active if self.sched.slots[i] is not None]

    def decode_step(self) -> list[int]:
        """One batched decode step over every slot.  Returns the slots that
        finished this step."""
        active = self._grow_with_preemption(self.sched.active_slots())
        if not active:
            return []
        width = max(len(self.sched.slot(i).pages) for i in active)
        n_cols = min(_next_pow2(width), self.max_cols)
        check_targets(self.page_table[:, :n_cols], self.num_pages, self.page_size, self.kv_len)
        args = (self._t(self._cur[:, None]), self.cache,
                self._t(self.page_table[:, :n_cols]), self._t(self.kv_len))
        try:
            logits = self._device_call(self.model.decode_step_paged, args, "decode")
        except StepRetriesExhausted as e:
            self._incident("step_failed", step=self.decode_steps, error=str(e))
            for i in list(self.sched.active_slots()):
                self._evict(i, reason="preempted_unrecoverable")
            self.sched.drain_queue("preempted_unrecoverable")
            return []
        nxt = self._sample(logits)
        self.sched.tick()
        self.decode_steps += 1
        finished = []
        for i in active:
            done = self.sched.append_token(i, int(nxt[i]))
            self.kv_len[i] += 1
            self._cur[i] = nxt[i]
            self.generated += 1
            if done:
                self._evict(i)
                finished.append(i)
        return finished

    def _expire_deadlines(self) -> None:
        for i in self.sched.expired_active():
            rid = self.sched.slot(i).request.request_id
            self._evict(i, reason="timeout")
            self._incident("deadline_expired", request_id=rid, where="active",
                           step=self.decode_steps)
        for res in self.sched.expire_queued():
            self._incident("deadline_expired", request_id=res.request_id,
                           where="queued", step=self.decode_steps)

    # -- public loop ---------------------------------------------------------
    def run(self, requests: list[GenRequest],
            on_result: Optional[Callable[[GenResult], None]] = None) -> list[GenResult]:
        """Serve ``requests`` to completion under continuous batching; results
        in finish order.  Invalid requests are rejected up front (recorded in
        the health summary) without ending the session."""
        t0 = time.monotonic()
        for r in requests:
            try:
                self.sched.submit(r)
            except RequestRejected as e:
                rec = {"request_id": e.request_id, "reason": e.reason, "message": str(e)}
                self.health["rejected"].append(rec)
                self._incident("request_rejected", **rec)
        n_before = len(self.sched.results())
        while self.sched.has_work():
            if (self.wall_clock_budget_s is not None
                    and time.monotonic() - t0 > self.wall_clock_budget_s):
                self._incident("wall_clock_budget_exhausted",
                               budget_s=self.wall_clock_budget_s, step=self.decode_steps)
                for i in list(self.sched.active_slots()):
                    self._evict(i, reason="timeout")
                self.sched.drain_queue("timeout")
            else:
                self._expire_deadlines()
                for adm in self.sched.admit():
                    self._prefill(adm)
                if self.sched.active_slots():
                    self.decode_step()
            if on_result is not None:
                for res in self.sched.results()[n_before:]:
                    on_result(res)
                n_before = len(self.sched.results())
        return self.sched.results()

    def health_summary(self) -> dict:
        """Session health; scheduler-owned counters are read live."""
        h = dict(self.health)
        h["preemptions"] = self.sched.preemption_count
        h["replayed_prefill_tokens"] = self.sched.replayed_prefill_tokens
        h["timeouts"] = self.sched.timeout_count
        h["rejected"] = list(self.health["rejected"])
        h["incidents"] = list(self.health["incidents"])
        return h
