"""Continuous-batching scheduler: admit/evict/preempt between decode steps.

Static batching decodes a batch in lockstep until its *longest* request
finishes; every short request pads the batch with dead slots.  Continuous
batching (Orca/vLLM) re-decides the batch **between decode steps**: a
finished request releases its slot and pages immediately, and a queued
request is admitted into the free slot at the very next step — the decode
kernel never recompiles because the batch is a fixed array of
``max_slots`` slots and admission only rewrites one page-table row and
one ``kv_len`` entry.

The scheduler is pure host-side bookkeeping (queue, slots, page
accounting via :class:`~repro_torch.serving.kv_cache.PageAllocator`, token
lists, finish policy) and is the port's own copy of
``repro/serving/scheduler.py``.  Device work — page pools, prefill/decode,
bucketing — lives in :class:`repro_torch.serving.engine.PagedServingEngine`,
which drives the loop:

    admit() -> prefill admitted -> decode_step -> append_token per slot
    -> collect_finished() -> repeat while has_work()

Two admission policies:

- ``policy="reserved"`` (default): a request is admitted only when the pool
  can cover its prompt pages PLUS every page its ``max_new_tokens`` decode
  could ever grow into.  Reserved growth pages are not allocated up front
  (decode allocates them lazily at page boundaries); reserving the worst
  case keeps the lazy :meth:`grow` infallible, so a mid-decode request can
  never deadlock the pool.
- ``policy="optimistic"``: admit on *current* free pages only.  Throughput
  is higher at an oversubscribed page budget (the worst case rarely
  happens), but :meth:`grow` can now raise
  :class:`~repro_torch.serving.resilience.PagePoolExhausted`; the engine answers
  by **recompute preemption** — :meth:`preempt` evicts the youngest active
  request, requeues it with its generated-so-far tokens, and re-admission
  replays prefill over ``prompt + tokens[:-1]`` so the restored request
  continues with exact greedy-token parity.

Every request also carries an optional ``deadline_ticks`` budget; the
engine expires overdue work (queued or active) with
``finish_reason="timeout"`` between decode steps.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from .kv_cache import PageAllocator
from .resilience import (
    POLICIES,
    POLICY_RESERVED,
    PagePoolExhausted,
    RequestRejected,
)


@dataclasses.dataclass
class GenRequest:
    """One generation request as submitted.

    ``deadline_ticks``: optional decode-step budget measured from
    submission; overdue requests finish with ``finish_reason="timeout"``
    (whatever tokens were generated so far are returned)."""

    request_id: str
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    deadline_ticks: Optional[int] = None


@dataclasses.dataclass
class GenResult:
    """One finished request: the generated tokens plus scheduling telemetry."""

    request_id: str
    prompt: list[int]
    tokens: list[int]
    finish_reason: str          # one of resilience.FINISH_REASONS
    admitted_at_step: int       # decode-step index when (last) admitted;
                                # -1 if the request never reached a slot
    finished_at_step: int
    preemptions: int = 0        # times this request was preempted
    replayed_prefill_tokens: int = 0  # prefill tokens re-run due to restores


@dataclasses.dataclass
class _Queued:
    """Queue entry: a fresh request, or a preempted one awaiting restore."""

    request: GenRequest
    submitted_at_step: int
    resume_tokens: list[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    replayed_prefill_tokens: int = 0


@dataclasses.dataclass
class _Slot:
    request: GenRequest
    pages: list[int]            # physical pages held (logical order)
    kv_len: int = 0             # valid tokens in the paged cache
    tokens: Optional[list[int]] = None
    admitted_at_step: int = 0
    submitted_at_step: int = 0
    admit_seq: int = 0          # monotone admission counter (preemption
                                # victims are picked youngest-first by this)
    preemptions: int = 0
    replayed_prefill_tokens: int = 0

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = []


@dataclasses.dataclass
class Admission:
    """One admitted request, as handed to the engine for prefill.

    ``prefill_tokens`` is what the engine must actually prefill: the prompt
    for a fresh request, ``prompt + resume_tokens[:-1]`` for a restore (the
    last generated token's K/V is appended by the next decode step, exactly
    as it would have been without the preemption).  ``resume_tokens`` is
    empty for fresh admissions."""

    slot: int
    request: GenRequest
    pages: list[int]
    prefill_tokens: list[int]
    resume_tokens: list[int]


class ContinuousBatchingScheduler:
    def __init__(self, max_slots: int, page_size: int, num_pages: int,
                 policy: str = POLICY_RESERVED, max_preemptions: int = 8):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES}")
        self.max_slots = max_slots
        self.page_size = page_size
        self.policy = policy
        self.max_preemptions = max_preemptions
        self.allocator = PageAllocator(num_pages)
        self.queue: deque[_Queued] = deque()
        self.slots: list[Optional[_Slot]] = [None] * max_slots
        self.step = 0               # decode-step counter
        self._reserved = 0          # growth pages promised to admitted reqs
                                    # (reserved policy only; stays 0 otherwise)
        self._admit_seq = 0
        self._finished: list[GenResult] = []
        # session telemetry (surfaced in the engine health summary)
        self.preemption_count = 0
        self.replayed_prefill_tokens = 0
        self.timeout_count = 0

    # -- introspection -----------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def slot(self, i: int) -> _Slot:
        s = self.slots[i]
        assert s is not None, f"slot {i} is empty"
        return s

    # -- queue / admission -------------------------------------------------
    def submit(self, req: GenRequest) -> None:
        """Validate and enqueue.  Raises :class:`RequestRejected` (typed,
        with a machine-readable reason) for requests that could never be
        served — an unvalidated over-long request would either deadlock the
        FIFO head (reserved) or livelock preempting itself (optimistic)."""
        if not req.prompt:
            raise RequestRejected(req.request_id, "empty_prompt",
                                  "prompt is empty")
        if req.max_new_tokens <= 0:
            raise RequestRejected(
                req.request_id, "nonpositive_max_new_tokens",
                f"max_new_tokens={req.max_new_tokens}")
        if req.deadline_ticks is not None and req.deadline_ticks <= 0:
            raise RequestRejected(req.request_id, "nonpositive_deadline",
                                  f"deadline_ticks={req.deadline_ticks}")
        capacity = self.allocator.num_pages - 1  # page 0 is the sentinel
        worst = self._pages_for(len(req.prompt) + req.max_new_tokens)
        if worst > capacity:
            raise RequestRejected(
                req.request_id, "exceeds_page_capacity",
                f"needs up to {worst} pages "
                f"(prompt {len(req.prompt)} + max_new {req.max_new_tokens} "
                f"tokens at page_size {self.page_size}) but the pool only "
                f"has {capacity}")
        self.queue.append(_Queued(req, submitted_at_step=self.step))

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _worst(self, req: GenRequest) -> int:
        return self._pages_for(len(req.prompt) + req.max_new_tokens)

    def admit(self) -> list[Admission]:
        """Admit queued requests into free slots, FIFO, while the policy's
        page check passes.  Prompt pages are allocated here; under
        ``reserved`` the growth pages are additionally reserved.  FIFO
        head-of-line blocking is deliberate: skipping a big request to admit
        later small ones starves it forever under steady load."""
        out = []
        for i in range(self.max_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            item = self.queue[0]
            req = item.request
            prefill_tokens = list(req.prompt) + item.resume_tokens[:-1]
            prompt_pages = self._pages_for(len(prefill_tokens))
            if self.policy == POLICY_RESERVED:
                worst = self._worst(req)
                if worst > self.allocator.num_free - self._reserved:
                    break  # FIFO: wait for evictions rather than skip ahead
            else:
                if prompt_pages > self.allocator.num_free:
                    break
            try:
                pages = self.allocator.alloc(prompt_pages)
            except PagePoolExhausted:
                break  # retry at the next admission round
            self.queue.popleft()
            if self.policy == POLICY_RESERVED:
                self._reserved += self._worst(req) - prompt_pages
            self._admit_seq += 1
            slot = _Slot(
                request=req, pages=pages, kv_len=len(prefill_tokens),
                tokens=list(item.resume_tokens),
                admitted_at_step=self.step,
                submitted_at_step=item.submitted_at_step,
                admit_seq=self._admit_seq,
                preemptions=item.preemptions,
                replayed_prefill_tokens=item.replayed_prefill_tokens,
            )
            if item.resume_tokens:
                slot.replayed_prefill_tokens += len(prefill_tokens)
                self.replayed_prefill_tokens += len(prefill_tokens)
            self.slots[i] = slot
            out.append(Admission(
                slot=i, request=req, pages=pages,
                prefill_tokens=prefill_tokens,
                resume_tokens=list(item.resume_tokens),
            ))
        return out

    # -- decode-step bookkeeping --------------------------------------------
    def grow(self, i: int) -> Optional[int]:
        """Allocate the page the NEXT appended token needs, if the slot's
        current pages don't cover position ``kv_len``.  Under ``reserved``
        this draws down the request's reservation and cannot fail after
        admission; under ``optimistic`` it raises
        :class:`PagePoolExhausted` when the pool is dry — the engine's
        preemption trigger."""
        s = self.slot(i)
        if s.kv_len < len(s.pages) * self.page_size:
            return None
        page = self.allocator.alloc(1)[0]
        if self.policy == POLICY_RESERVED:
            self._reserved -= 1
        s.pages.append(page)
        return page

    def youngest_active(self) -> Optional[int]:
        """The preemption victim: the most recently admitted active slot.
        Evicting the youngest wastes the least completed work and keeps
        FIFO fairness (the preempted request re-enters at the queue head)."""
        act = self.active_slots()
        if not act:
            return None
        return max(act, key=lambda i: self.slot(i).admit_seq)

    def preempt(self, i: int) -> Optional[GenResult]:
        """Evict slot ``i`` and requeue it for restore (at the queue head —
        it was admitted before anything still queued was).  Returns None on
        a successful requeue; when the request has already burned
        ``max_preemptions`` restores it is finished with
        ``finish_reason="preempted_unrecoverable"`` instead and that result
        is returned."""
        s = self.slot(i)
        req = s.request
        if self.policy == POLICY_RESERVED:
            self._reserved -= self._worst(req) - len(s.pages)
        self.allocator.free(s.pages)
        self.slots[i] = None
        self.preemption_count += 1
        n_pre = s.preemptions + 1
        if n_pre > self.max_preemptions:
            res = GenResult(
                request_id=req.request_id, prompt=list(req.prompt),
                tokens=list(s.tokens),
                finish_reason="preempted_unrecoverable",
                admitted_at_step=s.admitted_at_step,
                finished_at_step=self.step, preemptions=n_pre,
                replayed_prefill_tokens=s.replayed_prefill_tokens,
            )
            self._finished.append(res)
            return res
        self.queue.appendleft(_Queued(
            request=req, submitted_at_step=s.submitted_at_step,
            resume_tokens=list(s.tokens), preemptions=n_pre,
            replayed_prefill_tokens=s.replayed_prefill_tokens,
        ))
        return None

    def tick(self) -> None:
        """Advance the decode-step counter."""
        self.step += 1

    # -- deadlines -----------------------------------------------------------
    def _overdue(self, req: GenRequest, submitted_at: int) -> bool:
        return (req.deadline_ticks is not None
                and self.step - submitted_at >= req.deadline_ticks)

    def expired_active(self) -> list[int]:
        """Active slots whose deadline has passed (engine evicts them with
        ``reason="timeout"``)."""
        return [i for i in self.active_slots()
                if self._overdue(self.slot(i).request,
                                 self.slot(i).submitted_at_step)]

    def expire_queued(self) -> list[GenResult]:
        """Finish queued (never-admitted or awaiting-restore) requests whose
        deadline has passed."""
        out = []
        keep: deque[_Queued] = deque()
        while self.queue:
            item = self.queue.popleft()
            if self._overdue(item.request, item.submitted_at_step):
                res = GenResult(
                    request_id=item.request.request_id,
                    prompt=list(item.request.prompt),
                    tokens=list(item.resume_tokens),
                    finish_reason="timeout",
                    admitted_at_step=-1 if not item.resume_tokens
                    else self.step,
                    finished_at_step=self.step,
                    preemptions=item.preemptions,
                    replayed_prefill_tokens=item.replayed_prefill_tokens,
                )
                self._finished.append(res)
                self.timeout_count += 1
                out.append(res)
            else:
                keep.append(item)
        self.queue = keep
        return out

    def drain_queue(self, reason: str) -> list[GenResult]:
        """Finish everything still queued with ``reason`` (wall-clock budget
        exhaustion, unrecoverable step failure)."""
        out = []
        while self.queue:
            item = self.queue.popleft()
            res = GenResult(
                request_id=item.request.request_id,
                prompt=list(item.request.prompt),
                tokens=list(item.resume_tokens), finish_reason=reason,
                admitted_at_step=-1, finished_at_step=self.step,
                preemptions=item.preemptions,
                replayed_prefill_tokens=item.replayed_prefill_tokens,
            )
            self._finished.append(res)
            if reason == "timeout":
                self.timeout_count += 1
            out.append(res)
        return out

    # -- token bookkeeping ----------------------------------------------------
    def _finished_by(self, s: _Slot, token: int) -> bool:
        req = s.request
        return (len(s.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id))

    def record_prefill_token(self, i: int, token: int) -> bool:
        """Record the token sampled from the PREFILL logits.  Its K/V is not
        in the cache yet (the next decode step appends it), so ``kv_len``
        does not move.  Returns True when the request is already finished
        (``max_new_tokens == 1`` or an immediate EOS).  Restore prefills
        never call this — their "prefill token" is the resumed
        ``tokens[-1]``, already recorded before the preemption."""
        s = self.slot(i)
        s.tokens.append(token)
        return self._finished_by(s, token)

    def append_token(self, i: int, token: int) -> bool:
        """Record one token sampled from a DECODE step.  That step appended
        the *previous* token's K/V at position ``kv_len``, so the valid
        length advances by one.  Returns True when the request just
        finished."""
        s = self.slot(i)
        s.kv_len += 1
        s.tokens.append(token)
        return self._finished_by(s, token)

    def evict(self, i: int, reason: Optional[str] = None) -> GenResult:
        """Release slot ``i``: free its pages, drop its remaining
        reservation, emit the result.  ``reason`` overrides the natural
        eos/length classification (the engine passes "timeout" /
        "preempted_unrecoverable")."""
        s = self.slot(i)
        req = s.request
        if self.policy == POLICY_RESERVED:
            self._reserved -= self._worst(req) - len(s.pages)
        self.allocator.free(s.pages)
        self.slots[i] = None
        if reason is None:
            reason = ("eos" if req.eos_id is not None and s.tokens
                      and s.tokens[-1] == req.eos_id
                      and len(s.tokens) < req.max_new_tokens else "length")
        if reason == "timeout":
            self.timeout_count += 1
        res = GenResult(
            request_id=req.request_id, prompt=list(req.prompt),
            tokens=list(s.tokens), finish_reason=reason,
            admitted_at_step=s.admitted_at_step, finished_at_step=self.step,
            preemptions=s.preemptions,
            replayed_prefill_tokens=s.replayed_prefill_tokens,
        )
        self._finished.append(res)
        return res

    def results(self) -> list[GenResult]:
        return list(self._finished)
