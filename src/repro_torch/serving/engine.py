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
``"preempted_unrecoverable"``.  Before each step the host mirrors go
through ``kv_cache.check_targets``, so a write outside the pools raises here
rather than being skipped on the card.

``guard=True`` runs every model call under an ``sfu.guard`` collector: the
per-site clamp / non-finite counters come back with every step (one
device-to-host copy a step), and a step whose fused output went non-finite
is re-run with the offending sites degraded to ``impl="jnp"`` (then
``"exact"``), each a model built once per (sites, impl); recorded in
:meth:`health_summary`, warned once per site.  ``faults`` (a
:class:`~repro_torch.serving.faults.FaultInjector`) threads deterministic
chaos through the same paths: allocator exhaustion, a NaN at a plan site,
an injected kernel failure (raised before the call, retried), a dropped
tick (a decode step's results discarded, the step run again).

The pools are written in place, where the JAX engine's jit hands each call
fresh ones.  A re-run (a retry, a degraded re-run, the step after a dropped
tick) has the same page table, ``kv_len`` and inactive lanes as the attempt
before it, so it writes exactly the rows that attempt wrote, and each layer
writes its row before it reads the pools: the re-run overwrites whatever
the failed attempt left there (a NaN-poisoned layer's K/V included) and
reads nothing else of it.  Each ``run()`` resets every warn-once latch
first (``sfu.reset_all_warnings``), so a second session in one process
reports its own fused fallbacks.

``rules`` (a :class:`repro_torch.distributed.sharding.Rules` with a
``DeviceMesh``) serves sharded, every rank of the mesh running the same
engine on the same requests: the parameters are placed by
``specs_for_params`` (a plain tree is placed here), the pools over their
KV heads (``kv_cache.pool_spec``; replicated over the data axes, every data
rank writing every request), and every model call runs under
``use_rules``, so the fused kernels run per shard; the logits come back
whole on every rank, which then sample alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import sfu
from repro_torch.distributed.sharding import use_rules

from .kv_cache import check_targets, place_pools
from .resilience import (
    RETRYABLE_EXCEPTIONS,
    PagePoolExhausted,
    RequestRejected,
    RetryPolicy,
    SimulatedKernelFailure,
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
        guard: bool = False,
        faults=None,  # repro_torch.serving.faults.FaultInjector
        max_preemptions: int = 8,
        retry: Optional[RetryPolicy] = None,
        wall_clock_budget_s: Optional[float] = None,
        rules=None,  # repro_torch.distributed.sharding.Rules: serve sharded
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
        self.rules = rules
        self.cache = model.make_paged_cache(num_pages, page_size)
        if rules is not None:
            from repro_torch.launch.steps import shard_params

            self.params = shard_params(model.cfg, params, rules)
            self.cache = place_pools(model.cfg, self.cache, rules)
        self.sched = ContinuousBatchingScheduler(
            max_slots, page_size, num_pages, policy=policy,
            max_preemptions=max_preemptions, faults=faults)
        # host mirrors: the scheduler mutates these between device steps
        self.page_table = np.zeros((max_slots, self.max_cols), np.int32)
        self.kv_len = np.zeros((max_slots,), np.int32)
        self._cur = np.zeros((max_slots,), np.int32)  # next decode input
        self.guard = bool(guard)
        self.faults = faults
        self.retry = retry if retry is not None else RetryPolicy()
        self.wall_clock_budget_s = wall_clock_budget_s
        self.health = new_health(policy, guard)
        self.health["nonfinite_logits"] = 0  # steps whose sampled logits were not finite
        self._fns = self._build_fns()
        self._nan_fns_cache: dict = {}
        self._degraded_cache: dict = {}
        self.prefills = 0
        self.decode_steps = 0
        self.generated = 0

    # -- model-call variants ------------------------------------------------
    def _build_fns(self, model=None, inject_site: Optional[str] = None):
        """Prefill/decode callables returning ``(logits, diag)``, ``diag``
        the ``sfu.guard`` per-site ``{key: int32[2]}`` counts on the host
        ({} when the guard is off).  ``model`` swaps the model (a degraded
        plan; by default ``self.model``, looked up at each call);
        ``inject_site`` arms the NaN fault for one site."""
        guard_on = self.guard

        def wrap(name):
            def call(params, toks, cache, pt, lens):
                fn = getattr(model if model is not None else self.model, name)
                with contextlib.ExitStack() as stack:
                    stack.enter_context(use_rules(self.rules))
                    if inject_site is not None:
                        stack.enter_context(sfu.guard.force_nan(inject_site))
                    col = stack.enter_context(sfu.guard.collecting()) if guard_on else None
                    logits = fn(params, toks, cache, pt, lens)
                return logits, (col.to_host() if col is not None else {})

            return call

        return {"prefill": wrap("prefill_paged"), "decode": wrap("decode_step_paged")}

    def _nan_fns(self, site: str):
        if site not in self._nan_fns_cache:
            self._nan_fns_cache[site] = self._build_fns(inject_site=site)
        return self._nan_fns_cache[site]

    def _degraded_fns(self, sites: tuple, impl: str):
        """The model with ``sites`` degraded to ``impl``, built once per
        (sites, impl).  "jnp" keeps the same PWL table unfused, and an MLP
        or MoE site computes its GLU as the fused kernel does, in f32
        rounded once (``layers.plain_glu``), so its hidden state is the
        kernel's but for the f32 summation order: one ulp apart in a few
        elements.  Whether greedy tokens hold then depends on the model: a
        full-width bf16 model at random init turns a one-ulp change of a
        site's output into logit changes of order 1 (``chip_smoke.py``'s
        ``guard_phase`` measures it).  "exact" is the last resort for a
        poisoned table."""
        key = (sites, impl)
        if key not in self._degraded_cache:
            base = sfu.plan_for(self.model.cfg)
            degraded = sfu.ActivationPlan(sites=tuple(
                (k, dataclasses.replace(s, impl=impl) if k in sites else s)
                for k, s in base.items()))
            model = type(self.model)(dataclasses.replace(self.model.cfg, act_plan=degraded),
                                     device=self.device)
            self._degraded_cache[key] = self._build_fns(model=model)
        return self._degraded_cache[key]

    # -- incident / diagnostics ----------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _incident(self, kind: str, **info) -> None:
        self.health["incidents"].append({"kind": kind, **info})

    def _scan_diag(self, diag: dict, accumulate: bool) -> list[str]:
        """Read a step's guard counters; returns the sites whose output went
        non-finite.  ``accumulate=False`` on degraded re-runs keeps the
        session counters meaning "observed on the primary path"."""
        bad = []
        for k, rec in diag.items():
            clamped, nonfinite = int(rec[0]), int(rec[1])
            if accumulate:
                self.health["clamped"][k] = self.health["clamped"].get(k, 0) + clamped
                self.health["nonfinite"][k] = self.health["nonfinite"].get(k, 0) + nonfinite
            if nonfinite > 0:
                bad.append(k)
        return sorted(bad)

    # -- device execution -----------------------------------------------------
    def _device_call(self, fn, args, phase: str):
        """One model call under the bounded retry policy.  Injected kernel
        failures (raised before the call, so nothing is written) retry with
        exponential backoff; exhausting the budget raises
        :class:`StepRetriesExhausted` for :meth:`decode_step` to contain."""
        attempt = 0
        while True:
            try:
                if (phase == "decode" and self.faults is not None
                        and self.faults.kernel_fail_due()):
                    raise SimulatedKernelFailure(
                        f"injected kernel failure at decode step {self.decode_steps}")
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

    def _exec(self, phase: str, args):
        """One prefill/decode step with fault injection and the guard's
        degrade ladder: a step whose guarded output went non-finite is run
        again with the offending sites at ``impl="jnp"``, then ``"exact"``
        (the re-run rewrites the rows the failed attempt wrote)."""
        nan_site = None
        if phase == "decode" and self.faults is not None:
            nan_site = self.faults.nan_site_due()
        fns = self._fns if nan_site is None else self._nan_fns(nan_site)
        if nan_site is not None:
            self._incident("nan_injected", site=nan_site, step=self.decode_steps)
        logits, diag = self._device_call(fns[phase], args, phase)
        bad = self._scan_diag(diag, accumulate=True)
        for impl in ("jnp", "exact"):
            if not bad:
                break
            for k in bad:
                sfu.guard.warn_nonfinite(k, impl)
            self._incident("nonfinite_output", phase=phase, sites=list(bad),
                           degraded_to=impl, step=self.decode_steps)
            dfns = self._degraded_fns(tuple(bad), impl)
            logits, diag = self._device_call(dfns[phase], args, phase)
            still = self._scan_diag(diag, accumulate=False)
            rec = self.health["nonfinite_recoveries"]
            for k in bad:
                if k not in still:
                    rec[k] = rec.get(k, 0) + 1
            bad = still
        if bad:
            self._incident("nonfinite_unrecovered", phase=phase, sites=list(bad),
                           step=self.decode_steps)
        return logits

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
        logits = self._exec("prefill", args)
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
        if self.faults is not None:
            self.faults.set_step(self.decode_steps)
        active = self._grow_with_preemption(self.sched.active_slots())
        if not active:
            return []
        width = max(len(self.sched.slot(i).pages) for i in active)
        n_cols = min(_next_pow2(width), self.max_cols)
        check_targets(self.page_table[:, :n_cols], self.num_pages, self.page_size, self.kv_len)
        args = (self._t(self._cur[:, None]), self.cache,
                self._t(self.page_table[:, :n_cols]), self._t(self.kv_len))
        try:
            logits = self._exec("decode", args)
        except StepRetriesExhausted as e:
            # the device step keeps failing: finish everything as
            # unrecoverable instead of ending the session
            self._incident("step_failed", step=self.decode_steps, error=str(e))
            for i in list(self.sched.active_slots()):
                self._evict(i, reason="preempted_unrecoverable")
            self.sched.drain_queue("preempted_unrecoverable")
            return []
        if self.faults is not None and self.faults.drop_tick_due():
            # a lost completion: discard the step's outputs and advance
            # nothing.  Its page writes stay in the pools, and the step run
            # again writes the same rows (same kv_len, same page table)
            self.health["dropped_ticks"] += 1
            self._incident("dropped_tick", step=self.decode_steps)
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
        # per-session warn lifecycle: a fused fallback (or a guard
        # degradation) is reported once per session, not once per process
        sfu.reset_all_warnings()
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
        h["clamped"] = dict(self.health["clamped"])
        h["nonfinite"] = dict(self.health["nonfinite"])
        h["nonfinite_recoveries"] = dict(self.health["nonfinite_recoveries"])
        h["incidents"] = list(self.health["incidents"])
        h["faults_fired"] = list(self.faults.fired) if self.faults is not None else []
        return h
