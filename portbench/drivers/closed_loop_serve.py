"""A closed loop of clients against the port's paged serving engine.

Set-up makes the weights from the seed, builds ``PagedServingEngine`` and
runs the loop until every client's first request (of residual length, see
``traffic.ClosedLoop``) has finished: the loop is then in its steady state
and every shape the window uses has run.  The window is the rest of the
same ``engine.run`` call, whose ``on_result`` callback submits each
client's next request through ``engine.sched.submit``; the window ends when
a result comes in past ``--seconds``, by leaving the loop (no drain).

Afterwards the peak memory is read, the engine is freed, and the plain
reference runs once over a sample of the requests finished in the window
(the longest and others drawn from the seed): each served token's gap
below the reference's best logit at its position.  With ``control``, the
same check also reads the float8 control on the same sample
(``portbench/control.py``).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import program, reference, traffic, weights
from portbench.tracing import Tracer


class _WindowClosed(Exception):
    pass


def _counters(engine) -> dict:
    return {"prefills": engine.prefills, "decode_steps": engine.decode_steps,
            "generated": engine.generated}


def run(cell, control: dict | None = None) -> dict:
    from repro_torch.models import Model
    from repro_torch.serving import GenRequest, PagedServingEngine

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    mcfg = program.model_config(cell)
    params = weights.make(cfg, cell.seed, dev)
    program.check_layout(mcfg, params)
    eng = tr["engine"]
    engine = PagedServingEngine(Model(mcfg, device=dev), params, max_slots=eng["max_slots"],
                                page_size=eng["page_size"], max_context=eng["max_context"],
                                policy=eng["policy"])
    loop = traffic.ClosedLoop(tr, cell.seed, cfg["vocab_size"])
    meta, submitted = {}, {}
    first = []
    for c in range(loop.clients):
        r = loop.take(c)
        meta[r["id"]] = r
        first.append(GenRequest(r["id"], r["prompt"], r["max_new_tokens"]))
    pending_first = {r.request_id for r in first}
    st = {"phase": "warm"}
    done = []
    tracer = Tracer() if cell.trace else None

    def on_result(res):
        now = time.perf_counter()
        if st["phase"] == "window":
            r = meta[res.request_id]
            done.append({"id": res.request_id, "latency_s": now - submitted[res.request_id],
                         "prompt": r["prompt"], "tokens": list(res.tokens),
                         "reason": res.finish_reason})
            if now - st["t0"] >= cell.seconds:
                st["t1"] = now
                st["c1"] = _counters(engine)
                if tracer is not None:
                    tracer.stop()
                raise _WindowClosed
        pending_first.discard(res.request_id)
        if st["phase"] == "warm" and not pending_first:
            if tracer is not None:
                tracer.start()
            st.update(phase="window", t0=time.perf_counter(), c0=_counters(engine))
        nxt = loop.take(meta[res.request_id]["client"])
        meta[nxt["id"]] = nxt
        submitted[nxt["id"]] = time.perf_counter()
        engine.sched.submit(GenRequest(nxt["id"], nxt["prompt"], nxt["max_new_tokens"]))

    t_first = time.perf_counter()
    for r in first:
        submitted[r.request_id] = t_first
    try:
        engine.run(first, on_result=on_result)
    except _WindowClosed:
        pass
    if "t1" not in st:
        raise RuntimeError("the loop ran dry before the window closed")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    window_s = st["t1"] - st["t0"]
    c0, c1 = st["c0"], st["c1"]
    delta = {k: c1[k] - c0[k] for k in c0}
    ok = [d for d in done if d["reason"] == "length"]
    fam = reference.family(cfg)
    model_flops = sum(fam.request_flops(cfg, len(d["prompt"]), len(d["tokens"])) for d in done)

    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(cell, params, ok, control)
    print(f"[portbench] set-up {st['t0'] - cell.t_start:.1f} s, window {window_s:.1f} s, "
          f"{len(done)} requests, {delta['prefills']} prefills, {delta['decode_steps']} decode "
          f"steps; reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return {
        "setup_s": st["t0"] - cell.t_start,
        "window_s": window_s,
        "attempted": len(done),
        "failed": len(done) - len(ok),
        "generated": delta["generated"],
        "latencies_s": [d["latency_s"] for d in done],
        "counters": delta,
        "flops": model_flops,
        "peak_bytes": peak,
        "checks": checks,
        "trace": tracer.reduce() if tracer is not None else None,
    }


def sample(cell, finished: list) -> list:
    """The requests the reference checks: the one with the most positions
    and others drawn from the seed, ``check.sample_requests`` in all."""
    n = int(cell.traffic["check"]["sample_requests"])
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i]["prompt"]) + len(finished[i]["tokens"])))
    pick = [order[0]]
    rest = np.random.default_rng([cell.seed, 0xC4EC]).permutation(order[1:])
    pick += [int(i) for i in rest[: n - 1]]
    return [finished[i] for i in pick]


def served_gaps(ref_logits: list, seqs: list, picks: list | None = None) -> list[torch.Tensor]:
    """Per sequence, each served position's gap: the reference's best logit
    less its logit of the token served there (``picks`` replaces the
    served tokens, for the control's first choices)."""
    out = []
    for i, (lg, (_, toks)) in enumerate(zip(ref_logits, seqs)):
        tok = torch.as_tensor(picks[i] if picks is not None else toks, device=lg.device,
                              dtype=torch.long)
        out.append(lg.amax(dim=-1) - lg.gather(1, tok[:, None])[:, 0])
    return out


def gap_numbers(gaps: list) -> dict:
    """The numbers a sample's gaps give: the widest, and the mean over
    every served position of the sample."""
    return {"served_gap_max": max(float(g.max()) for g in gaps),
            "served_gap_mean": float(torch.cat(gaps).mean())}


def check(cell, params, finished: list, control: dict | None = None) -> dict:
    """The served tokens' gaps below the reference's best logit, each
    number that the cell's limits name beside its limit; the others are
    printed and not compared.  With ``control``, it also records there the
    program's and the float8 control's numbers on the same sample: the
    control's gap at a position is that of the token the float8 reference
    puts first there."""
    seqs = [(d["prompt"], d["tokens"]) for d in sample(cell, finished)]
    if not seqs:
        return {k: {"value": float("inf"), "limit": float(v)} for k, v in cell.limits.items()}
    fam = reference.family(cell.config)
    logits = fam.served_logits(cell.config, cell.tables, params, seqs, cell.device)
    gaps = served_gaps(logits, seqs)
    got = gap_numbers(gaps)
    for (p, t), g in zip(seqs, gaps):
        print(f"[portbench] request of {len(p)} + {len(t)} tokens: widest gap {float(g.max())!r} "
              f"at served token {int(g.argmax())}, mean {float(g.mean())!r}", file=sys.stderr)
    if control is not None:
        low = fam.served_logits(cell.config, cell.tables, params, seqs, cell.device,
                                precision="fp8")
        picks = [lg.argmax(dim=-1).tolist() for lg in low]
        control.update(program=got, control=gap_numbers(served_gaps(logits, seqs, picks)),
                       tokens_checked=sum(len(t) for _, t in seqs))
    for k, v in got.items():
        if k not in cell.limits:
            print(f"[portbench] {k} {v!r} (not compared)", file=sys.stderr)
    return {k: {"value": v, "limit": float(cell.limits[k])} for k, v in got.items()
            if k in cell.limits}
