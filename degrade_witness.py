"""How far the guard's degraded re-run moves a step's logits at full width,
beside what rounding alone does there.

    python3 degrade_witness.py [--steps N]

For full-width repro-100m (site ``mlp:gelu_tanh``) and olmoe-1b-7b (site
``moe.expert:silu``), in bf16 and in f32, serves 4 requests (prompt 32, 16
new tokens, seed-0 weights, the fused plan) through ``PagedServingEngine``
and, at each of the first N decode steps, runs the same step on the same
state three more times before the step itself (each writes the rows the
step writes, and the step rewrites them):

* ``rung``: the degrade ladder's first rung, the site at ``impl="jnp"``
  (``models/layers.py:plain_glu``: the GLU in f32, rounded once);
* ``rounded``: the same with the GLU rounded to the model dtype after each
  operation (both products, the activation, the gating), as the JAX
  package's unfused path computes it;
* ``ulp``: the fused kernels with every element of the site's kernel output
  moved one ulp up or down at random.

It prints, a step, the fault-free top-2 logit margins and each variant's
largest logit change a row and the rows whose greedy token it changes;
then, for each variant run in place of decode step 2 of a whole session,
the first token of each request that differs from the fault-free
session's.  Needs a CUDA GPU; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SITES = {"repro-100m": "mlp:gelu_tanh", "olmoe-1b-7b": "moe.expert:silu"}
DEGRADE_STEP = 2


@contextlib.contextmanager
def rounded_glu(torch):
    """The unfused GLU rounded after each operation, as JAX computes it."""
    from repro_torch.models import layers, moe

    orig = layers.plain_glu

    def rounded(act, x, w_gate, w_up):
        return act(x @ w_gate) * (x @ w_up)

    layers.plain_glu = moe.plain_glu = rounded
    try:
        yield
    finally:
        layers.plain_glu = moe.plain_glu = orig


@contextlib.contextmanager
def one_ulp_off(torch, site: str, seed: int = 0):
    """Every element of the site's fused kernel output one ulp up or down."""
    from repro_torch.kernels import fused

    name = "fused_moe_glu" if site.startswith("moe.expert:") else "fused_glu"
    glu = getattr(fused, name)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(*a, **k):
        out = glu(*a, **k)
        bits = {2: torch.int16, 4: torch.int32}[out.element_size()]
        step = torch.randint(0, 2, out.shape, generator=gen, device=out.device,
                             dtype=bits).mul_(2).sub_(1)
        step = torch.where(out == 0, torch.ones_like(step), step)
        return (out.view(bits) + step).view(out.dtype)

    setattr(fused, name, noisy)
    try:
        yield
    finally:
        setattr(fused, name, glu)


def witness(torch, arch: str, dtype, steps: int) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import GenRequest, PagedServingEngine

    site = SITES[arch]
    cfg = get_config(arch, act_impl="fused", dtype=dtype)
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(4, 32),
                                                dtype=np.int64).astype(np.int32)

    def variant(eng, name):
        rung = eng._degraded_fns((site,), "jnp")["decode"]
        if name == "rung":
            return rung, contextlib.nullcontext()
        if name == "rounded":
            return rung, rounded_glu(torch)
        return eng._fns["decode"], one_ulp_off(torch, site)

    def session(replace=None):
        eng = PagedServingEngine(model, params, max_slots=4, page_size=16, max_context=64)
        exec_, log = eng._exec, {}

        def probe(phase, args):
            step = eng.decode_steps
            if phase != "decode":
                return exec_(phase, args)
            if replace is not None:
                if step != DEGRADE_STEP:
                    return exec_(phase, args)
                fn, ctx = variant(eng, replace)
                with ctx:
                    return fn(eng.params, *args)[0]
            alt = {}
            if step < steps:
                for name in ("rung", "rounded", "ulp"):
                    fn, ctx = variant(eng, name)
                    with ctx:
                        alt[name] = fn(eng.params, *args)[0][:, 0].float()
            logits = exec_(phase, args)
            if alt:
                rows = list(eng.sched.active_slots())
                lc = logits[rows, 0].float()
                top2 = torch.topk(lc, 2, dim=-1).values
                rec = {"margin": [round(float(v), 5) for v in top2[:, 0] - top2[:, 1]]}
                for name, v in alt.items():
                    lv = v[rows]
                    rec[name] = {"dmax": [round(float(d), 4) for d in (lv - lc).abs().amax(-1)],
                                 "flips": int((lv.argmax(-1) != lc.argmax(-1)).sum())}
                log[step] = rec
            return logits

        eng._exec = probe
        reqs = [GenRequest(request_id=f"req{i}", prompt=prompts[i].tolist(), max_new_tokens=16)
                for i in range(4)]
        return {r.request_id: list(r.tokens) for r in eng.run(reqs)}, log

    clean, log = session()
    out = {"steps": log, "sessions": {}}
    for name in ("rung", "rounded", "ulp"):
        toks, _ = session(name)
        out["sessions"][name] = {
            rid: next((i for i, (a, b) in enumerate(zip(toks[rid], want)) if a != b), None)
            for rid, want in clean.items()}
    del model, params
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("degrade_witness: no CUDA device", file=sys.stderr)
        return 2
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[witness] card: {card.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    _build.build(("glu", "kv_cache", "softmax", "decoding"))
    results = {}
    for arch in SITES:
        for dtype in (torch.bfloat16, torch.float32):
            t0 = time.perf_counter()
            key = f"{arch} {str(dtype).split('.')[-1]}"
            res = results[key] = witness(torch, arch, dtype, steps)
            for step, rec in res["steps"].items():
                print(f"[witness] {key} step {step}: {json.dumps(rec)}")
            for name, first in res["sessions"].items():
                print(f"[witness] {key}: decode step {DEGRADE_STEP} as {name}, the first "
                      f"token that differs from the fault-free session's: {first}")
            print(f"[witness] {key}: {time.perf_counter() - t0:.1f}s")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
