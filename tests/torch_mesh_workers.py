"""Rank functions of the port's mesh tests (``tests/torch_mesh_utils.py``
runs them, one process per rank, on a gloo process group).  Each builds
the (data=2, model=2) mesh on the CPU and returns plain values that the
tests assert on; the single-process references are computed in the same
process, with no rules active."""
import contextlib
import dataclasses
import functools
import json
import warnings

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import sfu, tree
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import fused
from repro_torch.launch import steps
from repro_torch.models import Model, ShapeCell
from repro_torch.optim import adamw

FUSED = ("fused_glu", "fused_linear", "fused_moe_glu", "fused_pwl_softmax",
         "fused_flash_attention", "paged_flash_decode")


def _mesh():
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


CALLS: list = []


def _record_fused():
    """Wrap the fused wrappers the model calls (``kernels.fused.<name>``)
    once: each call appends to ``CALLS`` its name, whether every tensor
    operand is a plain tensor, and their shapes."""
    if getattr(fused, "_recorded", False):
        return
    fused._recorded = True

    def wrap(name, fn):
        def call(*args, **kw):
            ts = [a for a in list(args) + list(kw.values()) if torch.is_tensor(a)]
            CALLS.append((name, all(type(t) is torch.Tensor for t in ts),
                          [tuple(t.shape) for t in ts]))
            return fn(*args, **kw)
        return call
    for name in FUSED:
        setattr(fused, name, wrap(name, getattr(fused, name)))


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
           "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def _whole(t):
    return t.full_tensor() if sh.is_dtensor(t) else t


def _placed_as_specs(cfg, rules, tree_):
    specs = steps._spec_leaves(steps.param_specs(cfg, rules))
    return all(list(t.placements) == sh.placements(rules.mesh, s)
               for t, s in zip(tree.leaves(tree_), specs, strict=True))


def train_parity(rank, world, arch, overrides, B="4", S="32"):
    return _train_case(_mesh(), arch, json.loads(overrides), int(B), int(S))


def _grads_f64(cfg, state, batch):
    """The single-process gradients in f64 (whisper's yardstick)."""
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    st = adamw.init_state(tree.unflatten(state["params"],
                                         [p.double() for p in tree.leaves(state["params"])]))
    b = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
    return steps.build_train_step(cfg64, "cpu").grads(st, b)[2]


def _train_case(mesh, arch, over, B, S, microbatches=1):
    """One reduced config's loss and every gradient leaf on the 2x2 mesh
    against the single-process step; placements before and after a step;
    the fused calls' operands; fused-fallback warnings."""
    cfg = get_reduced_config(arch, dtype=torch.float32, **over)
    cell = ShapeCell("t", S, B, "train")
    model = Model(cfg, device="cpu")
    batch = _batch(cfg, B, S, 1)
    state = adamw.init_state(model.init(seed=0, master=True))

    ref_step = steps.build_train_step(cfg, "cpu", microbatches=microbatches)
    if cfg.n_experts:
        # an MoE layer's capacity and aux loss are per data shard (JAX's
        # _moe_layer_shardmap): the reference is the mean over the two data
        # shards of the single-process step on each shard's rows
        halves = [ref_step.grads(state, {k: v[i * B // 2:(i + 1) * B // 2]
                                         for k, v in batch.items()}) for i in range(2)]
        ref_loss = (halves[0][0] + halves[1][0]) / 2
        ref_grads = tree.unflatten(halves[0][2], [
            (a + b) / 2 for a, b in zip(tree.leaves(halves[0][2]), tree.leaves(halves[1][2]))])
    else:
        ref_loss, _, ref_grads = ref_step.grads(state, batch)

    # the single-process step's own gap to its f64 run: the yardstick of a
    # model that amplifies f32 rounding (reduced whisper)
    yard = [0.0] * len(tree.leaves(ref_grads))
    if cfg.is_encoder_decoder:
        yard = [float((a.double() - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(tree.leaves(ref_grads), tree.leaves(_grads_f64(cfg, state, batch)))]

    step = steps.build_train_step(cfg, "cpu", mesh=mesh, cell=cell, in_place=True,
                                  microbatches=microbatches)
    rules = step.rules
    sstate = steps.shard_state(cfg, state, rules)
    placed_before = (_placed_as_specs(cfg, rules, sstate["params"])
                     and _placed_as_specs(cfg, rules, sstate["mu"])
                     and _placed_as_specs(cfg, rules, sstate["nu"]))
    _record_fused()
    CALLS.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        loss, _, grads = step.grads(sstate, batch)
        grads_whole = [_whole(g) for g in tree.leaves(grads)]
        grad_placed = _placed_as_specs(cfg, rules, grads)
        sstate, metrics = step(sstate, batch)
    fallbacks = [str(w.message) for w in rec if "falling back" in str(w.message)]
    placed_after = (_placed_as_specs(cfg, rules, sstate["params"])
                    and _placed_as_specs(cfg, rules, sstate["mu"])
                    and _placed_as_specs(cfg, rules, sstate["nu"]))
    errs = []
    for (path, g_ref), g in zip(tree.flatten_with_paths(ref_grads), grads_whole, strict=True):
        if g_ref.numel() == 0:  # mamba2's (D, 0) FFN
            errs.append((path, 0.0 if g.shape == g_ref.shape else float("inf")))
            continue
        scale = max(float(g_ref.abs().max()), 1e-30)
        errs.append((path, float((g - g_ref).abs().max()) / scale))
    return {"loss": float(_whole(loss)), "ref_loss": float(ref_loss),
            "step_loss": float(metrics["loss"]), "grad_errs": errs, "yardstick": yard,
            "placed_before": placed_before, "placed_after": placed_after,
            "grad_placed": grad_placed, "calls": list(CALLS), "fallbacks": fallbacks,
            "table": dict(rules.table)}


def _session(model, params, specs, **kw):
    from repro_torch.serving import GenRequest, PagedServingEngine

    eng = PagedServingEngine(model, params, max_slots=4, page_size=16, max_context=64, **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = eng.run([GenRequest(i, p, n) for i, p, n in specs])
    return eng, {r.request_id: list(r.tokens) for r in res}, [
        str(w.message) for w in rec if "falling back" in str(w.message)]


def serve_parity(rank, world, arch, overrides):
    """A paged session on the 2x2 mesh (``Engine(rules=)``) against the
    single-process session: tokens, fallbacks, the pools' placements, each
    rank's pool blocks against the single-process pools' (the writes landed
    in each rank's storage), the page-write and decode launch counts."""
    from repro_torch.serving import kv_cache

    cfg = get_reduced_config(arch, dtype=torch.float32, **json.loads(overrides))
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(3)
    specs = [(f"r{i}", rng.integers(1, cfg.vocab_size, size=n).tolist(), m)
             for i, (n, m) in enumerate([(9, 6), (20, 5), (5, 7), (33, 4), (12, 6)])]
    ref_eng, ref_tokens, _ = _session(model, params, specs)
    mesh = _mesh()
    rules = sh.make_rules(cfg, mesh)
    _record_fused()
    CALLS.clear()
    eng, tokens, fallbacks = _session(model, params, specs, rules=rules)
    spec = kv_cache.pool_spec(rules, cfg.n_heads, cfg.n_kv_heads)
    want = sh.placements(mesh, sh.P(None, *spec))
    placed = all(list(t.placements) == want for layer in eng.cache for t in layer.values())
    pool_err = 0.0
    for layer, ref_layer in zip(eng.cache, ref_eng.cache):
        for k, t in layer.items():
            mine = t.to_local()
            # this rank's KV heads of the single-process pool
            hk = mine.shape[1]
            h0 = mesh.get_coordinate()[1] * hk if spec[0] is not None else 0
            pool_err = max(pool_err, float((mine - ref_layer[k][:, h0:h0 + hk]).abs().max()))
    return {"tokens": tokens, "ref_tokens": ref_tokens, "fallbacks": fallbacks,
            "placed": placed, "pool_err": pool_err, "calls": list(CALLS),
            "local_heads": int(eng.cache[0]["k_pages"].to_local().shape[1])}


def serve_seq_sharded_warns(rank, world):
    """Two sessions under the cell rules of a decode cell whose batch (1)
    the data axis does not divide: the cache's sequence is sharded, so the
    fused decode falls back, warned once in each session."""
    cfg = get_reduced_config("repro-100m", dtype=torch.float32, act_impl="fused",
                             pwl_softmax=True, force_dp_only=False)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    rules = steps.make_cell_rules(cfg, _mesh(), ShapeCell("d", 64, 1, "decode"))
    rng = np.random.default_rng(0)
    specs = [("r0", rng.integers(1, 500, size=9).tolist(), 4)]
    _, ref_tokens, _ = _session(model, params, specs)
    out = []
    for _ in range(2):
        _, tokens, fallbacks = _session(model, params, specs, rules=rules)
        out.append((tokens, fallbacks))
    return {"sessions": out, "ref_tokens": ref_tokens, "table": dict(rules.table)}


def compression_sync(rank, world, stacked_path):
    """``compressed_grad_sync`` over the world on this rank's slice of the
    stacked gradients and residuals; then 20 error-feedback steps of one
    constant gradient leaf per rank, their mean's running average, and a
    sync over the (data=2, model=2) mesh's "data" group."""
    from repro_torch.distributed import compression

    st = np.load(stacked_path)
    grads = {"w": torch.from_numpy(st["g_w"][rank]), "b": [torch.from_numpy(st["g_b"][rank])]}
    res = {"w": torch.from_numpy(st["r_w"][rank]), "b": [torch.from_numpy(st["r_b"][rank])]}
    mean, new_res = compression.compressed_grad_sync(grads, res)
    zero = compression.init_residuals(grads)
    g = torch.from_numpy(st["ef"][rank])
    r = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(20):
        m, r = compression.compressed_psum_leaf(g + r, None)
        acc = acc + m
    data_mean, _ = compression.compressed_psum_leaf(g, _mesh().get_group("data"))
    return {"mean": {"w": mean["w"].numpy(), "b": mean["b"][0].numpy()},
            "res": {"w": new_res["w"].numpy(), "b": new_res["b"][0].numpy()},
            "zero_res": [tuple(t.shape) for t in tree.leaves(zero)],
            "ef_avg": (acc / 20).numpy(), "data_mean": data_mean.numpy()}


TRAIN_CASES = {  # name: (arch, config overrides, microbatches)
    "repro-100m-tp": ("repro-100m", {"act_impl": "fused", "pwl_softmax": True,
                                     "force_dp_only": False}, 1),
    "repro-100m-tp-2mb": ("repro-100m", {"act_impl": "fused", "pwl_softmax": True,
                                         "force_dp_only": False}, 2),
    "repro-100m-dp": ("repro-100m", {"act_impl": "fused", "pwl_softmax": True}, 1),
    "olmoe-1b-7b": ("olmoe-1b-7b", {"act_impl": "fused", "force_dp_only": False}, 1),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {"act_impl": "fused", "force_dp_only": False}, 1),
    "mamba2-2.7b": ("mamba2-2.7b", {"force_dp_only": False}, 1),
    "whisper-small": ("whisper-small", {"act_impl": "fused", "pwl_softmax": True,
                                        "force_dp_only": False}, 1),
}


def _dtensor_refused(mesh):
    """A DTensor handed straight to a fused wrapper raises (it never
    launches on one); the same call per shard runs."""
    from repro_torch.distributed import shard_fused as shf

    cfg = get_reduced_config("repro-100m", dtype=torch.float32, act_impl="fused")
    table = sfu.plan_for(cfg).fused_table(sfu.site_key(sfu.SITE_MLP, cfg.activation))
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 8, generator=g), torch.randn(8, 16, generator=g)
    xd = shf.place(x, mesh, sh.P("data", None))
    wd = shf.place(w, mesh, sh.P(None, "model"))
    out = {}
    for name, call in [("fused_glu", lambda: fused.fused_glu(xd, wd, wd, table=table)),
                       ("fused_linear", lambda: fused.fused_linear(xd, wd, None, table=table)),
                       ("fused_pwl_softmax", lambda: fused.fused_pwl_softmax(xd, table=table))]:
        try:
            call()
            out[name] = "ran"
        except TypeError as e:
            out[name] = str(e)
    rules = sh.make_rules(cfg, mesh)
    y = shf.run_sharded(rules, lambda a, b, c: fused.fused_glu(a, b, c, table=table),
                        (xd, wd, wd), (sh.P("data", None), sh.P(None, "model"),
                                       sh.P(None, "model")), sh.P("data", "model"))
    want = fused.fused_glu(x, w, w, table=table)
    out["per_shard_err"] = float((y.full_tensor() - want).abs().max())
    return out


def _moe_combine_grad(mesh):
    """One MoE layer on the mesh, experts parallel: the gradients of a
    weighted sum of its output and aux loss, for the tokens, the router and
    the experts, against the mean over the data shards of the
    single-process layer's (the capacity and the aux loss are per shard)."""
    from repro_torch.distributed import shard_fused as shf
    from repro_torch.models import moe, transformer

    cfg = get_reduced_config("olmoe-1b-7b", dtype=torch.float32, act_impl="fused")
    g = torch.Generator().manual_seed(5)
    defs = transformer.moe_defs(cfg)
    params = {k: d.materialize(g, torch.device("cpu"), torch.float32) for k, d in defs.items()}
    x = torch.randn(4, 8, cfg.d_model, generator=g)
    r = torch.randn(4, 8, cfg.d_model, generator=g)
    plan = sfu.plan_for(cfg)

    def f(p, xx, rr, n_shards=1):
        y, aux = moe.moe_layer(cfg, p, xx, plan=plan)
        return (y * rr).sum() / n_shards + 3.0 * aux

    names = sorted(params)
    refs = []
    for i in range(2):
        leaves = [params[n].clone().requires_grad_(True) for n in names]
        xi = x[2 * i:2 * i + 2].clone().requires_grad_(True)
        out = f(dict(zip(names, leaves)), xi, r[2 * i:2 * i + 2])
        refs.append(torch.autograd.grad(out, leaves + [xi]))
    want = [(a + b) / 2 for a, b in zip(refs[0][:-1], refs[1][:-1])] \
        + [torch.cat([refs[0][-1], refs[1][-1]]) / 2]
    rules = sh.make_rules(cfg, mesh)
    specs = {"router": sh.P(None, None), "w_gate": sh.P("model", None, None),
             "w_up": sh.P("model", None, None), "w_down": sh.P("model", None, None)}
    leaves = [shf.place(params[n], mesh, specs[n]).requires_grad_(True) for n in names]
    xd = shf.place(x, mesh, sh.P("data", None, None)).requires_grad_(True)
    rd = shf.place(r, mesh, sh.P("data", None, None))
    with sh.use_rules(rules):
        # the mean of the shards' objectives (the aux loss is one already)
        out = f(dict(zip(names, leaves)), xd, rd, n_shards=2)
        got = torch.autograd.grad(out, leaves + [xd])
    return {n: float((a.full_tensor() - b).abs().max() / b.abs().max())
            for n, a, b in zip(names + ["x"], got, want)}


def train_all(rank, world):
    """Every TRAIN_CASES case, the DTensor refusal and the MoE combine's
    gradient, on one mesh."""
    mesh = _mesh()
    out = {name: _train_case(mesh, arch, over, 4, 32, microbatches=mb)
           for name, (arch, over, mb) in TRAIN_CASES.items()}
    out["dtensor_refused"] = _dtensor_refused(mesh)
    out["moe_combine_grad"] = _moe_combine_grad(mesh)
    return out


def comm_census(rank, world):
    """The collectives one sharded train step and one sharded paged session
    issue (``CommDebugMode``), by op name."""
    from torch.distributed.tensor.debug import CommDebugMode

    out = {}
    mesh = _mesh()
    for name, (arch, over, _) in TRAIN_CASES.items():
        cfg = get_reduced_config(arch, dtype=torch.float32, **over)
        step = steps.build_train_step(cfg, "cpu", mesh=mesh, cell=ShapeCell("t", 32, 4, "train"),
                                      in_place=True)
        state = steps.shard_state(cfg, adamw.init_state(Model(cfg, device="cpu").init(
            seed=0, master=True)), step.rules)
        mode = CommDebugMode()
        with mode:
            step(state, _batch(cfg, 4, 32, 1))
        out[name] = {str(k): v for k, v in mode.get_comm_counts().items()}
    return out


DENSE_CASES = {  # name: (config overrides, ssm:softplus on the standalone PWL kernel)
    "repro-100m": ({"act_impl": "fused", "pwl_softmax": True, "force_dp_only": False}, False),
    "gemma3-1b": ({"act_impl": "fused", "pwl_softmax": True}, False),
    "mamba2-2.7b": ({"act_impl": "fused"}, True),
    # capacity E / K: no pair dropped, in the mesh's per-data-shard buckets or
    # in one call over every row
    "jamba-v0.1-52b": ({"act_impl": "fused", "pwl_softmax": True, "capacity_factor": 2.0},
                       False),
    "whisper-small": ({"act_impl": "fused", "pwl_softmax": True}, False),
}


def _softplus_kernel_plan(cfg):
    """``cfg``'s plan with ``ssm:softplus`` on the standalone PWL kernel."""
    plan = sfu.compile_plan(cfg)
    return dataclasses.replace(cfg, act_plan=sfu.ActivationPlan(sites=tuple(
        (k, dataclasses.replace(s, impl="kernel") if k == "ssm:softplus" else s)
        for k, s in plan.items())))


def _record_pwl_kernel():
    """Record the standalone PWL kernel's calls in ``CALLS`` too (the plan's
    ``impl="kernel"`` sites look it up at each call)."""
    from repro_torch.kernels import ops

    if getattr(ops, "_recorded", False):
        return
    ops._recorded = True
    fn = ops.pwl_activation

    def call(x, *args, **kw):
        CALLS.append(("pwl_activation", type(x) is torch.Tensor, [tuple(x.shape)]))
        return fn(x, *args, **kw)
    ops.pwl_activation = call


# sequence-sharded dense caches: name -> (arch, config overrides, B, S, decode
# steps, the rules: "model" (sequence-parallel rules, 2 ways) or "cp" (the
# context-parallel cell rules of a B = 1 decode cell, ("data", "model"), 4 ways)).
# Twelve prompt tokens, then eight decode steps wrap gemma3-1b's 16-slot rings.
SEQ_CASES = {
    "gemma3-1b wrap": ("gemma3-1b", {"act_impl": "fused", "pwl_softmax": True}, 4, 12, 8,
                       "model"),
    "gemma3-1b cp": ("gemma3-1b", {"act_impl": "fused", "pwl_softmax": True}, 1, 12, 8, "cp"),
    "repro-100m cp": ("repro-100m", {"act_impl": "fused", "pwl_softmax": True,
                                     "force_dp_only": False}, 1, 12, 8, "cp"),
}
SEQ_T = 40  # the global layers' slots


WRITES: dict = {}  # a block's storage -> its shadow whole cache (k, v); and "mismatches"


def _shadow_block_writes():
    """Wrap ``layers._dense_cache_attend`` once: each call on a block of a
    cache sharded over its sequence (``reduce`` given) also applies the
    single-process write of the same k / v to a whole T-slot shadow of that
    layer's cache, kept by the block's storage, and counts in
    ``WRITES["mismatches"]`` a block that is not then bitwise the shadow's
    slice ``[lo, lo + Tb)``."""
    from repro_torch.models import layers

    if getattr(layers, "_shadowed", False):
        return
    layers._shadowed = True
    fn = layers._dense_cache_attend

    def call(q, k, v, k_blk, v_blk, pos0, window, exp_fn, table, *, T=None, lo=0,
             reduce=None):
        y = fn(q, k, v, k_blk, v_blk, pos0, window, exp_fn, table, T=T, lo=lo, reduce=reduce)
        if reduce is None:
            return y
        shadow = WRITES.setdefault(k_blk.data_ptr(), tuple(
            torch.zeros((b.shape[0], T) + tuple(b.shape[2:]), dtype=b.dtype)
            for b in (k_blk, v_blk)))
        fn(q, k, v, *shadow, pos0, window, exp_fn, table)
        Tb = k_blk.shape[1]
        WRITES["blocks"] = WRITES.get("blocks", 0) + 1
        if not all(torch.equal(b, w[:, lo:lo + Tb]) for b, w in zip((k_blk, v_blk), shadow)):
            WRITES["mismatches"] = WRITES.get("mismatches", 0) + 1
        return y
    layers._dense_cache_attend = call


def _dense_case(mesh, cfg, B, S, n_decode, T, make):
    """Prefill and ``n_decode`` steps of ``cfg`` on a dense cache under the
    rules ``make(cfg)`` against the single-process calls: logits, greedy
    tokens, the placements, the per-shard block writes against the
    single-process write of the same k / v (``_shadow_block_writes``), the
    fused calls and fallbacks."""
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
    steps_ = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int64))
              for _ in range(n_decode)]
    extras = {}
    if cfg.is_encoder_decoder:
        extras["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))

    def run(rules):
        p = params if rules is None else steps.shard_params(cfg, params, rules)
        CALLS.clear()
        with sh.use_rules(rules), warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            cache = model.make_cache(B, T)
            logits = [model.prefill(p, tokens, cache, **extras)]
            for i, t in enumerate(steps_):
                logits.append(model.decode_step(p, t, cache, S + i))
        falls = [str(w.message) for w in rec if "falling back" in str(w.message)]
        return logits, cache, falls

    ref, _, _ = run(None)
    rules = make(cfg)
    WRITES.clear()
    got, cache, falls = run(rules)
    calls = list(CALLS)
    specs = steps._spec_leaves(model.cache_specs(rules, B, T))
    return {"err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
            "tokens": [l.argmax(-1).tolist() for l in got],
            "ref_tokens": [l.argmax(-1).tolist() for l in ref],
            "plain": all(type(t) is torch.Tensor for t in got),
            "placed": all(list(t.placements) == sh.placements(mesh, s)
                          for t, s in zip(tree.leaves(cache), specs, strict=True)),
            "local_shapes": [tuple(t.to_local().shape) for t in tree.leaves(cache)],
            "block_writes": WRITES.get("blocks", 0),
            "block_mismatches": WRITES.get("mismatches", 0),
            "cache_seq": rules.table["cache_seq"],
            "fallbacks": falls, "calls": calls}


def dense_cache_parity(rank, world):
    """Dense-cache prefill and decode steps on the 2x2 mesh (the cache
    written and read per shard; gemma3-1b's local layers as rings, mamba2's
    and jamba's SSM states and conv tails, whisper's self- and cross-
    attention K/V) against the single-process calls' logits and greedy
    tokens; the cache placements; the fused calls' operands.  Then
    ``SEQ_CASES``: caches sharded over their sequence, rings wrapped in
    the decode, each block write against the single-process write."""
    mesh = _mesh()
    out = {}
    _record_fused()
    _record_pwl_kernel()
    _shadow_block_writes()
    for arch, (over, softplus_kernel) in DENSE_CASES.items():
        cfg = get_reduced_config(arch, dtype=torch.float32, **over)
        if softplus_kernel:
            cfg = _softplus_kernel_plan(cfg)
        out[arch] = _dense_case(mesh, cfg, 4, 24, 3, 40, lambda c: sh.make_rules(c, mesh))
    for name, (arch, over, B, S, n_decode, kind) in SEQ_CASES.items():
        cfg = get_reduced_config(arch, dtype=torch.float32, **over)
        if kind == "cp":
            cell = ShapeCell("cp", SEQ_T, B, "decode")
            make = lambda c: steps.make_cell_rules(c, mesh, cell)  # noqa: E731
        else:
            make = lambda c: sh.make_rules(c, mesh)  # noqa: E731
        sfu.reset_fused_fallback_warnings()  # each case reports its own
        out[name] = _dense_case(mesh, cfg, B, S, n_decode, SEQ_T, make)
    return out


@contextlib.contextmanager
def planted_fault(kind: str):
    """A training fault that the bf16 bound of ``tests/test_torch_examples.py``
    must catch, planted while the block runs: "skip1" / "skip2" (that AdamW
    update computed and dropped), "stale" (the weights the model computes
    with left at their first cast, the gradient still flowing), or "" (none).
    ``tests/bf16_bound_readings.py`` reads the losses' gap under each."""
    from repro_torch.models import transformer

    apply_updates, compute_params = adamw.apply_updates, transformer.compute_params
    calls, first = [], []

    def skipping(state, grads, cfg, in_place=False):
        calls.append(1)
        new, metrics = apply_updates(state, grads, cfg, in_place=in_place)
        return (state if f"skip{len(calls)}" == kind else new), metrics

    def stale(defs, params, dtype):
        out = compute_params(defs, params, dtype)
        leaves = tree.leaves(out)
        first[:] = first or [x.detach().clone() for x in leaves]
        return tree.unflatten(out, [f + (x - x.detach()) for f, x in zip(first, leaves)])

    if kind.startswith("skip"):
        adamw.apply_updates = skipping
    elif kind == "stale":
        transformer.compute_params = stale
    try:
        yield
    finally:
        adamw.apply_updates, transformer.compute_params = apply_updates, compute_params


def train_compressed_example(rank, world, init_f32, init_bf16, fault=""):
    """``examples_torch/train_compressed.py``'s ``main`` on this rank of the
    gloo group, 3 steps in f32 and in bf16 (its config module's
    ``get_reduced_config`` given that dtype), each from the JAX init
    pickled for it, under :func:`planted_fault` ``fault``; returns the
    losses by dtype."""
    import importlib.util
    import pathlib
    import pickle

    from repro_torch.models import params_from_numpy

    path = pathlib.Path(__file__).resolve().parents[1] / "examples_torch" / "train_compressed.py"
    spec = importlib.util.spec_from_file_location("train_compressed_port", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {}
    for dtype, init_path in (("float32", init_f32), ("bfloat16", init_bf16)):
        mod.get_reduced_config = functools.partial(get_reduced_config,
                                                   dtype=getattr(torch, dtype))
        with open(init_path, "rb") as f:
            jparams = pickle.load(f)
        cfg = mod.get_reduced_config("repro-100m", act_impl="jnp")
        params = params_from_numpy(jparams, cfg, "cpu", master=True)
        with planted_fault(fault):
            out[dtype] = mod.main(["--steps", "3", "--device", "cpu"], params=params)
    return out
