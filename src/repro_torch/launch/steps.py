"""The train step (torch port of ``repro/launch/steps.py:build_train_step``).

``build_train_step(cfg, device, opt_cfg, microbatches)`` returns
``step(state, batch) -> (state, metrics)``: the loss and its gradient by
autograd (with K > 1 microbatches, f32 gradients summed over the K slices
of the batch and divided by K, as the JAX package's scan does), then one
AdamW update.  ``cfg.act_impl_bwd`` pins the backward of every fused site
for the whole step (forward, the backward and the recomputation of
``cfg.remat`` inside it); None keeps the ambient default.  ``in_place``
updates the state's own tensors (``adamw.apply_updates``), as the train
launcher does.

Under a mesh (``mesh=``, ``cell=``), the rules are ``make_cell_rules``'s:
the f32 masters and both AdamW moments are DTensors placed by
``specs_for_params``, the batch is placed by ``batch_specs``, every model
call runs under ``use_rules``, and the in-place update keeps every
placement.  With no mesh the step is the one-device step.

The dry run's steps (``launch/dryrun.py``): ``build_step(cfg, mesh, cell)``
returns ``(step, operands)``, a train, prefill or decode step and its meta
operands (parameters or the AdamW state, the batch of ``input_specs``, a
dense cache), each placed as the sharded step places it, for
``step(*operands)`` to trace with nothing allocated.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed.sharding import (
    P,
    Rules,
    is_dtensor,
    make_rules,
    mesh_shape,
    sanitize_spec,
    specs_for_params,
    use_rules,
)
from repro_torch.models.common import shape_structs, zip_defs
from repro_torch.roofline.model import total_params
from repro_torch.kernels import fused
from repro_torch.models import Model, input_specs
from repro_torch.optim import adamw


def batch_specs(cfg, cell, rules: Rules) -> dict:
    """The spec of each input of a ``cell`` step (the JAX package's
    ``input_specs`` keys)."""
    sspec = rules.spec("batch", "act_seq")
    if cell.kind in ("train", "prefill"):
        out = {"tokens": sspec, "targets": sspec} if cell.kind == "train" else {"tokens": sspec}
        if cfg.is_encoder_decoder:
            out["frames"] = rules.spec("batch", None, None)
        if cfg.n_vision_tokens:
            out["vision_embeds"] = rules.spec("batch", None, None)
        return out
    return {"tokens": rules.spec("batch", None), "pos": P()}


def make_cell_rules(cfg, mesh, cell) -> Rules:
    """Rules for (arch, mesh, cell): a global batch that the batch axes do
    not divide releases them and spreads the sequence and the KV cache over
    ("data", "model") (context parallelism); a small dense model's training
    cell shards the batch over every mesh axis and drops tensor parallelism
    (``cfg.force_dp_only``: None decides by 2.5 B parameters and no
    experts)."""
    rules = make_rules(cfg, mesh)
    shape = mesh_shape(mesh)
    batch_ways = math.prod(shape[a] for a in ("pod", "data") if a in shape)
    t = dict(rules.table)
    if cell.global_batch % batch_ways != 0:
        t["batch"] = None
        t["flat_tokens"] = None
        t["cache_seq"] = ("data", "model")
        t["act_seq"] = ("data", "model")
        t["cache_kv"] = None
    else:
        t["flat_tokens"] = t["batch"]
        all_axes = tuple(a for a in ("pod", "data", "model") if a in shape)
        ways = math.prod(shape[a] for a in all_axes)
        if cfg.force_dp_only is None:
            small = total_params(cfg) < 2.5e9 and cfg.n_experts == 0
        else:
            small = bool(cfg.force_dp_only)
        if small and cell.kind == "train" and cell.global_batch % ways == 0:
            t["batch"] = all_axes
            t["flat_tokens"] = all_axes
            for ax in ("heads", "kv", "mlp", "vocab", "act_heads", "act_kv",
                       "ssm_inner", "ssm_heads"):
                t[ax] = None
            t["embed"] = "data"
    return Rules(table=t, mesh_axes=rules.mesh_axes, mesh=rules.mesh)


def auto_microbatches(cfg, cell, mesh) -> int:
    """Gradient-accumulation depth so that the saved layer-boundary
    activations fit: n_boundaries x (B/dp/K) x S x D x 2 bytes <= 6 GiB a
    rank."""
    shape = mesh_shape(mesh)
    dp = math.prod(shape[a] for a in ("pod", "data") if a in shape)
    b_loc = max(cell.global_batch // dp, 1)
    if cfg.is_encoder_decoder:
        n_bound = cfg.n_layers + cfg.n_encoder_layers
    else:
        n_bound = cfg.n_layers // max(cfg.period, 1)
    per_mb = n_bound * b_loc * cell.seq_len * cfg.d_model * 2
    budget = 6 * 2**30
    k = max(1, -(-per_mb // budget))
    while b_loc % k and k < b_loc:
        k += 1
    return int(min(k, b_loc))


def _split(batch: dict, k: int) -> list[dict]:
    """``batch`` cut into ``k`` equal slices along the batch axis."""
    B = next(iter(batch.values())).shape[0]
    if B % k:
        raise ValueError(f"batch {B} does not split into {k} microbatches")
    return [{name: v.reshape(k, B // k, *v.shape[1:])[i] for name, v in batch.items()}
            for i in range(k)]


def param_specs(cfg, rules: Rules):
    """The sanitised spec of every parameter (``specs_for_params`` over
    ``Model.param_logical()``, each checked against its shape)."""
    model = Model(cfg, device="meta")
    specs = specs_for_params(rules, model.param_logical())
    return zip_defs(lambda d, s: sanitize_spec(rules.mesh, s, d.shape), model.param_defs(),
                    specs)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in ``tree.leaves`` order."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [s for v in specs for s in _spec_leaves(v)]


def _place_tree(tensors, specs, mesh):
    """A tree of tensors (plain, alike on every rank, or DTensors), each
    placed by its spec in ``specs``: each rank keeps its own blocks."""
    return tree.unflatten(tensors, [shf.place(t, mesh, s) for t, s in
                                    zip(tree.leaves(tensors), _spec_leaves(specs), strict=True)])


def shard_params(cfg, params, rules: Rules):
    """A parameter tree (plain tensors alike on every rank, or DTensors)
    placed by :func:`param_specs`."""
    return _place_tree(params, param_specs(cfg, rules), rules.mesh)


def shard_state(cfg, state: dict, rules: Rules) -> dict:
    """An AdamW state with its masters and both moments placed by
    :func:`param_specs`, its step replicated."""
    return {"params": shard_params(cfg, state["params"], rules),
            "mu": shard_params(cfg, state["mu"], rules),
            "nu": shard_params(cfg, state["nu"], rules),
            "step": shf.replicated(state["step"], rules.mesh)}


def place_batch(cfg, cell, batch: dict, rules: Rules) -> dict:
    """A batch (alike on every rank) placed by :func:`batch_specs`; a mask
    as its tokens."""
    specs = batch_specs(cfg, cell, rules)
    out = {}
    for k, v in batch.items():
        spec = specs.get(k, specs["tokens"] if k == "mask" else None)
        if spec is None:
            raise ValueError(f"batch key {k!r} has no spec for a {cell.kind} cell")
        out[k] = shf.place(v, rules.mesh, sanitize_spec(rules.mesh, spec, v.shape))
    return out


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def build_train_step(cfg, device, opt_cfg: Optional[adamw.AdamWConfig] = None,
                     microbatches: int = 1, in_place: bool = False, mesh=None, cell=None):
    """The train step (module docstring).  With ``mesh`` (a DeviceMesh) and
    ``cell`` (a ``ShapeCell``), the sharded step: ``state`` must be placed
    (:func:`shard_state`); ``batch`` may be plain (alike on every rank) or
    placed; the metrics come back whole on every rank."""
    model = Model(cfg, device=device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    impl_bwd = cfg.act_impl_bwd
    if impl_bwd is not None:
        impl_bwd = fused.resolve_impl_bwd(impl_bwd)  # validate at build
    if (mesh is None) != (cell is None):
        raise ValueError("a sharded step takes both mesh= and cell=")
    rules = make_cell_rules(cfg, mesh, cell) if mesh is not None else None

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, metrics = model.loss(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        if rules is not None:  # each gradient on its parameter's placements
            grads = [g if list(g.placements) == list(p.placements)
                     else g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def loss_and_grads(state, batch):
        """(loss, metrics, gradient leaves) of ``state``'s parameters on
        ``batch``, averaged over the microbatches (no update)."""
        if rules is not None:
            batches = [place_batch(cfg, cell, mb, rules) for mb in
                       ([batch] if microbatches <= 1 else _split(batch, microbatches))]
        if microbatches <= 1:
            return value_and_grad(state["params"], batches[0] if rules is not None else batch)
        gacc, loss = None, 0.0
        for mb in (batches if rules is not None else _split(batch, microbatches)):
            l, metrics, g = value_and_grad(state["params"], mb)
            g = [x.to(torch.float32) for x in g]
            gacc = g if gacc is None else [a + b for a, b in zip(gacc, g)]
            loss = loss + l
        return loss / microbatches, metrics, [g / microbatches for g in gacc]

    def contexts():
        stack = contextlib.ExitStack()
        if impl_bwd is not None:
            stack.enter_context(fused.use_impl_bwd(impl_bwd))
        stack.enter_context(use_rules(rules))
        return stack

    def grads_only(state, batch):
        with contexts():
            loss, metrics, grads = loss_and_grads(state, batch)
        return loss, metrics, tree.unflatten(state["params"], grads)

    def train_step(state, batch):
        with contexts():
            loss, metrics, grads = loss_and_grads(state, batch)
            with torch.no_grad():
                new_state, opt_metrics = adamw.apply_updates(
                    state, tree.unflatten(state["params"], grads), opt_cfg, in_place=in_place)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        if rules is not None:
            metrics = {k: _whole(v) for k, v in metrics.items()}
        return new_state, metrics

    train_step.grads = grads_only
    train_step.rules = rules
    return train_step


# ---------------------------------------------------------------------------
# the dry run's steps: meta operands, placed


def _cache_specs_structs(model, cfg, rules: Rules, batch: int, max_len: int):
    """(specs, meta tensors) of the dense cache of ``batch`` rows and
    ``max_len`` positions: ``Model.cache_specs``, as ``make_cache`` places
    it, and ``shape_structs`` of ``Model.cache_defs``."""
    return (model.cache_specs(rules, batch),
            shape_structs(model.cache_defs(batch, max_len), cfg.dtype))


def _meta_serving(cfg, mesh, cell):
    """(model, rules, placed meta parameters, placed meta batch) of a
    prefill or decode cell."""
    model = Model(cfg, device="meta")
    rules = make_cell_rules(cfg, mesh, cell)
    params = shard_params(cfg, shape_structs(model.param_defs(), cfg.dtype), rules)
    return model, rules, params, place_batch(cfg, cell, input_specs(cfg, cell), rules)


def _meta_cache(model, cfg, rules, cell):
    """The placed meta dense cache of a prefill or decode cell; a VLM's
    prefix rides in it (``max_len = seq_len + n_vision_tokens``)."""
    max_len = cell.seq_len + (cfg.n_vision_tokens or 0)
    specs, structs = _cache_specs_structs(model, cfg, rules, cell.global_batch, max_len)
    return _place_tree(structs, specs, rules.mesh), max_len


def build_prefill_step(cfg, mesh, cell):
    """``(step, (params, batch, cache))``: ``step`` runs ``Model.prefill``
    under the cell rules and returns (logits, cache)."""
    model, rules, params, batch = _meta_serving(cfg, mesh, cell)
    cache, _ = _meta_cache(model, cfg, rules, cell)

    def prefill_step(params, batch, cache):
        with use_rules(rules):
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            return model.prefill(params, batch["tokens"], cache, **extras), cache

    return prefill_step, (params, batch, cache)


def build_decode_step(cfg, mesh, cell):
    """``(step, (params, batch, cache))``: ``step`` runs one
    ``Model.decode_step`` under the cell rules and returns (logits, cache).
    A meta ``pos`` stands for the cache's last slot: a step reads the
    whole cache, masked, at any position."""
    model, rules, params, batch = _meta_serving(cfg, mesh, cell)
    cache, max_len = _meta_cache(model, cfg, rules, cell)

    def decode_step(params, batch, cache):
        pos = batch["pos"]
        pos = max_len - 1 if pos.device.type == "meta" else int(pos)
        with use_rules(rules):
            return model.decode_step(params, batch["tokens"], cache, pos), cache

    return decode_step, (params, batch, cache)


def build_step(cfg, mesh, cell, microbatches: Optional[int] = None):
    """The dry run's step of ``cell`` on ``mesh`` and its placed meta
    operands (module docstring).  A train cell's step is
    :func:`build_train_step`'s in-place step over the AdamW state of f32
    masters, at ``microbatches`` (:func:`auto_microbatches` when None)."""
    if cell.kind == "prefill":
        return build_prefill_step(cfg, mesh, cell)
    if cell.kind == "decode":
        return build_decode_step(cfg, mesh, cell)
    if microbatches is None:
        microbatches = auto_microbatches(cfg, cell, mesh)
    step = build_train_step(cfg, "meta", microbatches=microbatches, in_place=True, mesh=mesh,
                            cell=cell)
    masters = shape_structs(Model(cfg, device="meta").param_defs(), torch.float32)
    state = shard_state(cfg, adamw.init_state(masters), step.rules)
    return step, (state, place_batch(cfg, cell, input_specs(cfg, cell), step.rules))
