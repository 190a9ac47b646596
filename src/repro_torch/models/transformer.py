"""Decoder LM over a periodic layer pattern (torch): attention (global, or
gemma3's sliding-window local layers beside its global ones) or a Mamba2
SSM block (mamba2, and jamba's hybrid stack) with a dense FFN or an MoE FFN
per layer, and an optional prefix of vision embeddings in front of the
tokens (internvl2's stub patch embeddings).

Counterpart of ``repro/models/transformer.py``.  Parameters keep the JAX
package's tree: ``{"embed", "final_norm", "layers", "unembed"}`` where
``layers`` is a list (one entry per period slot) of per-layer dicts stacked
``(n_periods, ...)``.  The JAX layer ``scan`` is a Python loop over layers
here; caches are the same stacked trees and are written in place.  Under
``cfg.remat`` a training forward recomputes each period in the backward
(``torch.utils.checkpoint``, the counterpart of JAX's ``jax.checkpoint``
with ``nothing_saveable``).

API (functions over a params tree):
  model_defs(cfg)                                   -> ParamDef tree
  forward(cfg, params, tokens, vision_embeds=None) -> logits
  forward_with_aux(cfg, params, tokens, ...)        -> (logits, MoE aux loss)
  loss_fn(cfg, params, batch)                       -> (loss, metrics)
  make_cache / prefill / decode_step                 (dense cache; local
                                                     layers hold a ring, SSM
                                                     layers their conv tail
                                                     and state)
  make_paged_cache / prefill_paged / decode_step_paged   (paged serving)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sfu
from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed.sharding import active_mesh_rules, constrain, is_dtensor

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .common import ModelConfig, ParamDef, compute_params, gather_layer, zeros_like_defs

# ---------------------------------------------------------------------------
# parameter definitions


def _stack(defs: dict, n: int) -> dict:
    return {k: (ParamDef((n,) + v.shape, ("layers",) + v.logical_axes, v.init, v.matrix) if isinstance(v, ParamDef)
                else _stack(v, n))
            for k, v in defs.items()}


def moe_defs(cfg: ModelConfig) -> dict:
    """The MoE FFN.  The router is no matrix of the model dtype: it stays f32
    in the serving tree too, as routing reads it (``moe.route``); rounding
    it would change which experts are chosen."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": ParamDef((D, E), ("embed", None), init="small_normal", matrix=False),
        "w_gate": ParamDef((E, D, Fe), ("experts", "embed", "mlp")),
        "w_up": ParamDef((E, D, Fe), ("experts", "embed", "mlp")),
        "w_down": ParamDef((E, Fe, D), ("experts", "mlp", "embed")),
    }


def norm_defs(cfg: ModelConfig) -> dict:
    """A norm's parameters, f32 (the JAX package reads them in f32); none
    for olmo's non-parametric LayerNorm, an empty subtree as in JAX."""
    D = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": ParamDef((D,), (None,), init="zeros", matrix=False)}
    if cfg.norm_type == "layernorm":
        return {"scale": ParamDef((D,), (None,), init="ones", matrix=False),
                "bias": ParamDef((D,), (None,), init="zeros", matrix=False)}
    if cfg.norm_type == "nonparam_ln":
        return {}
    raise ValueError(f"norm_type {cfg.norm_type!r}")


def attn_defs(cfg: ModelConfig) -> dict:
    """The projections, and qwen2.5's QKV biases (zeros at init, held in
    the model dtype: the JAX package casts them to it at each use)."""
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((D, H, dh), ("embed", "heads", None)),
        "wk": ParamDef((D, Hkv, dh), ("embed", "kv", None)),
        "wv": ParamDef((D, Hkv, dh), ("embed", "kv", None)),
        "wo": ParamDef((H, dh, D), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, dh), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((Hkv, dh), ("kv", None), init="zeros")
        defs["bv"] = ParamDef((Hkv, dh), ("kv", None), init="zeros")
    return defs


def mlp_defs(cfg: ModelConfig) -> dict:
    """A dense FFN: the GLU's two input projections, or a plain MLP with
    biases (held in the model dtype: the JAX package casts them to it at
    each use)."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": ParamDef((D, F), ("embed", "mlp")),
                "w_up": ParamDef((D, F), ("embed", "mlp")),
                "w_down": ParamDef((F, D), ("mlp", "embed"))}
    return {"w_in": ParamDef((D, F), ("embed", "mlp")),
            "b_in": ParamDef((F,), ("mlp",), init="zeros"),
            "w_down": ParamDef((F, D), ("mlp", "embed")),
            "b_down": ParamDef((D,), (None,), init="zeros")}


def ssm_defs(cfg: ModelConfig) -> dict:
    """The Mamba2 block, with the JAX package's inits: the projections, the
    conv weights and bias in the model dtype (JAX casts each one at its
    use), ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` in f32 (JAX
    reads them in f32)."""
    D = cfg.d_model
    d_inner, n_heads, d_state, conv_ch, _ = SSM.ssm_dims(cfg)
    vec = dict(matrix=False)
    return {
        "in_z": ParamDef((D, d_inner), ("embed", "ssm_inner")),
        "in_x": ParamDef((D, d_inner), ("embed", "ssm_inner")),
        "in_bc": ParamDef((D, 2 * d_state), ("embed", None)),
        "in_dt": ParamDef((D, n_heads), ("embed", "ssm_heads")),
        "conv_w": ParamDef((cfg.ssm_conv_dim, conv_ch), (None, None), init="small_normal"),
        "conv_b": ParamDef((conv_ch,), (None,), init="zeros"),
        "A_log": ParamDef((n_heads,), ("ssm_heads",), init="zeros", **vec),
        "D": ParamDef((n_heads,), ("ssm_heads",), init="ones", **vec),
        "dt_bias": ParamDef((n_heads,), ("ssm_heads",), init="zeros", **vec),
        "norm_scale": ParamDef((d_inner,), ("ssm_inner",), init="zeros", **vec),
        "out_proj": ParamDef((d_inner, D), ("ssm_inner", "embed")),
    }


def block_defs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    if mixer not in ("attn", "attn_local", "attn_global", "ssm") or ffn not in ("dense", "moe"):
        raise NotImplementedError(f"layer kind ({mixer}, {ffn}) is not ported")
    return {
        "ln1": norm_defs(cfg),
        "ln2": norm_defs(cfg),
        "mixer": ssm_defs(cfg) if mixer == "ssm" else attn_defs(cfg),
        "ffn": moe_defs(cfg) if ffn == "moe" else mlp_defs(cfg),
    }


def model_defs(cfg: ModelConfig) -> dict:
    kinds = cfg.layer_kinds
    period = cfg.period
    n_periods = cfg.n_layers // period
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="small_normal"),
        "final_norm": norm_defs(cfg),
        "layers": [_stack(block_defs(cfg, *kinds[j]), n_periods) for j in range(period)],
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    return defs


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (n_periods, ...) tree (views, no copies)."""
    if torch.is_tensor(tree):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, each leaf split once by
    ``torch.unbind`` (views; its backward stacks the layers' gradients in
    one copy, where indexing each layer would add a zero-padded full-size
    gradient per layer)."""
    if torch.is_tensor(tree):
        return list(torch.unbind(tree, 0))
    split = {k: _unbind(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# blocks / embeddings


def block_apply(cfg: ModelConfig, p, h, mixer: str, ffn: str, cache=None, pos=None,
                plan=None, paged=None):
    """Pre-norm residual block.  ``mixer`` is the layer's kind: ``ssm``
    (the Mamba2 block), or attention (``attn_local`` attends over
    ``cfg.sliding_window``).  Returns (h, cache, aux): ``aux`` is the MoE
    layer's load-balancing loss, None for a dense FFN (which adds 0)."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    hn = L.apply_norm(cfg, p["ln1"], h)
    if mixer == "ssm":
        y, cache = SSM.mamba2_layer(cfg, p["mixer"], hn, cache, plan=plan)
    else:
        y, cache = L.attention_layer(cfg, p["mixer"], hn, kind=mixer, cache=cache,
                                     cache_pos=pos, plan=plan, paged=paged)
    h = h + y
    hn2 = L.apply_norm(cfg, p["ln2"], h)
    if ffn == "moe":
        y2, aux = MOE.moe_layer(cfg, p["ffn"], hn2, plan=plan)
    else:
        y2, aux = L.mlp(cfg, p["ffn"], hn2, plan=plan), None
    return h + y2, cache, aux


def _embed_sharded(rules, table, tokens):
    """The lookup per shard (Megatron's vocab-parallel embedding): each
    rank holds its rows of the vocab-sharded table (the FSDP gather gives it
    every column), looks up the tokens it holds, zeroes the rows of tokens
    outside its slice and one sum over the vocab axes makes the embedding
    whole, as JAX's one-hot contraction over the sharded vocab does."""
    V = table.shape[0]
    b = shf.batch_entry(rules, tokens.shape[0])
    v = shf.dim_entry(rules, "vocab", V)
    groups = [shf.axis_group(rules, a) for a in shf.entry_axes(v)]

    def body(tab, tok):
        if v is None:
            return tab[tok.long()]
        n = tab.shape[0]
        t = tok.long() - shf.entry_index(rules, v) * n
        ok = (t >= 0) & (t < n)
        h = torch.where(ok[..., None], tab[t.clamp(0, n - 1)], torch.zeros((), dtype=tab.dtype))
        for g in groups:
            h = shf.psum(h, g)
        return h

    return shf.run_sharded(rules, body, (table, tokens), (shf.P(v, None), shf.P(b, None)),
                           shf.P(b, None, None))


def embed_tokens(cfg: ModelConfig, params, tokens, vision_embeds=None):
    """(B, S) int tokens -> (B, S, D) in cfg.dtype (an index gather; the JAX
    package's one-hot contraction for short inputs gives the same values),
    behind ``vision_embeds`` (B, n_vision, D) when given: (B, n_vision + S,
    D).  Under a mesh, the vocab-parallel lookup (:func:`_embed_sharded`)."""
    rules = active_mesh_rules()
    if rules is not None:
        h = _embed_sharded(rules, params["embed"], tokens).to(cfg.dtype)
    else:
        h = params["embed"][tokens.long()].to(cfg.dtype)
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(cfg.dtype), h], dim=1)
    return constrain(h, "batch", "act_seq", "act_embed")


def unembed(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"])
    else:
        logits = h @ params["unembed"]
    logits = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:  # mask pad ids out of the softmax
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        pad = pad.to(torch.float32) * 1e9
        if is_dtensor(logits):  # every rank holds the mask alike
            pad = shf.replicated(pad, logits.device_mesh)
        logits = logits - pad
    return constrain(logits, "batch", "act_seq", "vocab")


def _run_layers(cfg: ModelConfig, params, h, cache=None, pos=None, paged=None,
                remat: bool = False):
    """The layer stack -> (h, aux), ``aux`` the f32 sum of the MoE layers'
    load-balancing losses in layer order (0 for a dense model).  ``remat``
    (a training forward) recomputes each period in the backward instead of
    keeping its activations."""
    kinds = cfg.layer_kinds
    period = cfg.period
    n_periods = cfg.n_layers // period
    plan = sfu.plan_for(cfg)
    stacks = [_unbind(params["layers"][j], n_periods) for j in range(period)]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # under a mesh each layer's FSDP rows are gathered where it runs (again
    # in the backward's recomputation under remat)
    layer_defs = ([block_defs(cfg, *kinds[j]) for j in range(period)]
                  if is_dtensor(h) else None)
    if is_dtensor(h):
        aux = shf.replicated(aux, h.device_mesh)
    for i in range(n_periods):
        def period_fn(h, aux, i=i):
            for j in range(period):
                c = _layer(cache[j], i) if cache is not None else None
                p = stacks[j][i] if layer_defs is None else gather_layer(layer_defs[j],
                                                                         stacks[j][i])
                h, _, a = block_apply(cfg, p, h, *kinds[j], cache=c, pos=pos,
                                      plan=plan, paged=paged)
                if a is not None:
                    aux = aux + a
            return h, aux

        h, aux = (checkpoint(period_fn, h, aux, use_reentrant=False) if remat
                  else period_fn(h, aux))
    return h, aux


def forward_with_aux(cfg: ModelConfig, params, tokens, vision_embeds=None):
    """Teacher-forcing forward -> ((B, S', padded_vocab) f32 logits, the f32
    MoE aux loss summed over layers); S' = S, or n_vision + S behind a
    ``vision_embeds`` prefix.

    ``params`` may be the serving tree or the f32 training masters: every
    matrix is cast to ``cfg.dtype`` first (differentiably).  Under
    ``cfg.remat`` with grad enabled, each period is recomputed in the
    backward."""
    params = compute_params(model_defs(cfg), params, cfg.dtype)
    h = embed_tokens(cfg, params, tokens, vision_embeds)
    h, aux = _run_layers(cfg, params, h, remat=cfg.remat and torch.is_grad_enabled())
    return unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h)), aux


def forward(cfg: ModelConfig, params, tokens, vision_embeds=None):
    """Teacher-forcing forward -> (B, S', padded_vocab) f32 logits (the
    prefix's positions included, as in JAX)."""
    return forward_with_aux(cfg, params, tokens, vision_embeds)[0]


def _cross_entropy_sharded(rules, logits, targets, mask):
    """The cross entropy per shard, the vocab sharded end to end: each rank
    takes the max, the exp-sum and the target pick over its vocab slice,
    and the group's max and sums make them whole (the reductions JAX's
    GSPMD partitions over the vocab); the token sums then go over the batch
    axes.  Every rank returns the same mean."""
    B, S, V = logits.shape
    b = shf.batch_entry(rules, B)
    v = shf.dim_entry(rules, "vocab", V)
    vgroups = [shf.axis_group(rules, a) for a in shf.entry_axes(v)]
    bgroups = [shf.axis_group(rules, a) for a in shf.entry_axes(b)]
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=targets.device)

    def body(lf, tgt, msk):
        lf = lf.to(torch.float32)
        m = lf.amax(dim=-1, keepdim=True).detach()
        for g in vgroups:
            m = shf.pmax(m, g)
        se = torch.exp(lf - m).sum(dim=-1)
        off = shf.entry_index(rules, v) * lf.shape[-1] if v is not None else 0
        vocab = off + torch.arange(lf.shape[-1], device=lf.device, dtype=tgt.dtype)
        pick = torch.where(vocab == tgt[..., None], lf, 0.0).sum(dim=-1)
        for g in vgroups:
            se, pick = shf.psum(se, g), shf.psum(pick, g)
        ll = pick - (torch.log(se) + m[..., 0])
        num, den = (ll * msk).sum(), msk.sum()
        for g in bgroups:
            num, den = shf.psum(num, g), shf.psum(den, g)
        return -num / torch.clamp(den, min=1)

    return shf.run_sharded(rules, body, (logits, targets, mask),
                           (shf.P(b, None, v), shf.P(b, None), shf.P(b, None)), shf.P())


def sharded_cross_entropy(logits, targets, mask=None):
    """Mean next-token cross entropy, the JAX package's formula: a
    stop-gradient row max, a logsumexp, and the target logit picked by a
    compare-and-sum over the vocab (no gather).  Under a mesh, per shard
    (:func:`_cross_entropy_sharded`)."""
    rules = active_mesh_rules()
    if rules is not None:
        return _cross_entropy_sharded(rules, logits, targets, mask)
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    vocab = torch.arange(lf.shape[-1], device=lf.device, dtype=targets.dtype)
    tgt = torch.where(vocab == targets[..., None], lf, 0.0).sum(dim=-1)
    ll = tgt - lse
    if mask is None:
        mask = torch.ones_like(ll)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross entropy plus 0.01 x the MoE aux loss.  batch:
    ``tokens``, ``targets`` (B, S) int, optional ``mask`` and
    ``vision_embeds`` (whose positions the loss leaves out).  Returns
    ``(loss, {"nll", "aux"})``; a dense model's ``aux`` is 0 and its loss
    the nll."""
    vision = batch.get("vision_embeds")
    logits, aux = forward_with_aux(cfg, params, batch["tokens"], vision)
    if vision is not None:
        logits = logits[:, vision.shape[1]:]
    nll = sharded_cross_entropy(logits, batch["targets"].long(), batch.get("mask"))
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# dense cache


def cache_len(cfg: ModelConfig, mixer: str, max_len: int) -> int:
    """The dense cache's slots for a layer of kind ``mixer``: ``max_len``,
    or for a local layer at most its window (a ring of ``sliding_window``
    slots once ``max_len`` reaches it)."""
    if mixer == "attn_local" and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def _serving_params(cfg: ModelConfig, params):
    """Under a mesh, the serving tree with its FSDP rows gathered (what
    every product reads); as it is otherwise."""
    if active_mesh_rules() is None:
        return params
    return compute_params(model_defs(cfg), params, cfg.dtype)


def _host_logits(logits):
    """The logits every rank samples from alike: a DTensor's whole value."""
    return logits.full_tensor() if is_dtensor(logits) else logits


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """The dense cache's ParamDef tree (zeros, held in ``cfg.dtype``), per
    period slot by its layer kind, stacked (n_periods, ...), with the JAX
    package's logical axes: an attention slot's {k, v} of (B, T, Hkv, dh),
    T = :func:`cache_len` of its kind; an SSM slot's {conv (B, K-1, C),
    ssm (B, H, P, N)}."""
    n_periods = cfg.n_layers // cfg.period
    out = []
    for mixer, _ in cfg.layer_kinds[:cfg.period]:
        if mixer == "ssm":
            _, n_heads, d_state, conv_ch, _ = SSM.ssm_dims(cfg)
            slot = {"conv": ((batch, cfg.ssm_conv_dim - 1, conv_ch), ("batch", None, None)),
                    "ssm": ((batch, n_heads, cfg.ssm_head_dim, d_state),
                            ("batch", "ssm_heads", None, None))}
        else:
            shape = (batch, cache_len(cfg, mixer, max_len), cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            axes = ("batch", "cache_seq", "cache_kv", None)
            slot = {"k": (shape, axes), "v": (shape, axes)}
        out.append({k: ParamDef((n_periods,) + shape, ("layers",) + axes, init="zeros")
                    for k, (shape, axes) in slot.items()})
    return out


def cache_specs(rules, cfg: ModelConfig, batch: int, max_len: int) -> list:
    """The spec of each leaf of :func:`cache_defs` under a mesh, the layer
    axis leading, as JAX's ``rules.tree_specs(logical_specs(cache_defs))``
    places it: an attention slot's by ``layers.dense_cache_spec`` at its
    kind's :func:`cache_len` (the sequence over "cache_seq" where that
    divides it), an SSM slot's by ``ssm.cache_spec``."""
    out = []
    for mixer, _ in cfg.layer_kinds[:cfg.period]:
        if mixer == "ssm":
            out.append({k: shf.P(None, *s) for k, s in SSM.cache_spec(rules, cfg, batch).items()})
        else:
            T = cache_len(cfg, mixer, max_len)
            spec = shf.P(None, *L.dense_cache_spec(rules, cfg, batch, T))
            out.append({"k": spec, "v": spec})
    return out


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """The dense cache of :func:`cache_defs`, zeros; under a mesh each leaf
    placed by :func:`cache_specs`."""
    rules = active_mesh_rules()
    return zeros_like_defs(cache_defs(cfg, batch, max_len), cfg.dtype, device, rules,
                           None if rules is None else cache_specs(rules, cfg, batch, max_len))


def prefill(cfg: ModelConfig, params, tokens, cache, vision_embeds=None):
    """Prompt (behind an optional ``vision_embeds`` prefix) through the
    model, filling ``cache`` in place from position 0.  Returns the
    last-position logits (B, 1, V)."""
    params = _serving_params(cfg, params)
    h = embed_tokens(cfg, params, tokens, vision_embeds)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=0)
    return _host_logits(unembed(cfg, params, L.apply_norm(cfg, params["final_norm"],
                                                         h[:, -1:])))


def decode_step(cfg: ModelConfig, params, tokens, cache, pos: int):
    """One-token decode at absolute position ``pos``.  tokens: (B, 1)."""
    params = _serving_params(cfg, params)
    h = embed_tokens(cfg, params, tokens)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=pos)
    return _host_logits(unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h)))


# ---------------------------------------------------------------------------
# paged serving


def make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, device):
    """Per-layer paged KV pools: per period slot {k_pages, v_pages} of
    (n_periods, Hkv, num_pages, page_size, dh), shared across requests
    through a page table.  Global-attention stacks only: local layers' rings
    and SSM layers' states have no paged layout, and raise
    :class:`UnsupportedCacheError`, on which the serve launcher runs its
    dense loop."""
    from repro_torch.serving.resilience import UnsupportedCacheError

    for mixer, _ in cfg.layer_kinds:
        if mixer != "attn":
            raise UnsupportedCacheError(
                f"paged serving supports global-attention mixers only, got "
                f"{mixer!r} in layer_kinds")
    if num_pages < 2:
        raise ValueError("num_pages must be >= 2 (page 0 is the sentinel)")
    n_periods = cfg.n_layers // cfg.period
    shape = (n_periods, cfg.n_kv_heads, num_pages, page_size, cfg.resolved_head_dim)
    return [{"k_pages": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v_pages": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.period)]


def prefill_paged(cfg: ModelConfig, params, tokens, cache, page_table, lengths):
    """Prompt prefill into a paged cache (written in place).  tokens: (B, S)
    with S a multiple of the page size; rows past ``lengths`` are pads.
    Returns the logits at position lengths-1, (B, 1, V)."""
    params = _serving_params(cfg, params)
    h = embed_tokens(cfg, params, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=0,
                       paged={"page_table": page_table, "rope": _rope(cfg, positions)})
    logits = _host_logits(unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h)))
    idx = torch.clamp(lengths.long() - 1, 0, logits.shape[1] - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx][:, None]


def decode_step_paged(cfg: ModelConfig, params, tokens, cache, page_table, kv_len):
    """One-token decode over the paged cache.  tokens: (B, 1); kv_len: (B,)
    per-request depths (the new token's position).  Returns (B, 1, V)."""
    params = _serving_params(cfg, params)
    h = embed_tokens(cfg, params, tokens)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=kv_len,
                       paged={"page_table": page_table, "kv_len": kv_len,
                              "rope": _rope(cfg, kv_len[:, None])})
    return _host_logits(unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h)))


def _rope(cfg: ModelConfig, positions):
    """The rotary tables of a paged call's (B, S) positions, once for all
    its layers, which rotate q and k in their page writes."""
    return L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
