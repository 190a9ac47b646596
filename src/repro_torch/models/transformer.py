"""Decoder LM over a periodic layer pattern (torch): global attention with a
dense GLU or an MoE FFN per layer.

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
  forward(cfg, params, tokens)                      -> logits
  forward_with_aux(cfg, params, tokens)             -> (logits, MoE aux loss)
  loss_fn(cfg, params, batch)                       -> (loss, metrics)
  make_cache / prefill / decode_step                 (dense cache)
  make_paged_cache / prefill_paged / decode_step_paged   (paged serving)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sfu

from . import layers as L
from . import moe as MOE
from .common import ModelConfig, ParamDef, compute_params

# ---------------------------------------------------------------------------
# parameter definitions


def _stack(defs: dict, n: int) -> dict:
    return {k: (ParamDef((n,) + v.shape, v.init, v.matrix) if isinstance(v, ParamDef)
                else _stack(v, n))
            for k, v in defs.items()}


def moe_defs(cfg: ModelConfig) -> dict:
    """The MoE FFN.  The router is no matrix of the model dtype: it stays f32
    in the serving tree too, as routing reads it (``moe.route``); rounding
    it would change which experts are chosen."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": ParamDef((D, E), init="small_normal", matrix=False),
        "w_gate": ParamDef((E, D, Fe)),
        "w_up": ParamDef((E, D, Fe)),
        "w_down": ParamDef((E, Fe, D)),
    }


def norm_defs(cfg: ModelConfig) -> dict:
    """A norm's parameters, f32 (the JAX package reads them in f32)."""
    D = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": ParamDef((D,), init="zeros", matrix=False)}
    if cfg.norm_type == "layernorm":
        return {"scale": ParamDef((D,), init="ones", matrix=False),
                "bias": ParamDef((D,), init="zeros", matrix=False)}
    raise NotImplementedError(f"norm_type {cfg.norm_type!r} is not ported yet")


def attn_defs(cfg: ModelConfig) -> dict:
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((D, H, dh)),
        "wk": ParamDef((D, Hkv, dh)),
        "wv": ParamDef((D, Hkv, dh)),
        "wo": ParamDef((H, dh, D)),
    }


def mlp_defs(cfg: ModelConfig) -> dict:
    """A dense FFN: the GLU's two input projections, or a plain MLP with
    biases (held in the model dtype: the JAX package casts them to it at
    each use)."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": ParamDef((D, F)), "w_up": ParamDef((D, F)),
                "w_down": ParamDef((F, D))}
    return {"w_in": ParamDef((D, F)), "b_in": ParamDef((F,), init="zeros"),
            "w_down": ParamDef((F, D)), "b_down": ParamDef((D,), init="zeros")}


def block_defs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    if mixer != "attn" or ffn not in ("dense", "moe"):
        raise NotImplementedError(
            f"layer kind ({mixer}, {ffn}) is not ported yet (global attention only)")
    if cfg.qkv_bias:
        raise NotImplementedError(f"config {cfg.name!r} needs qkv biases, not ported yet")
    return {
        "ln1": norm_defs(cfg),
        "ln2": norm_defs(cfg),
        "mixer": attn_defs(cfg),
        "ffn": moe_defs(cfg) if ffn == "moe" else mlp_defs(cfg),
    }


def model_defs(cfg: ModelConfig) -> dict:
    kinds = cfg.layer_kinds
    period = cfg.period
    n_periods = cfg.n_layers // period
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), init="small_normal"),
        "final_norm": norm_defs(cfg),
        "layers": [_stack(block_defs(cfg, *kinds[j]), n_periods) for j in range(period)],
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.padded_vocab))
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


def block_apply(cfg: ModelConfig, p, h, ffn: str, cache=None, pos=None, plan=None,
                paged=None):
    """Pre-norm residual block.  Returns (h, cache, aux): ``aux`` is the MoE
    layer's load-balancing loss, None for a dense FFN (which adds 0)."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    hn = L.apply_norm(cfg, p["ln1"], h)
    y, cache = L.attention_layer(cfg, p["mixer"], hn, cache=cache, cache_pos=pos,
                                 plan=plan, paged=paged)
    h = h + y
    hn2 = L.apply_norm(cfg, p["ln2"], h)
    if ffn == "moe":
        y2, aux = MOE.moe_layer(cfg, p["ffn"], hn2, plan=plan)
    else:
        y2, aux = L.mlp(cfg, p["ffn"], hn2, plan=plan), None
    return h + y2, cache, aux


def embed_tokens(cfg: ModelConfig, params, tokens):
    """(B, S) int tokens -> (B, S, D) in cfg.dtype (an index gather; the JAX
    package's one-hot contraction for short inputs gives the same values)."""
    return params["embed"][tokens.long()].to(cfg.dtype)


def unembed(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"])
    else:
        logits = h @ params["unembed"]
    logits = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:  # mask pad ids out of the softmax
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits - pad.to(torch.float32) * 1e9
    return logits


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
    for i in range(n_periods):
        def period_fn(h, aux, i=i):
            for j in range(period):
                c = _layer(cache[j], i) if cache is not None else None
                h, _, a = block_apply(cfg, stacks[j][i], h, kinds[j][1], cache=c, pos=pos,
                                      plan=plan, paged=paged)
                if a is not None:
                    aux = aux + a
            return h, aux

        h, aux = (checkpoint(period_fn, h, aux, use_reentrant=False) if remat
                  else period_fn(h, aux))
    return h, aux


def forward_with_aux(cfg: ModelConfig, params, tokens):
    """Teacher-forcing forward -> ((B, S, padded_vocab) f32 logits, the f32
    MoE aux loss summed over layers).

    ``params`` may be the serving tree or the f32 training masters: every
    matrix is cast to ``cfg.dtype`` first (differentiably).  Under
    ``cfg.remat`` with grad enabled, each period is recomputed in the
    backward."""
    params = compute_params(model_defs(cfg), params, cfg.dtype)
    h = embed_tokens(cfg, params, tokens)
    h, aux = _run_layers(cfg, params, h, remat=cfg.remat and torch.is_grad_enabled())
    return unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h)), aux


def forward(cfg: ModelConfig, params, tokens):
    """Teacher-forcing forward -> (B, S, padded_vocab) f32 logits."""
    return forward_with_aux(cfg, params, tokens)[0]


def sharded_cross_entropy(logits, targets, mask=None):
    """Mean next-token cross entropy, the JAX package's formula: a
    stop-gradient row max, a logsumexp, and the target logit picked by a
    compare-and-sum over the vocab (no gather)."""
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
    ``tokens``, ``targets`` (B, S) int, optional ``mask``.  Returns
    ``(loss, {"nll", "aux"})``; a dense model's ``aux`` is 0 and its loss
    the nll."""
    logits, aux = forward_with_aux(cfg, params, batch["tokens"])
    nll = sharded_cross_entropy(logits, batch["targets"].long(), batch.get("mask"))
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# dense cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Dense KV cache: per period slot {k, v} of (n_periods, B, T, Hkv, dh)."""
    n_periods = cfg.n_layers // cfg.period
    shape = (n_periods, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.period)]


def prefill(cfg: ModelConfig, params, tokens, cache):
    """Prompt through the model, filling ``cache`` in place.  Returns the
    last-position logits (B, 1, V)."""
    h = embed_tokens(cfg, params, tokens)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=0)
    return unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h[:, -1:]))


def decode_step(cfg: ModelConfig, params, tokens, cache, pos: int):
    """One-token decode at absolute position ``pos``.  tokens: (B, 1)."""
    h = embed_tokens(cfg, params, tokens)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=pos)
    return unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h))


# ---------------------------------------------------------------------------
# paged serving


def make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, device):
    """Per-layer paged KV pools: per period slot {k_pages, v_pages} of
    (n_periods, Hkv, num_pages, page_size, dh), shared across requests
    through a page table.  Global-attention stacks only."""
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
    h = embed_tokens(cfg, params, tokens)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=0,
                       paged={"page_table": page_table})
    logits = unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h))
    idx = torch.clamp(lengths.long() - 1, 0, logits.shape[1] - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx][:, None]


def decode_step_paged(cfg: ModelConfig, params, tokens, cache, page_table, kv_len):
    """One-token decode over the paged cache.  tokens: (B, 1); kv_len: (B,)
    per-request depths (the new token's position).  Returns (B, 1, V)."""
    h = embed_tokens(cfg, params, tokens)
    h, _ = _run_layers(cfg, params, h, cache=cache, pos=kv_len,
                       paged={"page_table": page_table, "kv_len": kv_len})
    return unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h))
