"""Whisper-style encoder-decoder (torch port of ``repro/models/encdec.py``).

The conv/mel frontend is a stub: the caller supplies frame embeddings
(B, encoder_seq, d_model).  The backbone is the JAX package's: a
bidirectional encoder, a causal decoder with cross-attention, LayerNorm,
biased MLPs whose activation resolves through the compiled plan (a site
planned ``impl="fused"`` runs the fused linear kernel), sinusoidal
positions, no RoPE.  Every attention goes through
``layers.attention_layer``, so a plan with the ``attn.softmax:exp`` site
fused runs the encoder's and the cross-attention's softmax in the fused
kernels too (non-causal: the row softmax while the scores fit the dense
cap, the flash kernels past it).

Parameters keep the JAX package's tree: ``{"embed", "enc_final_norm",
"final_norm", "encoder", "decoder", "unembed"}`` with the encoder and
decoder layers stacked ``(n_layers, ...)``.  The dense cache holds per layer
the decoder's self-attention K/V and the encoder output's cross K/V
(``xk``/``xv``), written in place by :func:`prefill`.  Under ``cfg.remat``
a training forward recomputes each layer in the backward.

API (functions over a params tree):
  encdec_defs(cfg)                               -> ParamDef tree
  encode(cfg, params, frames)                    -> encoder output
  forward(cfg, params, tokens, frames)           -> logits
  loss_fn(cfg, params, batch)                    -> (loss, metrics)
  make_cache / prefill(..., frames) / decode_step  (dense cache)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sfu
from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed.sharding import active_mesh_rules, constrain, is_dtensor

from . import layers as L
from .common import ModelConfig, ParamDef, compute_params, gather_layer, zeros_like_defs
from .transformer import (
    _host_logits,
    _layer,
    _stack,
    _unbind,
    attn_defs,
    embed_tokens,
    mlp_defs,
    norm_defs,
    sharded_cross_entropy,
    unembed,
)


def _enc_layer_defs(cfg: ModelConfig) -> dict:
    return {"ln1": norm_defs(cfg), "mixer": attn_defs(cfg), "ln2": norm_defs(cfg),
            "ffn": mlp_defs(cfg)}


def _dec_layer_defs(cfg: ModelConfig) -> dict:
    return {"ln1": norm_defs(cfg), "self": attn_defs(cfg), "ln_x": norm_defs(cfg),
            "cross": attn_defs(cfg), "ln2": norm_defs(cfg), "ffn": mlp_defs(cfg)}


def encdec_defs(cfg: ModelConfig) -> dict:
    enc_layer, dec_layer = _enc_layer_defs(cfg), _dec_layer_defs(cfg)
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="small_normal"),
        "enc_final_norm": norm_defs(cfg),
        "final_norm": norm_defs(cfg),
        "encoder": _stack(enc_layer, cfg.n_encoder_layers),
        "decoder": _stack(dec_layer, cfg.n_layers),
        "unembed": ParamDef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
    }


def _alike(t, like):
    """``t`` (alike on every rank) as a replicated DTensor when ``like`` is
    a DTensor (the positions added to a sharded activation)."""
    return shf.replicated(t, like.device_mesh) if is_dtensor(like) else t


def _project_kv(h, p):
    """Keys and values of ``h`` through an attention block's projections."""
    return (torch.einsum("bsd,dhk->bshk", h, p["wk"]),
            torch.einsum("bsd,dhk->bshk", h, p["wv"]))


def _layers(fn, h, stack, n: int, remat: bool, defs: dict):
    """``h`` through ``fn(h, layer_params, i)`` for each of the ``n`` stacked
    layers, each recomputed in the backward under ``remat``; under a mesh
    each layer's FSDP rows are gathered where it runs (``defs``: a layer's
    ParamDef tree)."""
    sharded = is_dtensor(h)
    for i, p in enumerate(_unbind(stack, n)):
        def layer_fn(h, p=p, i=i):
            return fn(h, gather_layer(defs, p) if sharded else p, i)

        h = checkpoint(layer_fn, h, use_reentrant=False) if remat else layer_fn(h)
    return h


def encode(cfg: ModelConfig, params, frames, remat: bool = False):
    """frames: (B, encoder_seq, D) stub embeddings -> the encoder output."""
    plan = sfu.plan_for(cfg)
    h = frames.to(cfg.dtype)
    rules = active_mesh_rules()
    if rules is not None and not is_dtensor(h):  # frames alike on every rank
        h = shf.replicated(h, rules.mesh)
    h = h + _alike(L.sinusoidal_positions(h.shape[1], cfg.d_model, h.device).to(cfg.dtype), h)
    h = constrain(h, "batch", "act_seq", "act_embed")

    def layer_fn(h, p, i):
        # bidirectional: the self-projected k/v go through the unmasked
        # cross_kv path of attention_layer
        hn = L.apply_norm(cfg, p["ln1"], h)
        y, _ = L.attention_layer(cfg, p["mixer"], hn, cross_kv=_project_kv(hn, p["mixer"]),
                                 use_rope=False, plan=plan)
        h = h + y
        return h + L.mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], h), plan=plan)

    h = _layers(layer_fn, h, params["encoder"], cfg.n_encoder_layers, remat,
                _enc_layer_defs(cfg))
    return L.apply_norm(cfg, params["enc_final_norm"], h)


def _decoder_pass(cfg: ModelConfig, params, tokens, enc_out, cache=None, pos: int = 0,
                  remat: bool = False):
    """The decoder's hidden states before the final norm.  ``cache`` None is
    teacher forcing; with a cache, ``enc_out`` given is a prefill (the cross
    K/V are written to the cache), ``enc_out`` None a decode step (they are
    read from it)."""
    plan = sfu.plan_for(cfg)
    h = embed_tokens(cfg, params, tokens)
    S = h.shape[1]
    h = h + _alike(L.sinusoidal_positions(pos + S, cfg.d_model, h.device)[pos:].to(cfg.dtype), h)
    h = constrain(h, "batch", "act_seq", "act_embed")

    def layer_fn(h, p, i):
        lc = _layer(cache, i) if cache is not None else None
        self_cache = None if lc is None else {"k": lc["k"], "v": lc["v"]}
        hn = L.apply_norm(cfg, p["ln1"], h)
        y, _ = L.attention_layer(cfg, p["self"], hn, use_rope=False, cache=self_cache,
                                 cache_pos=pos, plan=plan)
        h = h + y
        hx = L.apply_norm(cfg, p["ln_x"], h)
        if enc_out is not None:  # train or prefill: project the encoder output
            ck, cv = _project_kv(enc_out, p["cross"])
            if lc is not None:
                lc["xk"].copy_(ck)
                lc["xv"].copy_(cv)
        else:  # decode: the cached cross K/V
            ck, cv = lc["xk"], lc["xv"]
        y, _ = L.attention_layer(cfg, p["cross"], hx, cross_kv=(ck, cv), use_rope=False,
                                 plan=plan)
        h = h + y
        return h + L.mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], h), plan=plan)

    return _layers(layer_fn, h, params["decoder"], cfg.n_layers, remat, _dec_layer_defs(cfg))


def forward(cfg: ModelConfig, params, tokens, frames):
    """Teacher-forcing forward -> (B, S, padded_vocab) f32 logits.

    ``params`` may be the serving tree or the f32 training masters: every
    matrix is cast to ``cfg.dtype`` first (differentiably).  Under
    ``cfg.remat`` with grad enabled, each layer is recomputed in the
    backward."""
    params = compute_params(encdec_defs(cfg), params, cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    enc_out = encode(cfg, params, frames, remat=remat)
    h = _decoder_pass(cfg, params, tokens, enc_out, remat=remat)
    return unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h))


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross entropy of the decoder.  batch: ``tokens``,
    ``targets`` (B, S) int, ``frames`` (B, encoder_seq, D), optional
    ``mask``.  Returns ``(loss, {"nll", "aux"})`` with ``aux`` 0."""
    logits = forward(cfg, params, batch["tokens"], batch["frames"])
    nll = sharded_cross_entropy(logits, batch["targets"].long(), batch.get("mask"))
    return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32, device=nll.device)}


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The dense cache's ParamDef tree (zeros, held in ``cfg.dtype``) with
    the JAX package's logical axes: {k, v} (L, B, max_len, Hkv, dh) of the
    decoder's self-attention, {xk, xv} (L, B, encoder_seq, Hkv, dh) of its
    cross-attention."""
    Hkv, dh, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    self_axes = ("layers", "batch", "cache_seq", "cache_kv", None)
    cross_axes = ("layers", "batch", None, "cache_kv", None)
    return {"k": ParamDef((nl, batch, max_len, Hkv, dh), self_axes, init="zeros"),
            "v": ParamDef((nl, batch, max_len, Hkv, dh), self_axes, init="zeros"),
            "xk": ParamDef((nl, batch, cfg.encoder_seq, Hkv, dh), cross_axes, init="zeros"),
            "xv": ParamDef((nl, batch, cfg.encoder_seq, Hkv, dh), cross_axes, init="zeros")}


def cache_specs(rules, cfg: ModelConfig, batch: int) -> dict:
    """The spec of each leaf of :func:`cache_defs` under a mesh:
    ``layers.dense_cache_spec`` behind the layer axis (the per-shard dense
    body writes and reads {k, v}; the cross-attention reads {xk, xv} on the
    same batch rows and KV heads)."""
    spec = shf.P(None, *L.dense_cache_spec(rules, cfg, batch))
    return {k: spec for k in ("k", "v", "xk", "xv")}


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """The dense cache of :func:`cache_defs`, zeros; under a mesh each leaf
    placed by :func:`cache_specs`."""
    rules = active_mesh_rules()
    return zeros_like_defs(cache_defs(cfg, batch, max_len), cfg.dtype, device, rules,
                           None if rules is None else cache_specs(rules, cfg, batch))


def _serving_params(cfg: ModelConfig, params):
    """Under a mesh, the serving tree with its FSDP rows gathered outside
    the layer stacks (each layer gathers its own where it runs); as it is
    otherwise."""
    if active_mesh_rules() is None:
        return params
    return compute_params(encdec_defs(cfg), params, cfg.dtype)


def prefill(cfg: ModelConfig, params, tokens, cache, frames):
    """Encode the frames and run the decoder prompt, filling the self- and
    cross-attention caches in place.  Returns the last position's logits
    (B, 1, V), whole on every rank under a mesh."""
    params = _serving_params(cfg, params)
    enc_out = encode(cfg, params, frames)
    h = _decoder_pass(cfg, params, tokens, enc_out, cache=cache, pos=0)
    return _host_logits(unembed(cfg, params, L.apply_norm(cfg, params["final_norm"],
                                                         h[:, -1:])))


def decode_step(cfg: ModelConfig, params, tokens, cache, pos: int):
    """One-token decode at absolute position ``pos``.  tokens: (B, 1)."""
    params = _serving_params(cfg, params)
    h = _decoder_pass(cfg, params, tokens, None, cache=cache, pos=pos)
    return _host_logits(unembed(cfg, params, L.apply_norm(cfg, params["final_norm"], h)))
