"""Model layers (torch): RMSNorm, RoPE, attention, GLU MLP.

The dense subset of ``repro/models/layers.py`` that the serving path of a
dense decoder runs.  Every nonlinearity resolves through the compiled
``sfu.ActivationPlan``; an ``mlp`` site planned ``impl="fused"`` runs the
fused GLU kernel (``kernels/fused/glu.py``).  Attention uses exact ``exp``
unless the plan has an ``attn.softmax:exp`` site, which is then evaluated
elementwise; planned ``impl="fused"`` it raises off the CPU (the fused
PWL-exp attention kernels are not ported yet).

Masking follows the JAX package: masked scores are filled with ``-1e30``
before the row max, masked probabilities are zeroed, and the row sum is
clamped at ``1e-30``.  Tensor layouts are the JAX package's: q is
(B, S, H, dh), k/v are (B, T, Hkv, dh), ``wq`` (D, H, dh), ``wo`` (H, dh, D).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch import sfu
from repro_torch.kernels import fused
from repro_torch.serving import kv_cache as _pg

from .common import ModelConfig

# ---------------------------------------------------------------------------
# norms / rotary embeddings


def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def apply_norm(cfg: ModelConfig, params, x):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    raise NotImplementedError(f"norm_type {cfg.norm_type!r} is not ported yet")


def rope(x, positions, theta: float):
    """x: (..., S, H, dh), positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# softmax exp


def _softmax_safe_exp(raw: Callable) -> Callable:
    """Clamp a PWL exp so softmax stays safe: inputs at >= -30 (mask fills
    would overflow the table's linear tail), outputs at >= 0."""
    def pwl_exp(x):
        return torch.clamp(raw(torch.clamp(x, min=-30.0)), min=0.0)

    return pwl_exp


def resolve_exp(cfg: ModelConfig, plan=None, device=None) -> Callable:
    """Elementwise exp for attention softmax: exact, or the plan's PWL exp.

    A softmax site planned ``impl="fused"`` needs the fused PWL-exp attention
    kernels, which are not ported yet: on the CPU it runs elementwise (their
    plain version) and warns once; on any other device it raises."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    key = sfu.site_key(sfu.SITE_SOFTMAX, "exp")
    spec = plan.get(key)
    if spec is None or spec.is_exact:
        return torch.exp
    if spec.impl == "fused":
        if device is not None and torch.device(device).type != "cpu":
            raise NotImplementedError(
                f"site '{key}' is planned impl='fused', but the fused PWL-exp attention "
                f"kernels are not ported to {torch.device(device).type} yet (see ROADMAP); "
                "plan the site impl='jnp' or 'exact', or run on the CPU")
        sfu.warn_fused_fallback(key, "the fused PWL-exp attention kernels are not ported yet")
    return _softmax_safe_exp(sfu.resolve_spec(spec))


# ---------------------------------------------------------------------------
# attention


def flash_attention(q, k, v, *, causal: bool = True, exp_fn: Callable = torch.exp,
                    q_chunk: int = 256, kv_valid_len=None):
    """Masked softmax attention in f32, one q chunk at a time.

    q: (B, S, H, dh); k/v: (B, T, Hkv, dh); ``kv_valid_len``: None or (B,)
    valid key prefix per row.  GQA folds heads as (Hkv major, G minor).
    Returns (B, S, H, dh) in q's dtype."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    kf = k.to(torch.float32).permute(0, 2, 1, 3)  # (B, Hkv, T, dh)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    kpos = torch.arange(T, device=dev)
    outs = []
    for s0 in range(0, S, q_chunk):
        qc = q[:, s0:s0 + q_chunk].to(torch.float32)
        Sc = qc.shape[1]
        qc = qc.reshape(B, Sc, Hkv, G, dh).permute(0, 3, 2, 1, 4)  # (B, G, Hkv, Sc, dh)
        s = torch.einsum("bghqd,bhkd->bghqk", qc, kf) * scale
        qpos = s0 + torch.arange(Sc, device=dev)
        mask = torch.ones((Sc, T), dtype=torch.bool, device=dev)
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
        if kv_valid_len is not None:
            mask = mask[None] & (kpos[None, None, :] < kv_valid_len[:, None, None])
            mask = mask[:, None, None]
        else:
            mask = mask[None, None, None]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, exp_fn(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bghqk,bhkd->bghqd", p, vf) / torch.clamp(l, min=1e-30)
        outs.append(o.permute(0, 3, 2, 1, 4).reshape(B, Sc, H, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid, exp_fn: Callable = torch.exp):
    """Single-position attention over a cache.  q: (B, 1, H, dh);
    k/v_cache: (B, T, Hkv, dh); valid: (B, T) bool."""
    B, _, H, dh = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.to(torch.float32).reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k_cache.to(torch.float32)) * scale
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vm, exp_fn(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhgt,bthd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, dh).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len,
                           exp_fn: Callable = torch.exp):
    """Single-position attention over a paged cache: gather the table's pages
    into logical order, then :func:`decode_attention` over the ``kv_len``
    prefix.  q: (B, 1, H, dh); pools (Hkv, P, ps, dh); kv_len: (B,)."""
    k_dense = _pg.gather_pages(k_pages, page_table)
    v_dense = _pg.gather_pages(v_pages, page_table)
    T = k_dense.shape[1]
    valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]
    return decode_attention(q, k_dense, v_dense, valid, exp_fn)


# ---------------------------------------------------------------------------
# MLP


def _fused_mlp_hidden(cfg: ModelConfig, params, x, plan):
    """Hidden state from the fused GLU kernel when the ``mlp`` site is
    planned ``impl="fused"``; None otherwise."""
    key = sfu.site_key(sfu.SITE_MLP, cfg.activation)
    table = plan.fused_table(key)
    if table is None:
        return None
    if cfg.mlp_type not in ("swiglu", "geglu"):
        raise NotImplementedError(f"fused {cfg.mlp_type!r} MLP is not ported yet")
    return fused.fused_glu(x, params["w_gate"], params["w_up"], table=table)


def mlp(cfg: ModelConfig, params, x, plan=None):
    """Dense GLU FFN; activation via the plan's ``mlp:<activation>`` site."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    h = _fused_mlp_hidden(cfg, params, x, plan)
    if h is None:
        if cfg.mlp_type not in ("swiglu", "geglu"):
            raise NotImplementedError(f"{cfg.mlp_type!r} MLP is not ported yet")
        act = plan.act(sfu.site_key(sfu.SITE_MLP, cfg.activation))
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# attention layer


def attention_layer(cfg: ModelConfig, params, x, *, cache=None, cache_pos=None,
                    plan=None, paged=None):
    """Returns (y, cache).  ``cache`` is a dense {k, v} layer cache (B, T,
    Hkv, dh) or a paged {k_pages, v_pages} layer pool (Hkv, P, ps, dh); both
    are written in place.  ``cache_pos`` is the write offset: an int, or (B,)
    per-request depths (continuous batching).  ``paged`` holds the shared
    ``page_table`` (and ``kv_len`` when decoding)."""
    B, S, D = x.shape
    plan = plan if plan is not None else sfu.plan_for(cfg)
    exp_fn = resolve_exp(cfg, plan, x.device)

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])

    off = 0 if cache_pos is None else cache_pos
    ar = torch.arange(S, device=x.device)
    if torch.is_tensor(off) and off.dim() == 1:  # per-request depths (serving)
        positions = off[:, None] + ar[None, :]
    else:
        positions = ar[None, :] + off
    positions = positions.expand(B, S)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None and "k_pages" in cache:
        page_table = paged["page_table"]
        if S == 1:
            # decode: append at kv_len, then attend the kv_len+1 prefix
            kv_len = paged["kv_len"]
            _pg.append_kv_(cache["k_pages"], cache["v_pages"], k, v, page_table, kv_len)
            y = paged_decode_attention(q, cache["k_pages"], cache["v_pages"],
                                       page_table, kv_len + 1, exp_fn)
        else:
            # prefill: write the prompt's pages, attend causally in flight
            _pg.write_prompt_pages_(cache["k_pages"], cache["v_pages"], k, v, page_table)
            y = flash_attention(q, k, v, causal=True, exp_fn=exp_fn)
    elif cache is not None:
        T = cache["k"].shape[1]
        pos0 = int(off)
        cache["k"][:, pos0:pos0 + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos0:pos0 + S] = v.to(cache["v"].dtype)
        if S == 1:
            valid = (torch.arange(T, device=x.device)[None, :] <= pos0).expand(B, T)
            y = decode_attention(q, cache["k"], cache["v"], valid, exp_fn)
        else:
            y = flash_attention(q, k, v, causal=True, exp_fn=exp_fn)
    else:
        y = flash_attention(q, k, v, causal=True, exp_fn=exp_fn)

    out = torch.einsum("bshk,hkd->bsd", y, params["wo"])
    return out, cache
