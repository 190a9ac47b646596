"""Model layers (torch): RMSNorm, LayerNorm, RoPE, sinusoidal positions,
attention (self and cross), GLU and plain MLPs.

The subset of ``repro/models/layers.py`` that the dense decoders and the
encoder-decoder run.  Every nonlinearity resolves through the compiled
``sfu.ActivationPlan``; an ``mlp`` site planned ``impl="fused"`` runs the
fused GLU kernel (``kernels/fused/glu.py``), or for a plain MLP the fused
linear kernel (``kernels/fused/linear.py``); a site planned
``impl="kernel"`` runs the standalone PWL kernel (``kernels/ops.py``).
Attention uses exact ``exp`` unless the plan has an ``attn.softmax:exp``
site: planned ``impl="fused"`` its softmax runs in the fused PWL-exp
kernels (the row softmax, the split-KV paged decode, or the flash
attention, chosen by shape as the JAX package chooses), otherwise the PWL
exp is evaluated elementwise.

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


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_norm(cfg: ModelConfig, params, x):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    if cfg.norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
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


def sinusoidal_positions(seq_len: int, d_model: int, device=None):
    """(seq_len, d_model) f32: sin on the even columns, cos on the odd."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# ---------------------------------------------------------------------------
# softmax exp


def _softmax_safe_exp(raw: Callable) -> Callable:
    """Clamp a PWL exp so softmax stays safe: inputs at >= -30 (mask fills
    would overflow the table's linear tail), outputs at >= 0."""
    def pwl_exp(x):
        return torch.clamp(raw(torch.clamp(x, min=-30.0)), min=0.0)

    return pwl_exp


def resolve_exp(cfg: ModelConfig, plan=None) -> Callable:
    """Elementwise exp for the unfused attention softmax: exact, or the
    plan's PWL exp.  A site planned ``impl="fused"`` takes the fused
    kernels instead (:func:`_softmax_fused_table`)."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    spec = plan.get(sfu.site_key(sfu.SITE_SOFTMAX, "exp"))
    if spec is not None and not spec.is_exact:
        return _softmax_safe_exp(sfu.resolve_spec(spec))
    return torch.exp


# Crossover between the two fused executors, kept from the JAX package: it
# picks which chain of PWL corrections is computed (one dense softmax per row,
# or the flash kernel's 512-key blocks), so it is part of the function, not
# only of its speed.  The dense path holds B*H*S*T f32 scores, a row at most
# 32768 wide; past the cap, training takes the flash kernels forward and
# backward (the backward is the dense oracle's gradient, as in JAX).
DENSE_FUSED_SOFTMAX_MAX_SCORES = 1 << 27
DENSE_FUSED_SOFTMAX_MAX_WIDTH = 32768


def _softmax_fused_table(plan):
    """The exp table of the fused PWL-exp softmax kernels, or None when the
    ``attn.softmax:exp`` site is absent or not planned ``impl="fused"``."""
    key = sfu.site_key(sfu.SITE_SOFTMAX, "exp")
    spec = plan.get(key)
    if spec is None or spec.impl != "fused":
        return None
    return plan.fused_table(key)


def _dense_softmax_preferred(n_scores: int, width: int, window, kv_len: int) -> bool:
    """True when the dense fused-softmax kernel runs these shapes: the score
    tensor fits the dense cap, a row fits the kernel's width, and any
    sliding window covers at least half the KV."""
    if window is not None and kv_len > 2 * window:
        return False
    return (n_scores <= DENSE_FUSED_SOFTMAX_MAX_SCORES
            and width <= DENSE_FUSED_SOFTMAX_MAX_WIDTH)


# ---------------------------------------------------------------------------
# attention


def _chunk_attn_block(q, k, v, mask, exp_fn, m_prev, l_prev, acc_prev, scale):
    """One online-softmax update, all f32.  q: (B, G, Hkv, Sq, dh);
    k/v: (B, Hkv, Skv, dh); mask broadcastable to (B, G, Hkv, Sq, Skv)."""
    s = torch.einsum("bghqd,bhkd->bghqk", q, k) * scale
    s = torch.where(mask, s, -1e30)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.where(mask, exp_fn(s - m_new[..., None]), 0.0)
    corr = exp_fn(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    acc_new = acc_prev * corr[..., None] + torch.einsum("bghqk,bhkd->bghqd", p, v)
    return m_new, l_new, acc_new


def flash_attention(q, k, v, *, causal: bool = True, exp_fn: Callable = torch.exp,
                    q_chunk: int = 256, kv_chunk: int = 2048, kv_valid_len=None):
    """Chunked online-softmax attention in f32, the JAX package's chunking.

    q: (B, S, H, dh); k/v: (B, T, Hkv, dh); ``kv_valid_len``: None or (B,)
    valid key prefix per row.  Causal self-attention with S == T takes one
    block per q chunk over its causal prefix (q chunks sized so there are at
    most 16); everything else walks ``kv_chunk``-key blocks with ``exp_fn``
    applied to the running-max correction at each block boundary, which
    changes the numbers under a PWL exp.  GQA folds heads as (Hkv major, G
    minor).  Returns (B, S, H, dh) in q's dtype."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    self_causal = causal and S == T and kv_valid_len is None
    if self_causal:
        q_chunk = max(q_chunk, -(-S // 16))
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    n_q = -(-S // q_chunk)
    unroll = self_causal and n_q <= 16 and S % q_chunk == 0
    kf = k.to(torch.float32).permute(0, 2, 1, 3)  # (B, Hkv, T, dh)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    outs = []
    for s0 in range(0, S, q_chunk):
        qc = q[:, s0:s0 + q_chunk].to(torch.float32)
        Sc = qc.shape[1]
        qc = qc.reshape(B, Sc, Hkv, G, dh).permute(0, 3, 2, 1, 4)  # (B, G, Hkv, Sc, dh)
        qpos = s0 + torch.arange(Sc, device=dev)
        # the causal unroll: one block over the chunk's causal prefix
        blocks = [(0, s0 + q_chunk)] if unroll else [
            (j0, min(j0 + kv_chunk, T)) for j0 in range(0, T, kv_chunk)]
        m = torch.full((B, G, Hkv, Sc), -1e30, device=dev)
        l = torch.zeros((B, G, Hkv, Sc), device=dev)
        acc = torch.zeros((B, G, Hkv, Sc, dh), device=dev)
        for j0, j1 in blocks:
            kpos = torch.arange(j0, j1, device=dev)
            mask = torch.ones((Sc, j1 - j0), dtype=torch.bool, device=dev)
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            if kv_valid_len is not None:
                mask = mask[None] & (kpos[None, None, :] < kv_valid_len[:, None, None])
                mask = mask[:, None, None]
            else:
                mask = mask[None, None, None]
            m, l, acc = _chunk_attn_block(qc, kf[:, :, j0:j1], vf[:, :, j0:j1], mask,
                                          exp_fn, m, l, acc, scale)
        o = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 2, 1, 4).reshape(B, Sc, H, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def dense_pwl_attention(q, k, v, *, table, causal: bool = True):
    """Dense attention with the fused PWL-exp softmax kernel (Sec. V-B).

    q: (B, S, H, dh); k/v: (B, T, Hkv, dh).  The scores and the product with
    V are ``torch.einsum`` (the JAX package leaves them to XLA); the softmax
    runs as one kernel over the score rows, with the causal mask made inside
    it from positions."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.to(torch.float32).reshape(B, S, Hkv, G, dh).permute(0, 3, 2, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)  # (B, Hkv, T, dh)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    s = torch.einsum("bghqd,bhkd->bghqk", qf, kf) * scale
    p = fused.fused_pwl_softmax(s, table=table, causal=causal)
    out = torch.einsum("bghqk,bhkd->bghqd", p, vf)
    return out.permute(0, 3, 2, 1, 4).reshape(B, S, H, dh).to(q.dtype)


def _attn_softmax_dispatch(q, k, v, *, causal: bool, exp_fn: Callable, table):
    """Attention for prefill and training.  With a fused softmax ``table`` it
    always runs fused: the dense PWL-exp softmax kernel while the scores fit
    its caps, the fused flash kernel past them (long-context prefill and
    training; both take gradients, each the JAX package's).  Otherwise
    :func:`flash_attention` with the (possibly PWL) elementwise ``exp_fn``."""
    if table is None:
        return flash_attention(q, k, v, causal=causal, exp_fn=exp_fn)
    B, S, H = q.shape[:3]
    T = k.shape[1]
    if _dense_softmax_preferred(B * H * S * T, T, None, T):
        return dense_pwl_attention(q, k, v, table=table, causal=causal)
    return fused.fused_flash_attention(q, k, v, table=table, causal=causal)


def _decode_attention_fused(q, k_cache, v_cache, valid, table):
    """Fused decode over a dense cache: the dense PWL-exp softmax kernel
    with ``valid`` as its mask while a cache row fits its width, the fused
    flash kernel with the valid prefix length for wider caches."""
    B, _, H, dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    if T > DENSE_FUSED_SOFTMAX_MAX_WIDTH:
        return fused.fused_flash_attention(q, k_cache, v_cache, table=table, causal=False,
                                           kv_valid_len=valid.sum(dim=-1))
    scale = 1.0 / math.sqrt(dh)
    qf = q.to(torch.float32).reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k_cache.to(torch.float32)) * scale
    p = fused.fused_pwl_softmax(s, table=table, mask=valid[:, None, None, :])
    out = torch.einsum("bhgt,bthd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid, exp_fn: Callable = torch.exp,
                     softmax_table=None):
    """Single-position attention over a cache.  q: (B, 1, H, dh);
    k/v_cache: (B, T, Hkv, dh); valid: (B, T) bool, a prefix per row.  With
    ``softmax_table`` (the softmax site planned fused) the softmax runs in
    the fused kernels; otherwise elementwise with ``exp_fn``."""
    if softmax_table is not None:
        return _decode_attention_fused(q, k_cache, v_cache, valid, softmax_table)
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
                           exp_fn: Callable = torch.exp, softmax_table=None):
    """Single-position attention over a paged cache.  q: (B, 1, H, dh);
    pools (Hkv, P, ps, dh); kv_len: (B,).  With ``softmax_table`` the
    split-KV kernel reads K/V through the page table; otherwise the table's
    pages are gathered into logical order and :func:`decode_attention` runs
    over the ``kv_len`` prefix."""
    if softmax_table is not None:
        return fused.paged_flash_decode(q, k_pages, v_pages, page_table, kv_len,
                                        table=softmax_table)
    k_dense = _pg.gather_pages(k_pages, page_table)
    v_dense = _pg.gather_pages(v_pages, page_table)
    T = k_dense.shape[1]
    valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]
    return decode_attention(q, k_dense, v_dense, valid, exp_fn)


# ---------------------------------------------------------------------------
# MLP


def _fused_mlp_hidden(cfg: ModelConfig, params, x, plan):
    """Hidden state from the fused GLU kernel (or, for a plain MLP, the
    fused linear kernel with its bias) when the ``mlp`` site is planned
    ``impl="fused"``; None otherwise."""
    key = sfu.site_key(sfu.SITE_MLP, cfg.activation)
    table = plan.fused_table(key)
    if table is None:
        return None
    if cfg.mlp_type in ("swiglu", "geglu"):
        return fused.fused_glu(x, params["w_gate"], params["w_up"], table=table)
    return fused.fused_linear(x, params["w_in"], params.get("b_in"), table=table)


def mlp(cfg: ModelConfig, params, x, plan=None):
    """Dense FFN: swiglu / geglu, or a plain (biased) MLP; activation via the
    plan's ``mlp:<activation>`` site."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    h = _fused_mlp_hidden(cfg, params, x, plan)
    if h is None:
        act = plan.act(sfu.site_key(sfu.SITE_MLP, cfg.activation))
        if cfg.mlp_type in ("swiglu", "geglu"):
            h = act(x @ params["w_gate"]) * (x @ params["w_up"])
        else:
            h = x @ params["w_in"]
            if "b_in" in params:
                h = h + params["b_in"]
            h = act(h)
    y = h @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y


# ---------------------------------------------------------------------------
# attention layer


def attention_layer(cfg: ModelConfig, params, x, *, cache=None, cache_pos=None,
                    plan=None, paged=None, cross_kv=None, use_rope: bool = True):
    """Returns (y, cache).  ``cache`` is a dense {k, v} layer cache (B, T,
    Hkv, dh) or a paged {k_pages, v_pages} layer pool (Hkv, P, ps, dh); both
    are written in place.  ``cache_pos`` is the write offset: an int, or (B,)
    per-request depths (continuous batching).  ``paged`` holds the shared
    ``page_table`` (and ``kv_len`` when decoding).  ``cross_kv`` = (k, v)
    attends x's queries to given keys and values, unmasked and with no cache
    write (the encoder-decoder's cross-attention, and its encoder's
    bidirectional self-attention); ``use_rope=False`` leaves positions out."""
    B, S, D = x.shape
    plan = plan if plan is not None else sfu.plan_for(cfg)
    exp_fn = resolve_exp(cfg, plan)
    softmax_table = _softmax_fused_table(plan)

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cross_kv is None:
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    else:
        k, v = cross_kv

    off = 0 if cache_pos is None else cache_pos
    if use_rope and cross_kv is None:
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
                                       page_table, kv_len + 1, exp_fn,
                                       softmax_table=softmax_table)
        else:
            # prefill: write the prompt's pages, attend causally in flight
            _pg.write_prompt_pages_(cache["k_pages"], cache["v_pages"], k, v, page_table)
            y = _attn_softmax_dispatch(q, k, v, causal=True, exp_fn=exp_fn,
                                       table=softmax_table)
    elif cache is not None and cross_kv is None:
        T = cache["k"].shape[1]
        pos0 = int(off)
        cache["k"][:, pos0:pos0 + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos0:pos0 + S] = v.to(cache["v"].dtype)
        if S == 1:
            valid = (torch.arange(T, device=x.device)[None, :] <= pos0).expand(B, T)
            y = decode_attention(q, cache["k"], cache["v"], valid, exp_fn,
                                 softmax_table=softmax_table)
        else:
            y = _attn_softmax_dispatch(q, k, v, causal=True, exp_fn=exp_fn,
                                       table=softmax_table)
    else:
        y = _attn_softmax_dispatch(q, k, v, causal=cross_kv is None, exp_fn=exp_fn,
                                   table=softmax_table)

    out = torch.einsum("bshk,hkd->bsd", y, params["wo"])
    return out, cache
