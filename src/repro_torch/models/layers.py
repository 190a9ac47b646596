"""Model layers (torch): RMSNorm, LayerNorm (with or without parameters),
RoPE, sinusoidal positions, attention (self, sliding-window and cross),
GLU and plain MLPs.

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

Under rules with a mesh of more than one rank (``distributed.sharding``)
the projections are DTensor products and ``constrain`` sits at the JAX
package's sites; the attention core (rotation, page writes, the softmax
dispatch) and the MLP's hidden state run per shard in ``local_map`` bodies
(``distributed.shard_fused.run_sharded``): heads over "model" in whole GQA
groups, d_ff columns over "mlp", batch over the data axes, each body on
plain local tensors, so every fused kernel sees its local shapes.  The page
writes keep the batch replicated (every data rank applies every request's
write, so pool replicas never diverge), as in JAX.  A dense cache sharded
over its sequence (``cache_seq``: sequence-parallel rules, or the
context-parallel cell rules) keeps on each rank its block of the slots; a
decode there runs JAX's unfused formula as GSPMD partitions it, with a MAX
and two SUM all-reduces over the ranks of that block's group.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch import sfu
from repro_torch.core import pwl
from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed.sharding import (
    active_mesh_rules,
    constrain,
    logical_extent,
    placements,
    unruled,
)
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


def nonparam_ln(x, eps=1e-5):
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(cfg: ModelConfig, params, x):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    if cfg.norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    if cfg.norm_type == "nonparam_ln":
        return nonparam_ln(x)
    raise ValueError(f"norm_type {cfg.norm_type!r}")


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, f32 (..., S, head_dim // 2), for
    positions (..., S).  A paged model call computes them once for all its
    layers."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    sin = torch.sin(angles)
    cos = torch.cos(angles)
    return cos, sin


def apply_rope(x, cos, sin):
    """x: (..., S, H, dh) rotated by :func:`rope_tables`' (..., S, dh // 2)."""
    half = x.shape[-1] // 2
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, dh), positions: broadcastable to (..., S)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


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


def pwl_exp_fn(table) -> Callable:
    """Softmax-safe elementwise PWL exp over a fitted table: the closure
    :func:`resolve_exp` builds for a non-exact spec at ``impl="jnp"``.
    Public so benchmarks and tests exercise the production exp, not a copy
    of its clamps."""
    return _softmax_safe_exp(lambda x: pwl.eval_coeff(x, table))


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


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    exp_fn: Callable = torch.exp, q_chunk: int = 256, kv_chunk: int = 2048,
                    kv_valid_len=None):
    """Chunked online-softmax attention in f32, the JAX package's chunking.

    q: (B, S, H, dh); k/v: (B, T, Hkv, dh); ``kv_valid_len``: None or (B,)
    valid key prefix per row.  A sliding ``window`` narrower than T takes
    one block per q chunk over the band of keys it can reach, ``[clip(q0 -
    window + 1, 0, T - band), +band)`` with ``band = min(window + q_chunk,
    T)``, masked causally and to ``qpos - kpos < window``.  Otherwise causal
    self-attention with S == T takes one block per q chunk over its causal
    prefix (q chunks sized so there are at most 16); everything else walks
    ``kv_chunk``-key blocks with ``exp_fn`` applied to the running-max
    correction at each block boundary, which changes the numbers under a
    PWL exp.  GQA folds heads as (Hkv major, G minor).  Returns (B, S, H,
    dh) in q's dtype."""
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
    banded = window is not None and window < T
    band = min(window + q_chunk, T) if banded else 0
    kf = k.to(torch.float32).permute(0, 2, 1, 3)  # (B, Hkv, T, dh)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    outs = []
    for s0 in range(0, S, q_chunk):
        qc = q[:, s0:s0 + q_chunk].to(torch.float32)
        Sc = qc.shape[1]
        qc = qc.reshape(B, Sc, Hkv, G, dh).permute(0, 3, 2, 1, 4)  # (B, G, Hkv, Sc, dh)
        qpos = s0 + torch.arange(Sc, device=dev)
        if banded:  # one block over the band of keys the chunk reaches
            b0 = min(max(s0 - window + 1, 0), T - band)
            blocks = [(b0, b0 + band)]
        elif unroll:  # the causal unroll: one block over the chunk's causal prefix
            blocks = [(0, s0 + q_chunk)]
        else:
            blocks = [(j0, min(j0 + kv_chunk, T)) for j0 in range(0, T, kv_chunk)]
        m = torch.full((B, G, Hkv, Sc), -1e30, device=dev)
        l = torch.zeros((B, G, Hkv, Sc), device=dev)
        acc = torch.zeros((B, G, Hkv, Sc, dh), device=dev)
        for j0, j1 in blocks:
            kpos = torch.arange(j0, j1, device=dev)
            mask = torch.ones((Sc, j1 - j0), dtype=torch.bool, device=dev)
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            if banded:
                mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
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


def dense_pwl_attention(q, k, v, *, table, causal: bool = True, window=None):
    """Dense attention with the fused PWL-exp softmax kernel (Sec. V-B).

    q: (B, S, H, dh); k/v: (B, T, Hkv, dh).  The scores and the product with
    V are ``torch.einsum`` (the JAX package leaves them to XLA); the softmax
    runs as one kernel over the score rows, with the causal and window masks
    made inside it from positions."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.to(torch.float32).reshape(B, S, Hkv, G, dh).permute(0, 3, 2, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)  # (B, Hkv, T, dh)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    s = torch.einsum("bghqd,bhkd->bghqk", qf, kf) * scale
    p = fused.fused_pwl_softmax(s, table=table, causal=causal, window=window)
    out = torch.einsum("bghqk,bhkd->bghqd", p, vf)
    return out.permute(0, 3, 2, 1, 4).reshape(B, S, H, dh).to(q.dtype)


def _shard_attention(rules, fn, q, k, v):
    """``fn(q, k, v)`` per shard: heads over the model axis in whole GQA
    groups, batch over the data axes, k/v head-sharded beside q (attention
    is head-local: no collective).  The fused executors' choice is made on
    the local shapes, which are what a rank holds."""
    B, _, H, _ = q.shape
    Hkv = k.shape[2]
    b = shf.batch_entry(rules, B)
    h, hk = shf.gqa_shard_entries(rules, "act_heads", H, "act_kv", Hkv)
    return shf.run_sharded(
        rules, unruled(fn), (q, k, v),
        (shf.P(b, None, h, None), shf.P(b, None, hk, None), shf.P(b, None, hk, None)),
        shf.P(b, None, h, None))


def _attn_softmax_dispatch(q, k, v, *, causal: bool, exp_fn: Callable, table, window=None):
    """Attention for prefill and training.  With a fused softmax ``table`` it
    always runs fused: the dense PWL-exp softmax kernel while the scores fit
    its caps and any ``window`` covers half the keys, the fused flash kernel
    otherwise (long-context prefill and training, narrow windows; both take
    gradients, each the JAX package's).  Otherwise :func:`flash_attention`
    with the (possibly PWL) elementwise ``exp_fn``."""
    if table is None:
        return flash_attention(q, k, v, causal=causal, window=window, exp_fn=exp_fn)
    B, S, H = q.shape[:3]
    T = k.shape[1]
    if _dense_softmax_preferred(B * H * S * T, T, window, T):
        y = dense_pwl_attention(q, k, v, table=table, causal=causal, window=window)
    else:
        y = fused.fused_flash_attention(q, k, v, table=table, causal=causal, window=window)
    return sfu.guard.check_fused(sfu.site_key(sfu.SITE_SOFTMAX, "exp"), y)


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
    the fused kernels; otherwise elementwise with ``exp_fn``.  Under a mesh
    it runs on a rank's local tensors, inside the per-shard body of
    :func:`_attention_core_sharded`, which writes and reads a dense cache
    in one body."""
    if softmax_table is not None:
        return _decode_attention_fused(q, k_cache, v_cache, valid, softmax_table)
    return seq_block_decode(q, k_cache, v_cache, valid, exp_fn)


def seq_block_decode(q, k_blk, v_blk, valid, exp_fn: Callable,
                     reduce: Callable | None = None):
    """The JAX package's unfused decode over one block of the cache's
    sequence, as GSPMD partitions it over ``cache_seq``: the local row max
    reduced by ``reduce(x, "max")``, the local ``exp_fn``, the row sum
    reduced by ``reduce(x, "sum")``, the local division, then the local
    ``p·v`` reduced by ``reduce(x, "sum")``.  q: (B, 1, H, dh); k/v_blk:
    (B, Tb, Hkv, dh); valid: (B, Tb) bool.  A block with no valid slot
    contributes a max of -1e30, a sum of 0 and ``p·v`` of 0.  With no
    ``reduce`` the block is the whole cache."""
    if reduce is None:
        reduce = lambda x, op: x  # noqa: E731
    B, _, H, dh = q.shape
    Hkv = k_blk.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.to(torch.float32).reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k_blk.to(torch.float32)) * scale
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, torch.full_like(s, -1e30))
    m = reduce(s.amax(dim=-1, keepdim=True), "max")
    p = torch.where(vm, exp_fn(s - m), torch.zeros_like(s))
    l = reduce(p.sum(dim=-1, keepdim=True), "sum")
    p = p / torch.clamp(l, min=1e-30)
    out = reduce(torch.einsum("bhgt,bthd->bhgd", p, v_blk.to(torch.float32)), "sum")
    return out.reshape(B, 1, H, dh).to(q.dtype)


def _seq_sharded_fallback(sharded: bool, what: str) -> bool:
    """``sharded`` (after the warn-once fused-fallback warning when true):
    whether the KV cache is sharded over its sequence (``cache_seq``); the
    per-shard fused decode would replicate the cache there, so the unfused
    path runs, as in the JAX package."""
    if not sharded:
        return False
    sfu.warn_fused_fallback(
        sfu.site_key(sfu.SITE_SOFTMAX, "exp"),
        f"{what} is sharded over the sequence axis (cache_seq, seq-parallel "
        "attention rules); the unfused contraction honors that sharding, the "
        "per-shard fused kernel would replicate the cache")
    return True


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len,
                           exp_fn: Callable = torch.exp, softmax_table=None):
    """Single-position attention over a paged cache.  q: (B, 1, H, dh);
    pools (Hkv, P, ps, dh); kv_len: (B,).  With ``softmax_table`` the
    split-KV kernel reads K/V through the page table; otherwise the table's
    pages are gathered into logical order and :func:`decode_attention` runs
    over the ``kv_len`` prefix.

    Under a mesh the decode runs per shard: q over its head groups and the
    batch, the pools over their KV heads, the table and lengths with the
    batch.  A cache sharded over ``cache_seq`` takes the unfused path with
    the warn-once warning."""
    rules = active_mesh_rules()
    if rules is not None:
        if softmax_table is not None and _seq_sharded_fallback(
                logical_extent(rules, "cache_seq") > 1, "paged KV pool"):
            softmax_table = None
        B, _, H, _ = q.shape
        Hkv = k_pages.shape[0]
        b = shf.batch_entry(rules, B)
        h, hk = shf.gqa_shard_entries(rules, "act_heads", H, "cache_kv", Hkv)
        pool = shf.P(hk, None, None, None)
        table = softmax_table

        def body(q_l, kp_l, vp_l, pt_l, len_l):
            return paged_decode_attention(q_l, kp_l, vp_l, pt_l, len_l, exp_fn,
                                          softmax_table=table)

        return shf.run_sharded(
            rules, unruled(body), (q, k_pages, v_pages, page_table, kv_len),
            (shf.P(b, None, h, None), pool, pool, shf.P(b, None), shf.P(b)),
            shf.P(b, None, h, None))
    if softmax_table is not None:
        return sfu.guard.check_fused(
            sfu.site_key(sfu.SITE_SOFTMAX, "exp"),
            fused.paged_flash_decode(q, k_pages, v_pages, page_table, kv_len,
                                     table=softmax_table))
    k_dense = _pg.gather_pages(k_pages, page_table)
    v_dense = _pg.gather_pages(v_pages, page_table)
    T = k_dense.shape[1]
    valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]
    return decode_attention(q, k_dense, v_dense, valid, exp_fn)


# ---------------------------------------------------------------------------
# MLP


def plain_glu(act, x, w_gate, w_up):
    """``act(x @ w_gate) * (x @ w_up)`` as the fused GLU kernel computes it:
    both products, the activation and the gating in f32 (``x`` and the
    weights widen exactly), rounded once to x's dtype: the kernel's values
    but for the f32 summation order, where the plain expression in bf16
    rounds four times (both products, the activation, the gating).
    ``x`` (..., K) with ``w`` (K, N), or batched (E, C, K) with (E, K, N)."""
    xf = x.float()
    return (act(xf @ w_gate.float()) * (xf @ w_up.float())).to(x.dtype)


def plain_linear_act(act, x, w, b=None):
    """``act(x @ w + b)`` as the fused linear kernel computes it: in f32,
    rounded once to x's dtype (see :func:`plain_glu`)."""
    z = x.float() @ w.float()
    if b is not None:
        z = z + b.float()
    return act(z).to(x.dtype)


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


def _guard_fused_mlp(cfg: ModelConfig, params, x, h, plan, key):
    """sfu.guard checkpoint on the fused-MLP hidden state.  The fused kernel
    consumes the pre-activation internally, so with an active collector the
    clamp counter recomputes it (``x @ w_gate``, or ``x @ w_in + b_in``)
    against the table's fitted range, a deliberate diagnostics-mode cost;
    with no collector this is the bare NaN-injection hook (a no-op unless
    armed)."""
    clamped = None
    if sfu.guard.active():
        table = plan.fused_table(key)
        if cfg.mlp_type in ("swiglu", "geglu"):
            z = x @ params["w_gate"]
        else:
            z = x @ params["w_in"]
            if "b_in" in params:
                z = z + params["b_in"]
        clamped = sfu.guard.count_outside(z, float(table.bp[0]), float(table.bp[-1]))
    return sfu.guard.check_fused(key, h, clamped)


def _mlp_hidden(cfg: ModelConfig, params, x, plan):
    """The FFN's hidden state (B, S, d_ff) on one device (or one shard)."""
    key = sfu.site_key(sfu.SITE_MLP, cfg.activation)
    h = _fused_mlp_hidden(cfg, params, x, plan)
    if h is not None:
        return _guard_fused_mlp(cfg, params, x, h, plan, key)
    act = plan.act(key)
    if plan.spec(key).impl == "jnp":
        # the table unfused (a plan's, or the degrade ladder's first
        # rung): computed as the fused kernel computes it
        return (plain_glu(act, x, params["w_gate"], params["w_up"])
                if cfg.mlp_type in ("swiglu", "geglu")
                else plain_linear_act(act, x, params["w_in"], params.get("b_in")))
    if cfg.mlp_type in ("swiglu", "geglu"):
        return act(x @ params["w_gate"]) * (x @ params["w_up"])
    h = x @ params["w_in"]
    if "b_in" in params:
        h = h + params["b_in"]
    return act(h)


def _mlp_hidden_sharded(rules, cfg: ModelConfig, params, x, plan):
    """The hidden state per shard: d_ff columns over the rules' "mlp" axis,
    batch over the data axes, the weights' d_model rows whole on every rank
    (the FSDP gather), so the hidden is d_ff-local and needs no collective.
    A d_ff the mlp extent does not divide replicates its columns, as
    ``sanitize_spec`` does to the unfused constraint."""
    names = (("w_gate", "w_up") if cfg.mlp_type in ("swiglu", "geglu")
             else ("w_in", "b_in") if "b_in" in params else ("w_in",))
    b = shf.batch_entry(rules, x.shape[0])
    f = shf.dim_entry(rules, "mlp", params[names[0]].shape[-1])
    specs = [shf.P(b, None, None)] + [shf.P(f) if n == "b_in" else shf.P(None, f)
                                      for n in names]

    def body(x_l, *w_l):
        return _mlp_hidden(cfg, dict(zip(names, w_l)), x_l, plan)

    return shf.run_sharded(rules, unruled(body), (x, *(params[n] for n in names)), specs,
                           shf.P(b, None, f))


def mlp(cfg: ModelConfig, params, x, plan=None):
    """Dense FFN: swiglu / geglu, or a plain (biased) MLP; activation via the
    plan's ``mlp:<activation>`` site.  Under a mesh the hidden state runs
    per shard (:func:`_mlp_hidden_sharded`) and the down projection is a
    row-parallel DTensor product, its partial sums reduced at the output's
    ``constrain``."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    rules = active_mesh_rules()
    if rules is None:
        h = _mlp_hidden(cfg, params, x, plan)
    elif params["w_down"].shape[0] == 0:
        # an empty FFN (mamba2's d_ff 0): nothing to split, one body makes
        # its zeros (and the empty weights' empty gradients)
        names = sorted(params)
        b = shf.batch_entry(rules, x.shape[0])

        def body(x_l, *w_l):
            return mlp(cfg, dict(zip(names, w_l)), x_l, plan)

        return shf.run_sharded(rules, unruled(body), (x, *(params[n] for n in names)),
                               (shf.P(b, None, None),) + tuple(shf.P() for _ in names),
                               shf.P(b, None, None))
    else:
        h = _mlp_hidden_sharded(rules, cfg, params, x, plan)
    # inside the TP region the hidden is sharded on d_ff only (Megatron)
    h = constrain(h, "batch", None, "mlp")
    y = h @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return constrain(y, "batch", "act_seq", "act_embed")


# ---------------------------------------------------------------------------
# attention layer


def attention_layer(cfg: ModelConfig, params, x, *, kind: str = "attn", cache=None,
                    cache_pos=None, plan=None, paged=None, cross_kv=None,
                    use_rope: bool = True):
    """Returns (y, cache).  ``kind`` ``attn_local`` attends over
    ``cfg.sliding_window`` keys.  ``cache`` is a dense {k, v} layer cache
    (B, T, Hkv, dh) or a paged {k_pages, v_pages} layer pool (Hkv, P, ps,
    dh); both are written in place.  A local layer's dense cache of T ==
    window slots is a ring: position p sits in slot p % T, a decode attends
    over every slot once the ring is full, and a prefill of S >= T keeps its
    last T tokens at their slots.  ``cache_pos`` is the write offset: an
    int, or (B,) per-request depths (continuous batching).  ``paged`` holds the shared
    ``page_table`` (and ``kv_len`` when decoding), and may hold the call's
    ``rope`` = :func:`rope_tables` at its positions: then the page write
    rotates q and k in the same launch (``rope_write_prompt_pages_``,
    ``rope_append_kv_``).  ``cross_kv`` = (k, v)
    attends x's queries to given keys and values, unmasked and with no cache
    write (the encoder-decoder's cross-attention, and its encoder's
    bidirectional self-attention); ``use_rope=False`` leaves positions out."""
    B, S, D = x.shape
    plan = plan if plan is not None else sfu.plan_for(cfg)
    exp_fn = resolve_exp(cfg, plan)
    softmax_table = _softmax_fused_table(plan)
    window = cfg.sliding_window if kind == "attn_local" else None

    # qwen2.5's biases go on before the rotation (in the paged page write too)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    if cross_kv is None:
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
        if "bk" in params:
            k = k + params["bk"]
            v = v + params["bv"]
    else:
        k, v = cross_kv

    rules = active_mesh_rules()
    if rules is not None:
        y = _attention_core_sharded(rules, cfg, q, k, v, cache=cache, cache_pos=cache_pos,
                                    paged=paged, cross=cross_kv is not None,
                                    use_rope=use_rope, exp_fn=exp_fn, table=softmax_table,
                                    window=window)
        y = constrain(y, "batch", "act_seq", "act_heads", None)
        out = torch.einsum("bshk,hkd->bsd", y, params["wo"])
        return constrain(out, "batch", "act_seq", "act_embed"), cache

    off = 0 if cache_pos is None else cache_pos
    paged_rope = cache is not None and "k_pages" in cache and "rope" in paged
    if use_rope and cross_kv is None and not paged_rope:
        ar = torch.arange(S, device=x.device)
        if torch.is_tensor(off) and off.dim() == 1:  # per-request depths (serving)
            positions = off[:, None] + ar[None, :]
        else:
            positions = ar[None, :] + off
        positions = positions.expand(B, S)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is not None and "k_pages" in cache:
        pools = (cache["k_pages"], cache["v_pages"])
        page_table = paged["page_table"]
        if S == 1:
            # decode: append at kv_len (rotating q and k with the call's
            # tables), then attend the kv_len+1 prefix
            kv_len = paged["kv_len"]
            if paged_rope:
                q = _pg.rope_append_kv_(q, k, v, *pools, page_table, kv_len, *paged["rope"])
            else:
                _pg.append_kv_(*pools, k, v, page_table, kv_len)
            y = paged_decode_attention(q, *pools, page_table, kv_len + 1, exp_fn,
                                       softmax_table=softmax_table)
        else:
            # prefill: write the prompt's pages, attend causally in flight
            if paged_rope:
                q, k = _pg.rope_write_prompt_pages_(q, k, v, *pools, page_table,
                                                    *paged["rope"])
            else:
                _pg.write_prompt_pages_(*pools, k, v, page_table)
            y = _attn_softmax_dispatch(q, k, v, causal=True, exp_fn=exp_fn,
                                       table=softmax_table, window=window)
    elif cache is not None and cross_kv is None:
        y = _dense_cache_attend(q, k, v, cache["k"], cache["v"], int(off), window, exp_fn,
                                softmax_table)
    else:
        y = _attn_softmax_dispatch(q, k, v, causal=cross_kv is None, exp_fn=exp_fn,
                                   table=softmax_table, window=window)

    out = torch.einsum("bshk,hkd->bsd", y, params["wo"])
    return out, cache


def _dense_cache_attend(q, k, v, k_cache, v_cache, pos0: int, window, exp_fn, table, *,
                        T: int | None = None, lo: int = 0, reduce: Callable | None = None):
    """Write k / v into a dense layer cache (B, T, Hkv, dh) in place from
    position ``pos0`` (a local layer's cache of T == window slots is a
    ring), then attend: one decode position over the cache's valid slots,
    or a prefill causally over the in-flight k / v.  Under a mesh that
    shards the cache over its sequence, ``k_cache`` / ``v_cache`` are a
    rank's block ``[lo, lo + Tb)`` of a ``T``-slot cache: the write keeps
    the block's positions (k / v whole over the sequence: no collective),
    and a decode is :func:`seq_block_decode` over the block's valid slots,
    ``reduce`` over the ranks that share the sequence."""
    S, Tb = q.shape[1], k_cache.shape[1]
    T = Tb if T is None else T
    ring = window is not None and T == window
    for buf, new in ((k_cache, k), (v_cache, v)):
        _write_cache_block(buf, new, pos0, T, lo, ring)
    if S == 1:
        t = lo + torch.arange(Tb, device=q.device)[None, :]
        valid = (((t <= pos0) | (pos0 >= T)) if ring else t <= pos0).expand(q.shape[0], Tb)
        if reduce is None:
            return decode_attention(q, k_cache, v_cache, valid, exp_fn, softmax_table=table)
        return seq_block_decode(q, k_cache, v_cache, valid, exp_fn, reduce)
    return _attn_softmax_dispatch(q, k, v, causal=True, exp_fn=exp_fn, table=table,
                                  window=window)


def _write_cache_block(buf, new, pos0: int, T: int, lo: int, ring: bool) -> None:
    """Write ``new`` (B, S, ...) at the global positions ``pos0 ..`` of a
    T-slot cache into ``buf``, its block of global slots ``[lo, lo + Tb)``
    (the whole cache: ``lo`` 0, Tb = T): only the positions that fall in
    the block, each where the single-process write puts it (a ring's
    position p at slot p % T; a prefill of S >= T into a ring keeps its
    last T tokens, rolled by S % T)."""
    S, Tb = new.shape[1], buf.shape[1]
    new = new.to(buf.dtype)
    if ring and S >= T:
        buf.copy_(torch.roll(new[:, S - T:], S % T, dims=1)[:, lo:lo + Tb])
        return
    start = pos0 % T if ring else pos0
    if start + S > T:
        raise ValueError(f"{S} positions from {pos0} do not fit a {T}-slot cache")
    a, b = max(start, lo), min(start + S, lo + Tb)
    if a < b:
        buf[:, a - lo:b - lo] = new[:, a - start:b - start]


def dense_cache_spec(rules, cfg: ModelConfig, batch: int, T: int):
    """The spec of a layer's dense (B, T, Hkv, dh) cache under a mesh, JAX's
    ``rules.spec("batch", "cache_seq", "cache_kv", None)`` with each entry
    that does not divide its dim replicated (``sanitize_spec``): the batch
    over its axes, the sequence over "cache_seq" (sequence-parallel rules:
    "model"; context-parallel cell rules: ("data", "model")), the KV heads
    over "cache_kv" when q's heads split with them in whole groups."""
    hk = shf.gqa_shard_entries(rules, "act_heads", cfg.n_heads, "cache_kv", cfg.n_kv_heads)[1]
    return shf.P(shf.batch_entry(rules, batch), shf.dim_entry(rules, "cache_seq", T), hk, None)


def _group_reduce(group) -> Callable:
    """``reduce(x, op)`` over a process group: ``op`` "max" or "sum"."""
    def reduce(x, op: str):
        return shf.pmax(x, group) if op == "max" else shf.psum(x, group)
    return reduce


def _attention_core_sharded(rules, cfg: ModelConfig, q, k, v, *, cache, cache_pos, paged,
                            cross: bool, use_rope: bool, exp_fn, table, window):
    """The attention core under a mesh, from the projections' DTensors to
    the (B, S, H, dh) output: a training or cross-attention call rotates
    and attends in one per-shard body; a paged call writes its pages per
    shard (``kv_cache``'s sharded writes, batch replicated) and then
    attends per shard; a dense cache is written and read in one per-shard
    body, on each rank's batch rows, KV heads and, where "cache_seq" shards
    it, block of the sequence (the decode's softmax then reduced over the
    ranks that share the sequence: :func:`seq_block_decode`)."""
    q = constrain(q, "batch", "act_seq", "act_heads", None)
    S = q.shape[1]
    if cache is not None and "k_pages" not in cache:
        pos0 = int(0 if cache_pos is None else cache_pos)
        T = cache["k"].shape[1]
        spec = dense_cache_spec(rules, cfg, q.shape[0], T)
        want = placements(rules.mesh, spec)
        for t in (cache["k"], cache["v"]):
            if list(t.placements) != want:
                raise ValueError(f"dense cache placed {list(t.placements)}, the per-shard write "
                                 f"needs {want}: make it under the rules (make_cache)")
        seq = spec[1]  # this rank's block of the sequence, reduced over its group
        if S == 1 and table is not None and _seq_sharded_fallback(seq is not None,
                                                                  "decode KV cache"):
            table = None
        # q, k and v whole over the sequence, their heads split with the cache's
        hs = shf.P(spec[0], None, spec[2], None)
        block = 0 if seq is None else shf.entry_index(rules, seq)
        reduce = None if seq is None else _group_reduce(shf.entry_group(rules, seq))

        def dense(q_l, k_l, v_l, kc_l, vc_l):
            if use_rope:
                pos = pos0 + torch.arange(S, device=q_l.device)[None, :].expand(q_l.shape[0], S)
                q_l, k_l = rope(q_l, pos, cfg.rope_theta), rope(k_l, pos, cfg.rope_theta)
            return _dense_cache_attend(q_l, k_l, v_l, kc_l, vc_l, pos0, window, exp_fn, table,
                                       T=T, lo=block * kc_l.shape[1], reduce=reduce)

        return shf.run_sharded(rules, unruled(dense), (q, k, v, cache["k"], cache["v"]),
                               (hs, hs, hs, spec, spec), hs)
    if cache is None:
        rotate = use_rope and not cross

        def body(q_l, k_l, v_l):
            if rotate:
                pos = torch.arange(S, device=q_l.device)[None, :].expand(q_l.shape[0], S)
                q_l = rope(q_l, pos, cfg.rope_theta)
                k_l = rope(k_l, pos, cfg.rope_theta)
            return _attn_softmax_dispatch(q_l, k_l, v_l, causal=not cross, exp_fn=exp_fn,
                                          table=table, window=window)

        return _shard_attention(rules, body, q, k, v)
    pools = (cache["k_pages"], cache["v_pages"])
    page_table = paged["page_table"]
    if "rope" not in paged:
        raise NotImplementedError("a paged call under a mesh passes its rope tables")
    if S == 1:
        kv_len = paged["kv_len"]
        q = _pg.rope_append_kv_(q, k, v, *pools, page_table, kv_len, *paged["rope"])
        return paged_decode_attention(q, *pools, page_table, kv_len + 1, exp_fn,
                                      softmax_table=table)
    q, k = _pg.rope_write_prompt_pages_(q, k, v, *pools, page_table, *paged["rope"])

    def attend(q_l, k_l, v_l):
        return _attn_softmax_dispatch(q_l, k_l, v_l, causal=True, exp_fn=exp_fn, table=table,
                                      window=window)

    return _shard_attention(rules, attend, q, k, v)
