"""Mamba2 (state-space duality) block (torch): chunked SSD for training and
prefill, the exact one-step recurrence for decode.

Counterpart of ``repro/models/ssm.py``.  Per head h with state size N and
head dim P:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t        (N-dim state per (h, p))
    y_t = C_t . h_t + D x_t

A training forward or a prefill runs the chunked block-matrix algorithm:
within a chunk an attention-like quadratic term, across chunks the state
recurrence, a Python loop over chunks where JAX has its ``lax.scan``.  The
JAX package's three-operand einsums are written as batched products in an
order that never builds a (b, z, c, s, h, p) intermediate.

One deliberate difference from the reference: :func:`_segsum_exp` masks the
upper triangle before the exponential.  The forward values are the same
(a masked entry is 0 either way), but JAX's ``where(tri, exp(diff), 0)``
overflows to inf above the diagonal once a chunk's Σ|dt·A| passes ~88.7, and
its gradient is then 0·inf = NaN; here the gradient stays finite, and equals
JAX's wherever JAX's is finite.

SiLU and dt's softplus resolve through the activation plan's ``ssm:*``
sites: under an ``impl="kernel"`` plan the softplus runs the standalone PWL
kernel (``kernels/ops.py``).  The block has no kernel of its own, as the
JAX block has no Pallas kernel.

Under rules with a mesh the projections are DTensor products and the
block's middle runs per shard in one ``local_map`` body
(:func:`_mamba2_sharded`): heads and the inner width over "model"
("ssm_heads", "ssm_inner"), batch over the data axes, B and C whole on
every rank.  The causal conv is depthwise, so each rank convolves its own x
channels and every B/C channel; the gated RMSNorm's sum of squares over the
inner width is the one collective.  A cache (:func:`cache_spec`) is read
and written in the same body: the state ``ssm`` (B, H, P, N) split with the
heads, the conv tail (B, K-1, C) whole on every rank as x|B|C, of which a
rank reads its own x channels and every B/C channel; the x channels of the
new tail are gathered over the inner width's axes, so every rank's tail
stays whole.
"""
from __future__ import annotations

import torch

from repro_torch import sfu
from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed.sharding import active_mesh_rules, constrain, use_rules

from .common import ModelConfig
from .layers import rms_norm


def ssm_dims(cfg: ModelConfig):
    """(d_inner, n_heads, d_state, conv_channels, d_in_proj); one group."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    d_state = cfg.ssm_state
    conv_channels = d_inner + 2 * d_state
    d_in_proj = 2 * d_inner + 2 * d_state + n_heads
    return d_inner, n_heads, d_state, conv_channels, d_in_proj


def _causal_conv(x, w, b):
    """Depthwise causal conv1d by kernel-size shifts, in x's dtype and the
    JAX package's order: from zeros, the K shifted terms in order, then the
    bias.  x: (B, L, C), w: (K, C), b: (C,)."""
    K = w.shape[0]
    L = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        shift = K - 1 - i
        xi = torch.nn.functional.pad(x, (0, 0, shift, 0))[:, :L]
        out = out + xi * w[i]
    return out + b


def _segsum_exp(a):
    """exp(segsum): a (..., s) -> lower-triangular (..., s, s) with
    L[i, j] = exp(sum_{k=j+1..i} a_k) for i >= j, else 0.  The upper
    triangle is masked to -inf before the exponential (see the module
    docstring)."""
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # (..., i, j)
    s = a.shape[-1]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=a.device))
    return torch.exp(torch.where(tri, diff, float("-inf")))


def ssd_chunked(xdt, a, Bmat, Cmat, chunk: int, h_init=None):
    """Chunked SSD, all f32.

    xdt: (b, l, h, p) dt-scaled inputs; a: (b, l, h) dt·A (negative);
    Bmat, Cmat: (b, l, n) (one group, broadcast over heads).  Returns
    (y (b, l, h, p), h_last (b, h, p, n))."""
    b, l, h, p = xdt.shape
    n = Bmat.shape[-1]
    if l % chunk:  # pad to a chunk multiple: a = 0 (decay 1), B = 0 (no update)
        pad = chunk - l % chunk
        F = torch.nn.functional
        y, h_last = ssd_chunked(F.pad(xdt, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad)),
                                F.pad(Bmat, (0, 0, 0, pad)), F.pad(Cmat, (0, 0, 0, pad)),
                                chunk, h_init)
        return y[:, :l], h_last
    nc = l // chunk
    xdt = xdt.reshape(b, nc, chunk, h, p)
    a = a.reshape(b, nc, chunk, h)
    Bc = Bmat.reshape(b, nc, chunk, n)
    Cc = Cmat.reshape(b, nc, chunk, n)
    xdt_h = xdt.permute(0, 1, 3, 2, 4)                  # (b, z, h, s, p)

    a_cum = torch.cumsum(a, dim=2)                      # (b, z, s, h)
    Lmat = _segsum_exp(a.permute(0, 1, 3, 2))           # (b, z, h, c, s)

    # intra-chunk (diagonal blocks): (scores ∘ L) @ x per head
    scores = Cc @ Bc.transpose(-1, -2)                  # (b, z, c, s)
    y_diag = (scores[:, :, None] * Lmat) @ xdt_h        # (b, z, h, c, p)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)              # (b, z, c, h, p)

    # chunk states: inputs decayed to the chunk's end, contracted with B
    decay_out = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b, z, s, h)
    xw = (xdt * decay_out[..., None]).reshape(b, nc, chunk, h * p)
    states = (xw.transpose(-1, -2) @ Bc).reshape(b, nc, h, p, n)

    # inter-chunk recurrence over z
    chunk_decay = torch.exp(a_cum[:, :, -1, :])         # (b, z, h)
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
             if h_init is None else h_init)
    h_prevs = []
    for z in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)               # (b, z, h, p, n)

    # inter-chunk output: C against the state entering the chunk, decayed
    # from the chunk's start to position c
    decay_in = torch.exp(a_cum)                         # (b, z, c, h)
    y_off = Cc @ h_prevs.reshape(b, nc, h * p, n).transpose(-1, -2)  # (b, z, c, h*p)
    y_off = y_off.reshape(b, nc, chunk, h, p) * decay_in[..., None]

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, hprev


def mamba2_layer(cfg: ModelConfig, params, x, cache=None, plan=None):
    """Mamba2 block.  x: (B, L, D) -> (y (B, L, D), cache).

    ``cache`` is the layer's {"conv": (B, K-1, C), "ssm": (B, H, P, N)},
    both in ``cfg.dtype``, written in place: with L == 1 the exact one-step
    recurrence over the window of the conv cache and this step; otherwise a
    prefill from position 0, which stores the conv tail (left-padded when
    L < K - 1) and the final state."""
    B, L, D = x.shape
    d_inner, n_heads, d_state, conv_ch, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    dtype = x.dtype
    f32 = torch.float32
    plan = plan if plan is not None else sfu.plan_for(cfg)
    rules = active_mesh_rules()
    if rules is not None:
        return _mamba2_sharded(rules, cfg, params, x, plan, cache), cache
    silu = plan.act(sfu.site_key(sfu.SITE_SSM, "silu"))
    softplus = plan.act(sfu.site_key(sfu.SITE_SSM, "softplus"))

    z = x @ params["in_z"]                               # (B, L, d_inner)
    x_in = x @ params["in_x"]                            # (B, L, d_inner)
    bc_in = x @ params["in_bc"]                          # (B, L, 2N)
    dt_raw = x @ params["in_dt"]                         # (B, L, H)
    xBC = torch.cat([x_in, bc_in], dim=-1)               # the conv runs over x|B|C

    conv_w, conv_b = params["conv_w"], params["conv_b"]  # (K, C), (C,)
    K = conv_w.shape[0]
    decode = cache is not None and L == 1
    new_conv = None
    if decode:
        # the exact causal conv at one step, over [cache window, current]
        win = torch.cat([cache["conv"].to(dtype), xBC], dim=1)  # (B, K, C)
        conv_out = _conv_step(win, conv_w, conv_b)
        new_conv = win[:, 1:]
    else:
        conv_out = _causal_conv(xBC, conv_w, conv_b)
        if cache is not None:  # prefill: stash the tail for decode
            new_conv = _conv_tail(xBC, K)

    conv_out = silu(conv_out)
    x_ssm = conv_out[..., :d_inner]
    Bmat = conv_out[..., d_inner:d_inner + d_state].to(f32)
    Cmat = conv_out[..., d_inner + d_state:].to(f32)

    dt = softplus(dt_raw.to(f32) + params["dt_bias"].to(f32))
    A = -torch.exp(params["A_log"].to(f32))             # (H,)
    xh = x_ssm.to(f32).reshape(B, L, n_heads, P)
    xdt = xh * dt[..., None]
    a = dt * A                                           # (B, L, H)

    if decode:
        y, h_new = _ssm_step(cache["ssm"].to(f32), xdt, a, Bmat, Cmat)
    else:
        y, h_new = ssd_chunked(xdt, a, Bmat, Cmat, chunk=min(cfg.ssm_chunk, L))
    if cache is not None:
        cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
        cache["ssm"].copy_(h_new.to(cache["ssm"].dtype))

    y = y + params["D"].to(f32)[None, None, :, None] * xh
    y = y.reshape(B, L, d_inner).to(dtype)

    # gated RMSNorm, then the out projection
    y = rms_norm(y * silu(z), params["norm_scale"])
    return y @ params["out_proj"], cache


def _inner_entries(rules, cfg: ModelConfig):
    """The spec entries (inner width, heads) of the block under a mesh:
    the "ssm_inner" and "ssm_heads" axes when both split alike (whole heads
    per rank), else (None, None)."""
    d_inner, n_heads, _, _, _ = ssm_dims(cfg)
    i = shf.dim_entry(rules, "ssm_inner", d_inner)
    hh = shf.dim_entry(rules, "ssm_heads", n_heads)
    return (i, hh) if i == hh else (None, None)


def cache_spec(rules, cfg: ModelConfig, batch: int) -> dict:
    """The specs of an SSM layer's cache leaves (no layer axis) under a mesh:
    the batch over its axes, the state's heads as the block splits them,
    the conv tail's x|B|C channels whole (the module docstring)."""
    b = shf.batch_entry(rules, batch)
    return {"conv": shf.P(b, None, None), "ssm": shf.P(b, _inner_entries(rules, cfg)[1], None,
                                                      None)}


def _conv_step(win, w, b):
    """The exact causal conv at one step, over its window ``win`` (B, K, C)
    of the cached K - 1 steps and the current one: (B, 1, C)."""
    return (torch.einsum("bkc,kc->bc", win, w) + b)[:, None, :]


def _ssm_step(h_prev, xdt, a, Bmat, Cmat):
    """The exact one-step state recurrence from ``h_prev`` (B, H, P, N), f32,
    read before the cache is written: (y (B, 1, H, P), h_new)."""
    upd = xdt[:, 0, :, :, None] * Bmat[:, 0, None, None, :]  # (B, H, P, N)
    h_new = h_prev * torch.exp(a[:, 0])[:, :, None, None] + upd
    return (h_new @ Cmat[:, 0, None, :, None])[..., 0][:, None], h_new


def _conv_tail(t, K: int):
    """The last K - 1 steps of ``t`` (B, L, C), left-padded with zeros when
    L < K - 1: what a prefill leaves in the conv cache."""
    L = t.shape[1]
    t = torch.nn.functional.pad(t, (0, 0, max(0, K - 1 - L), 0))
    return t[:, t.shape[1] - (K - 1):]


def _mamba2_sharded(rules, cfg: ModelConfig, params, x, plan, cache=None):
    """The Mamba2 block under a mesh (the module docstring); ``cache`` as in
    :func:`mamba2_layer`, placed by :func:`cache_spec`."""
    B, L, D = x.shape
    d_inner, n_heads, d_state, _, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    dtype = x.dtype
    f32 = torch.float32
    silu = plan.act(sfu.site_key(sfu.SITE_SSM, "silu"))
    softplus = plan.act(sfu.site_key(sfu.SITE_SSM, "softplus"))
    z = constrain(x @ params["in_z"], "batch", None, "ssm_inner")
    x_in = x @ params["in_x"]
    bc_in = x @ params["in_bc"]
    dt_raw = x @ params["in_dt"]
    b = shf.batch_entry(rules, B)
    i, hh = _inner_entries(rules, cfg)
    axes = shf.entry_axes(i)
    groups = [shf.axis_group(rules, a) for a in axes]
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    K = conv_w.shape[0]
    decode = cache is not None and L == 1
    ops = (x_in, bc_in, dt_raw, z, conv_w[:, :d_inner], conv_w[:, d_inner:],
           conv_b[:d_inner], conv_b[d_inner:], params["dt_bias"], params["A_log"], params["D"],
           params["norm_scale"])
    specs = (shf.P(b, None, i), shf.P(b, None, None), shf.P(b, None, hh), shf.P(b, None, i),
             shf.P(None, i), shf.P(None, None), shf.P(i), shf.P(None), shf.P(hh), shf.P(hh),
             shf.P(hh), shf.P(i))
    if cache is not None:
        cspec = cache_spec(rules, cfg, B)
        ops += (cache["conv"], cache["ssm"])
        specs += (cspec["conv"], cspec["ssm"])

    def body(x_l, bc_l, dt_l, z_l, cwx, cwbc, cbx, cbbc, dt_bias, A_log, D_l, scale,
             conv_l=None, ssm_l=None):
        with use_rules(None):
            if decode:  # the exact causal conv at one step, over [cache window, current]
                d_l = x_l.shape[-1]
                x0 = shf.entry_index(rules, i) * d_l
                win_x = torch.cat([conv_l[..., x0:x0 + d_l].to(dtype), x_l], dim=1)
                win_bc = torch.cat([conv_l[..., d_inner:].to(dtype), bc_l], dim=1)
                x_conv = _conv_step(win_x, cwx, cbx)
                bc_conv = _conv_step(win_bc, cwbc, cbbc)
                tails = (win_x[:, 1:], win_bc[:, 1:])
            else:
                x_conv = _causal_conv(x_l, cwx, cbx)
                bc_conv = _causal_conv(bc_l, cwbc, cbbc)
                tails = (_conv_tail(x_l, K), _conv_tail(bc_l, K))
            x_ssm = silu(x_conv)
            bc = silu(bc_conv)
            Bmat, Cmat = bc[..., :d_state].to(f32), bc[..., d_state:].to(f32)
            dt = softplus(dt_l.to(f32) + dt_bias.to(f32))
            A = -torch.exp(A_log.to(f32))
            B_l, h_l = x_l.shape[0], dt.shape[-1]
            xh = x_ssm.to(f32).reshape(B_l, L, h_l, P)
            xdt, a = xh * dt[..., None], dt * A
            if decode:
                y, h_new = _ssm_step(ssm_l.to(f32), xdt, a, Bmat, Cmat)
            else:
                y, h_new = ssd_chunked(xdt, a, Bmat, Cmat, chunk=min(cfg.ssm_chunk, L))
            if conv_l is not None:
                tail_x = tails[0]
                for a_name in reversed(axes):  # minor axis first: blocks in index order
                    tail_x = shf.all_gather_dim(tail_x, shf.axis_group(rules, a_name), 2)
                conv_l[..., :d_inner].copy_(tail_x.to(conv_l.dtype))
                conv_l[..., d_inner:].copy_(tails[1].to(conv_l.dtype))
                ssm_l.copy_(h_new.to(ssm_l.dtype))
            y = (y + D_l.to(f32)[None, None, :, None] * xh).reshape(B_l, L, h_l * P).to(dtype)
            # the gated RMSNorm over the whole inner width: one sum of
            # squares over the ranks, each then scaling its own columns
            yf = (y * silu(z_l)).to(f32)
            ss = yf.square().sum(dim=-1, keepdim=True)
            for g in groups:
                ss = shf.psum_split(ss, g)
            yf = yf * torch.rsqrt(ss / d_inner + 1e-6)
            return (yf * (1.0 + scale.to(f32))).to(dtype)

    y = shf.run_sharded(rules, body, ops, specs, shf.P(b, None, i))
    y = constrain(y, "batch", None, "ssm_inner")
    return constrain(y @ params["out_proj"], "batch", None, "act_embed")
