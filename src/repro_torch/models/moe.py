"""Mixture-of-Experts FFN (torch): token-choice top-k routing with capacity
buckets.

Counterpart of ``repro/models/moe.py`` on one device, the local dispatch of
``_moe_local_dispatch`` (the expert-parallel ``shard_map`` path waits for the
distribution entry of the ROADMAP).  The function is the JAX package's,
drops included:

* routing in f32 from the f32 router (``logits = x.f32 @ router``), a
  softmax over the experts, and the top K by a stable descending sort, so
  tied probabilities go to the lower expert index first, as ``lax.top_k``
  gives them; the K weights are renormalised in f32;
* capacity per call, ``max(1, int(capacity_factor·T·K/E))`` over the call's
  T tokens (padded prefill positions and idle decode slots count);
* a pair's position in its expert's bucket from the token-major cumsum of
  the one-hot choices; a pair at or past capacity is dropped (weight 0);
* a deterministic combine: each token's K weighted expert outputs summed in
  choice order in the model dtype, as the JAX scatter-add adds them (no
  atomics, so a bf16 combine is the same on every run);
* the Switch load-balancing loss ``E·Σ frac_tokens·frac_probs``, with
  ``frac_tokens`` from the first choice.

An ``moe.expert`` site planned ``impl="fused"`` runs the experts' gate and
up products, the PWL activation and the gating in one kernel
(``kernels/fused/moe.py``); otherwise the plan's activation runs between two
einsums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sfu
from repro_torch.kernels import fused

from .common import ModelConfig


def route(cfg: ModelConfig, router, xt):
    """(T, D) tokens -> (probs (T, E), top_w (T, K), top_e (T, K)), in f32."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.n_active_experts
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_e


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Tokens per expert bucket for a call over ``n_tokens`` tokens."""
    return max(1, int(cfg.capacity_factor * n_tokens * cfg.n_active_experts / cfg.n_experts))


def moe_layer(cfg: ModelConfig, params, x, plan=None):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux_loss f32 scalar).

    ``params``: ``router`` (D, E) f32, ``w_gate``/``w_up`` (E, D, F) and
    ``w_down`` (E, F, D).  The expert activation resolves through the plan
    (site ``"moe.expert:<activation>"``)."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    key = sfu.site_key(sfu.SITE_MOE, cfg.activation)
    fused_table = plan.fused_table(key)
    act = None if fused_table is not None else plan.act(key)
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.n_active_experts
    dtype = x.dtype
    xt = x.reshape(T, D)
    probs, top_w, top_e = route(cfg, params["router"], xt)

    # positions in the buckets: token-major cumsum of the one-hot choices
    C = capacity(cfg, T)
    flat_e = top_e.reshape(-1)  # (T*K,), pair t*K + k
    pos = (F.one_hot(flat_e, E).cumsum(dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    flat_w = top_w.reshape(-1) * keep.to(torch.float32)
    safe_pos = torch.where(keep, pos, C - 1)

    # dispatch: every kept pair's token into its own bucket row (rows are
    # unique); dropped pairs go to one spare row past the buckets, which is
    # cut off.  The token's K copies are an expand, whose gradient is a sum
    # over k (no atomics).
    slot = torch.where(keep, flat_e * C + pos, E * C)
    xk = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E * C + 1, D), dtype=dtype, device=x.device).index_put((slot,), xk)
    buf = buf[: E * C].view(E, C, D)

    w_gate, w_up, w_down = (params[k].to(dtype) for k in ("w_gate", "w_up", "w_down"))
    if fused_table is not None:
        h = fused.fused_moe_glu(buf, w_gate, w_up, table=fused_table)
    else:
        h = act(torch.einsum("ecd,edf->ecf", buf, w_gate)) * torch.einsum(
            "ecd,edf->ecf", buf, w_up)
    out = torch.einsum("ecf,efd->ecd", h, w_down).reshape(E * C, D)

    # combine: each token's K weighted outputs summed in choice order
    picked = (out[flat_e * C + safe_pos] * flat_w[:, None].to(dtype)).view(T, K, D)
    y = picked[:, 0]
    for k in range(1, K):
        y = y + picked[:, k]

    # Switch load-balancing loss
    frac_tokens = F.one_hot(top_e[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * (frac_tokens * probs.mean(dim=0)).sum()
    return y.reshape(B, S, D), aux
