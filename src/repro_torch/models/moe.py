"""Mixture-of-Experts FFN (torch): token-choice top-k routing with capacity
buckets.

Counterpart of ``repro/models/moe.py``: on one device the local dispatch of
``_moe_local_dispatch``; under rules with a mesh the layer runs in a
``local_map`` body (``_moe_layer_shardmap``): tokens over the data axes,
and, when the experts divide the "model" extent, the experts over "model"
(expert parallelism): the tokens are replicated over "model", each rank
fills its own experts' buckets, and one sum over "model" combines the
partial outputs.  The capacity is per data shard (the body's tokens) and the
aux loss the mean of the shards', as in JAX.  The function is the JAX
package's, drops included:

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

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch import sfu
from repro_torch.distributed import shard_fused as shf
from repro_torch.distributed.sharding import active_mesh_rules, use_rules
from repro_torch.kernels import fused

from .common import ModelConfig
from .layers import plain_glu


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
    (site ``"moe.expert:<activation>"``).  Under a mesh, per shard
    (:func:`_moe_layer_shardmap`)."""
    plan = plan if plan is not None else sfu.plan_for(cfg)
    rules = active_mesh_rules()
    if rules is not None:
        return _moe_layer_shardmap(cfg, params, x, plan, rules)
    return _moe_local_dispatch(cfg, params, x, plan)


def _moe_layer_shardmap(cfg: ModelConfig, params, x, plan, rules):
    """The layer in one ``local_map`` body: tokens over the data axes (when
    they divide the batch), experts over "model" when E divides its extent
    (each rank its own experts' buckets, one sum over "model"), else the
    experts replicated and every model rank computing alike.  The aux loss
    is the mean of the data shards'.

    Gradients: the body's routing is alike on every model rank, its expert
    work split over them; the tokens and the combine weights enter the
    split work through ``copy_to_split``, whose backward sums the model
    ranks' partial gradients, so the tokens' and the router's gradients
    leave the body whole on every model rank (``Replicate``) and partial
    over the data shards."""
    shape = shf.mesh_axis_sizes(rules)
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    dp = math.prod(shape[a] for a in batch_axes)
    x_b = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
        if batch_axes and x.shape[0] % dp == 0 else None
    tp = shape.get("model", 1)
    ep = tp > 1 and cfg.n_experts % tp == 0
    e = "model" if ep else None
    names = rules.mesh.mesh_dim_names
    x_spec, r_spec, e_spec = shf.P(x_b, None, None), shf.P(None, None), shf.P(e, None, None)
    grads = [[Shard(0) if (x_b and n in batch_axes) else Replicate() for n in names],
             [Partial() if (x_b and n in batch_axes) else Replicate() for n in names]]
    ep_group = shf.axis_group(rules, "model") if ep else None
    mean_groups = [shf.axis_group(rules, a) for a in batch_axes] if x_b else []

    def body(x_l, router, wg, wu, wd):
        ep_rank = shf.axis_index(rules, "model") if ep else 0
        with use_rules(None):
            y, aux = _moe_local_dispatch(
                cfg, {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}, x_l, plan,
                ep_rank=ep_rank, ep_size=tp if ep else 1, ep_group=ep_group)
        if ep:
            y = shf.psum(y, ep_group)
        for g in mean_groups:
            aux = shf.pmean(aux, g)
        return y, aux

    return shf.run_sharded(
        rules, body, (x, params["router"], params["w_gate"], params["w_up"], params["w_down"]),
        (x_spec, r_spec, e_spec, e_spec, e_spec), (x_spec, shf.P()),
        in_grad_specs=grads + [None] * 3)


def _moe_local_dispatch(cfg: ModelConfig, params, x, plan, ep_rank: int = 0,
                        ep_size: int = 1, ep_group=None):
    """Token-choice dispatch over the local tokens.  With ``ep_size`` > 1
    the local experts are the ``ep_rank``-th slice of E // ep_size, and the
    output holds only their share (the caller sums it over ``ep_group``)."""
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
    E_loc = E // ep_size
    if ep_size > 1:
        # this rank's experts only; the tokens and the combine weights feed
        # work split over the group (their gradients are summed over it)
        mine = (flat_e // E_loc) == ep_rank
        flat_e = torch.where(mine, flat_e - ep_rank * E_loc, 0)
        keep = mine & keep
        flat_w = shf.copy_to_split(flat_w, ep_group) * mine.to(torch.float32)
        xt = shf.copy_to_split(xt, ep_group)
    safe_pos = torch.where(keep, pos, C - 1)

    # dispatch: every kept pair's token into its own bucket row (rows are
    # unique); dropped pairs go to one spare row past the buckets, which is
    # cut off.  The token's K copies are an expand, whose gradient is a sum
    # over k (no atomics).
    slot = torch.where(keep, flat_e * C + pos, E_loc * C)
    xk = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E_loc * C + 1, D), dtype=dtype, device=x.device).index_put((slot,), xk)
    buf = buf[: E_loc * C].view(E_loc, C, D)

    w_gate, w_up, w_down = (params[k].to(dtype) for k in ("w_gate", "w_up", "w_down"))
    if fused_table is not None:
        h = fused.fused_moe_glu(buf, w_gate, w_up, table=fused_table)
    elif plan.spec(key).impl == "jnp":
        # the table unfused (a plan's, or the degrade ladder's first rung):
        # computed as the fused kernel computes it
        h = plain_glu(act, buf, w_gate, w_up)
    else:
        h = act(torch.einsum("ecd,edf->ecf", buf, w_gate)) * torch.einsum(
            "ecd,edf->ecf", buf, w_up)
    out = torch.einsum("ecf,efd->ecd", h, w_down).reshape(E_loc * C, D)

    # combine: each token's K weighted outputs summed in choice order
    picked = (out[flat_e * C + safe_pos] * flat_w[:, None].to(dtype)).view(T, K, D)
    y = picked[:, 0]
    for k in range(1, K):
        y = y + picked[:, k]
    if fused_table is not None:
        # sfu.guard checkpoint on the combined expert output: a NaN in any
        # expert reaches the combine, so finite-checking it covers the site
        y = sfu.guard.check_fused(key, y)

    # Switch load-balancing loss
    frac_tokens = F.one_hot(top_e[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * (frac_tokens * probs.mean(dim=0)).sum()
    return y.reshape(B, S, D), aux
