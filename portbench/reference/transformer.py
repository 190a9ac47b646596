"""The plain reference of a decoder-only transformer (``"family":
"transformer"``): float32 PyTorch, no kernels, no cache, no batching.  It
imports nothing of the program.

It follows the configuration file (``portbench/configs/<name>.json``) and
the weights of ``portbench/weights.py``, laid out as :func:`layout` says.
The function is the one the port computes:

* ``norm``: RMSNorm ``x·rsqrt(mean(x²) + rms_norm_eps)·(1 + scale)``, or
  OLMo's LayerNorm without parameters (``layer_norm_eps``); rotary
  embeddings on the first and second halves of each head (``rope_theta``);
* attention's softmax through the PWL exp: per query row, the scores
  ``s = q·k / sqrt(dh)`` of the kept keys, ``t = max(s - max_row s, -1e4)``,
  ``u = max(PWL_exp(t), 0)`` and ``p = u / max(Σu, 1e-30)``;
* the GLU ``PWL_act(x·Wg) · (x·Wu)``, then ``·Wd``, with the table of
  ``hidden_act``; a MoE layer routes in float32 (softmax over the experts,
  the top k by a stable descending sort, the k weights renormalised where
  ``norm_topk_prob``) and runs every routed pair (dropless);
* a PWL function by the paper's compare-count decode (``pwl.py``);
* AdamW as the port states it: the global norm clipped first, decoupled
  weight decay on leaves of two or more dimensions, the warmup-cosine
  schedule at step + 1, bias corrections.

``precision="fp8"`` is the control: every product of the model's own
weights and activations takes its operands rounded to float8 e4m3 (a
scale per row of the left operand and per column of the right), the
nearest precision below the bf16 that the configurations state.  Routing
and the softmax's arithmetic stay float32.

The model FLOPs (:func:`request_flops`, :func:`train_flops_token`) are
``roofline/model.py``'s ``active_params`` and ``model_flops_decode``,
frozen here, with attention's products added for a training step and a
prefill.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .pwl import pwl

FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# the weight layout and the model FLOPs


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def layout(cfg: dict) -> list[tuple[tuple, tuple | None, str]]:
    """(path, shape, kind) of every node of the port's weight tree in draw
    order: ``embed`` (padded vocab, D), ``final_norm``, ``layers`` (one
    period of stacked per-layer leaves), and ``unembed`` (D, padded vocab)
    unless the embeddings are tied.  kind is "matrix", "router", "norm" (a
    norm scale, not drawn) or "empty" (a node with no leaves)."""
    D, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = D // H
    F = cfg["intermediate_size"]
    Vp = padded_vocab(cfg)
    lay = ("layers", 0)
    out = [(("embed",), (Vp, D), "matrix")]
    if cfg["norm"] == "rmsnorm":
        out += [(("final_norm", "scale"), (D,), "norm"),
                (lay + ("ln1", "scale"), (L, D), "norm"), (lay + ("ln2", "scale"), (L, D), "norm")]
    else:
        out += [(("final_norm",), None, "empty"), (lay + ("ln1",), None, "empty"),
                (lay + ("ln2",), None, "empty")]
    out += [(lay + ("mixer", "wq"), (L, D, H, dh), "matrix"),
            (lay + ("mixer", "wk"), (L, D, Hkv, dh), "matrix"),
            (lay + ("mixer", "wv"), (L, D, Hkv, dh), "matrix"),
            (lay + ("mixer", "wo"), (L, H, dh, D), "matrix")]
    if cfg.get("num_experts"):
        E = cfg["num_experts"]
        out += [(lay + ("ffn", "router"), (L, D, E), "router"),
                (lay + ("ffn", "w_gate"), (L, E, D, F), "matrix"),
                (lay + ("ffn", "w_up"), (L, E, D, F), "matrix"),
                (lay + ("ffn", "w_down"), (L, E, F, D), "matrix")]
    else:
        out += [(lay + ("ffn", "w_gate"), (L, D, F), "matrix"),
                (lay + ("ffn", "w_up"), (L, D, F), "matrix"),
                (lay + ("ffn", "w_down"), (L, F, D), "matrix")]
    if not cfg["tie_word_embeddings"]:
        out.append((("unembed",), (D, Vp), "matrix"))
    return out


def active_params(cfg: dict) -> float:
    """Parameters a token runs through: attention, the dense FFN or the
    active experts and the router, the output projection (an embedding
    lookup is no product)."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = D // H
    per_layer = D * (H + 2 * Hkv) * dh + H * dh * D
    if cfg.get("num_experts"):
        per_layer += cfg["num_experts_per_tok"] * 3 * D * cfg["intermediate_size"]
        per_layer += D * cfg["num_experts"]
    else:
        per_layer += 3 * D * cfg["intermediate_size"]
    return float(cfg["num_hidden_layers"] * per_layer + D * V)


def attention_flops_token(cfg: dict, context: float) -> float:
    """q·k and p·v of one token over ``context`` keys in every layer."""
    return 4.0 * cfg["num_hidden_layers"] * cfg["hidden_size"] * context


def prefill_flops(cfg: dict, n: int) -> float:
    """A prompt of ``n`` real tokens: 2·N_active a token plus causal
    attention (token i attends over i + 1 keys)."""
    return 2.0 * active_params(cfg) * n + attention_flops_token(cfg, (n + 1) / 2.0) * n


def decode_flops(cfg: dict, context: int) -> float:
    """One generated token whose query attends over ``context`` keys."""
    return 2.0 * active_params(cfg) + attention_flops_token(cfg, context)


def request_flops(cfg: dict, prompt_len: int, n_generated: int) -> float:
    """A served request: its prompt's prefill (which gives the first
    token) and one decode for each later token, over a context that grows
    from ``prompt_len + 1``."""
    total = prefill_flops(cfg, prompt_len)
    for i in range(1, n_generated):
        total += decode_flops(cfg, prompt_len + i)
    return total


def train_flops_token(cfg: dict, seq: int) -> float:
    """A training token: 6·N_active for the forward and backward products,
    plus causal attention's 6·n_layers·seq·d_model (remat's recomputation
    not counted)."""
    return 6.0 * active_params(cfg) + 6.0 * cfg["num_hidden_layers"] * seq * cfg["hidden_size"]


# ---------------------------------------------------------------------------
# the forward


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``'s
    complement (the gradient passes straight through)."""
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (y - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., K) @ b (K, N) in float32, or with float8 operands."""
    if precision == "fp8":
        a, b = _q8(a, -1), _q8(b, 0)
    return a @ b


class Model:
    """The reference over one configuration, its tables and weights."""

    def __init__(self, cfg: dict, tables: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        if cfg.get("qk_norm"):
            raise NotImplementedError("the reference has no QK-norm yet")
        self.cfg = cfg
        self.tables = tables
        self.precision = precision
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.dh = self.D // self.H
        self.V = cfg["vocab_size"]

    # -- pieces ---------------------------------------------------------------
    def norm(self, x, scale):
        c = self.cfg
        if c["norm"] == "rmsnorm":
            y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + c["rms_norm_eps"])
            return y * (1.0 + scale)
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + c["layer_norm_eps"])

    def rope(self, x, n: int):
        """x (n, H, dh) at positions 0..n-1, angles in float64."""
        half = self.dh // 2
        inv = self.cfg["rope_theta"] ** (-torch.arange(half, dtype=torch.float64) / half)
        ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
        cos = torch.cos(ang).to(x.device, torch.float32)[:, None, :]
        sin = torch.sin(ang).to(x.device, torch.float32)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def softmax_pv(self, q, k, v):
        """Causal PWL-exp attention of one sequence: q (n, H, dh), k and v
        (n, Hkv, dh) -> (n, H, dh)."""
        n = q.shape[0]
        G = self.H // self.Hkv
        if G > 1:
            k = k.repeat_interleave(G, dim=1)
            v = v.repeat_interleave(G, dim=1)
        qh, kh, vh = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
        keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        prec = self.precision
        if prec == "fp8":
            qh, kh = _q8(qh, -1), _q8(kh, -1)
        s = (qh @ kh.transpose(1, 2)) * (1.0 / math.sqrt(self.dh))
        s = s.masked_fill(~keep, -1e30)
        t = torch.clamp(s - s.amax(dim=-1, keepdim=True), min=-1e4)
        u = torch.clamp(pwl(t, self.tables["exp"]), min=0.0) * keep
        p = u / torch.clamp(u.sum(dim=-1, keepdim=True), min=1e-30)
        if prec == "fp8":
            p, vh = _q8(p, -1), _q8(vh, -2)
        return (p @ vh).transpose(0, 1)

    def attention(self, p, x):
        """One attention block on one sequence x (n, D)."""
        n, D = x.shape
        prec = self.precision
        q = mm(x, p["wq"].reshape(D, -1), prec).view(n, self.H, self.dh)
        k = mm(x, p["wk"].reshape(D, -1), prec).view(n, self.Hkv, self.dh)
        v = mm(x, p["wv"].reshape(D, -1), prec).view(n, self.Hkv, self.dh)
        y = self.softmax_pv(self.rope(q, n), self.rope(k, n), v)
        return mm(y.reshape(n, -1), p["wo"].reshape(-1, D), prec)

    def glu(self, x, wg, wu, wd):
        prec = self.precision
        h = pwl(mm(x, wg, prec), self.tables[self.cfg["hidden_act"]]) * mm(x, wu, prec)
        return mm(h, wd, prec)

    def moe(self, p, x):
        """Dropless token-choice MoE over tokens x (T, D)."""
        K = self.cfg["num_experts_per_tok"]
        probs = torch.softmax(x @ p["router"], dim=-1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_w, top_e = top_w[:, :K], top_e[:, :K]
        if self.cfg["norm_topk_prob"]:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(self.cfg["num_experts"]):
            tok, slot = (top_e == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self.glu(x[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
            out = out.index_add(0, tok, y * top_w[tok, slot][:, None])
        return out

    def ffn(self, p, x):
        if self.cfg.get("num_experts"):
            return self.moe(p, x)
        return self.glu(x, p["w_gate"], p["w_up"], p["w_down"])

    def block(self, lp, xs):
        """One layer over a list of sequences (n_i, D)."""
        sc1 = lp.get("ln1", {}).get("scale")
        sc2 = lp.get("ln2", {}).get("scale")
        hs = [x + self.attention(lp["mixer"], self.norm(x, sc1)) for x in xs]
        sizes = [h.shape[0] for h in hs]
        h = torch.cat(hs)
        h = h + self.ffn(lp["ffn"], self.norm(h, sc2))
        return list(torch.split(h, sizes))

    def logits(self, params, h):
        sc = params["final_norm"].get("scale")
        hn = self.norm(h, sc)
        w = params["embed"].t() if self.cfg["tie_word_embeddings"] else params["unembed"]
        return mm(hn, w[:, : self.V], self.precision)


def _layer(params, l: int, f32) -> dict:
    """Layer l of the stacked tree, every leaf through ``f32``."""
    def sub(node):
        if torch.is_tensor(node):
            return f32(node[l])
        return {k: sub(v) for k, v in node.items()}

    return sub(params["layers"][0])


def served_logits(cfg: dict, tables: dict, params: dict, seqs: list, device,
                  precision: str = "f32") -> list[torch.Tensor]:
    """Teacher-forced logits (L_i, V) at the positions that produced each
    sequence's served tokens.  ``seqs``: (prompt, tokens) pairs; the input
    is the prompt and every served token but the last.  The weights are
    upcast to float32 one layer at a time."""
    model = Model(cfg, tables, precision)

    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    inputs = [list(p) + list(t[:-1]) for p, t in seqs]
    emb = params["embed"]
    with torch.no_grad():
        xs = [f32(emb[torch.as_tensor(ids, device=emb.device, dtype=torch.long)]) for ids in inputs]
        for l in range(cfg["num_hidden_layers"]):
            xs = model.block(_layer(params, l, f32), xs)
        top = {"final_norm": {k: f32(v) for k, v in params["final_norm"].items()},
               "embed": f32(params["embed"]) if cfg["tie_word_embeddings"] else None,
               "unembed": None if cfg["tie_word_embeddings"] else f32(params["unembed"])}
        out = []
        for x, (p, _) in zip(xs, seqs):
            out.append(model.logits(top, x[len(p) - 1:]))
    return out


# ---------------------------------------------------------------------------
# training


def lr_at(opt: dict, step: int) -> float:
    """The warmup-cosine schedule at 1-based ``step``, in float32."""
    s = np.float32(step)
    warm = min(s / np.float32(max(opt["warmup_steps"], 1)), np.float32(1.0))
    span = np.float32(max(opt["total_steps"] - opt["warmup_steps"], 1))
    t = np.clip((s - opt["warmup_steps"]) / span, 0.0, 1.0)
    decay = np.float32(0.5) * (np.float32(1.0) + np.float32(math.cos(math.pi * float(t))))
    return float(np.float32(opt["lr"]) * warm * decay)


def _unbind_layers(node, n: int) -> list:
    """The n layers of a stacked tree, each leaf split once by
    ``torch.unbind`` (whose backward stacks the layers' gradients in one
    copy; indexing each layer would add a zero-filled full-size gradient a
    layer)."""
    if torch.is_tensor(node):
        return list(torch.unbind(node, 0))
    split = {k: _unbind_layers(v, n) for k, v in node.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def loss_and_grads(model: Model, params: dict, leaves: list, tokens, targets):
    """Mean next-token cross entropy over the batch, by one sequence at a
    time, and the gradients of ``leaves`` summed over the sequences."""
    cfg = model.cfg
    B, S = tokens.shape
    total = 0.0
    grads = [torch.zeros_like(p) for p in leaves]
    for b in range(B):
        h = params["embed"][tokens[b].long()]
        for lp in _unbind_layers(params["layers"][0], cfg["num_hidden_layers"]):
            h = model.block(lp, [h])[0]
        lg = model.logits(params, h)
        nll = torch.logsumexp(lg, dim=-1) - lg.gather(1, targets[b].long()[:, None])[:, 0]
        loss = nll.sum() / (B * S)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc.add_(g)
        total += float(loss.detach())
    return total, grads


def train(cfg: dict, tables: dict, params: dict, leaves: list, batches: list, opt: dict,
          precision: str = "f32") -> dict:
    """AdamW steps over ``batches`` ((tokens, targets) pairs), updating the
    float32 ``leaves`` of ``params`` in place.  Returns each step's loss,
    the first step's gradient per leaf as AdamW takes it (after clipping)
    and its global norm before clipping."""
    model = Model(cfg, tables, precision)
    for p in leaves:
        p.requires_grad_(True)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first = [], None
    for i, (tok, tgt) in enumerate(batches):
        step = i + 1
        loss, grads = loss_and_grads(model, params, leaves, tok, tgt)
        losses.append(loss)
        gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        scale = min(opt["grad_clip"] / max(gnorm, 1e-12), 1.0)
        lr = lr_at(opt, step)
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            if first is None:
                first = {"leaf_norms": [float(g.double().norm()) * scale for g in grads],
                         "global_norm": gnorm}
            for p, g, m, v in zip(leaves, grads, mu, nu):
                g = g * scale
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).add_(g.square(), alpha=1.0 - b2)
                u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if p.dim() >= 2:
                    u = u + wd * p
                p.sub_(lr * u)
    for p in leaves:
        p.requires_grad_(False)
    return {"losses": losses, "first_grad": first}
