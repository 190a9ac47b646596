"""Three-term roofline model on an NVIDIA H100, and the analytic counts
of a config (the JAX package's ``roofline/model.py`` with the H100's peaks).

  compute    = FLOPs / (chips * 989e12 FLOP/s)       [bf16 dense tensor cores]
  memory     = bytes / (chips * 3.35e12 B/s)         [HBM3]
  collective = collective bytes / (chips * 450e9 B/s) [NVLink, one direction]

All terms are *seconds per step*.  :class:`RooflineReport` takes per-device
FLOPs and bytes, so it divides by per-device rates only; the ``chips``
division applies when deriving from whole-model analytic FLOPs
(``mfu``).  ``mesh_shape`` arguments name the axes of a device mesh
(``{"data": 16, "model": 16}``); ``{}`` means one device.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3 (SXM), 700 W, data sheet
PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s per device
# NVIDIA H100 80GB HBM3 (SXM), 700 W, data sheet
HBM_BW = 3.35e12         # HBM3 bytes/s per device
# NVIDIA H100 80GB HBM3 (SXM), 700 W, data sheet: NVLink 4, 900 GB/s both ways
NVLINK_BW = 450e9        # bytes/s per device, one direction


@dataclasses.dataclass
class RooflineReport:
    """One step's per-device counts against the H100's peaks.  The field
    names are the JAX package's, whose counts came from compiled HLO."""

    name: str
    chips: int
    hlo_flops: float          # per device: the FLOPs the step executes
    hlo_bytes: float          # per device: the bytes it moves through HBM
    coll_bytes: float         # per device: the bytes it sends over NVLink
    model_flops: float        # whole-model useful FLOPs (6*N*D etc.)
    peak_mem_bytes: float     # per device

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global executed FLOPs): compute efficiency."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips * peak * bound-time) — roofline fraction."""
        t = self.t_bound
        return self.model_flops / (self.chips * PEAK_FLOPS * t) if t else 0.0

    def row(self) -> dict:
        return {
            "name": self.name,
            "chips": self.chips,
            "t_compute_ms": 1e3 * self.t_compute,
            "t_memory_ms": 1e3 * self.t_memory,
            "t_collective_ms": 1e3 * self.t_collective,
            "bottleneck": self.bottleneck,
            "model_gflops": self.model_flops / 1e9,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_at_bound": self.mfu,
            "peak_mem_gb": self.peak_mem_bytes / 2**30,
        }


def model_flops_train(cfg, tokens: int) -> float:
    """6*N*D for dense; 6*N_active*D for MoE; SSM counted analytically."""
    n_active = active_params(cfg)
    return 6.0 * n_active * tokens


def model_flops_decode(cfg, batch: int, cache_len: int) -> float:
    """Per decode step: 2*N_active per token + attention over the cache."""
    n_active = active_params(cfg)
    flops = 2.0 * n_active * batch
    dh = cfg.resolved_head_dim
    n_attn = sum(1 for m, _ in cfg.layer_kinds if m.startswith("attn"))
    for m, _ in cfg.layer_kinds:
        if not m.startswith("attn"):
            continue
        eff = cache_len
        if m == "attn_local" and cfg.sliding_window:
            eff = min(cache_len, cfg.sliding_window)
        flops += 2.0 * 2.0 * batch * cfg.n_heads * dh * eff  # qk + pv
    return flops


def total_params(cfg) -> float:
    """All parameters (MoE counts every expert — they all live in HBM)."""
    if cfg.n_experts:
        import dataclasses

        dense_like = dataclasses.replace(
            cfg, n_active_experts=cfg.n_experts
        )
        return active_params(dense_like)
    return active_params(cfg)


def analytic_memory_traffic(cfg, cell, mesh_shape: dict) -> float:
    """First-principles per-device HBM traffic (bytes/step) for the roofline
    memory term.

    Accounting (bf16 weights/activations, f32 optimizer):
      train:   weights 4x (gather-write + fwd + bwd + remat re-read) / TP shard
               + optimizer 24 B/param on the FSDP+TP shard
               + ~16 activation tensors r+w per layer
               + logits r+w
      prefill: weights 1x + ~8 activation tensors per layer + cache write
      decode:  weights 1x + full cache read + slot write
    """
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    P = total_params(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    B, S = cell.global_batch, cell.seq_len
    B_loc = max(B // dp, 1)
    L = cfg.n_layers + (cfg.n_encoder_layers or 0)
    dh = cfg.resolved_head_dim
    kv_bytes_full = 0.0
    for m, _ in cfg.layer_kinds:
        if m.startswith("attn"):
            eff = S
            if m == "attn_local" and cfg.sliding_window:
                eff = min(S, cfg.sliding_window)
            kv_bytes_full += 2 * eff * cfg.n_kv_heads * dh * 2  # k+v bf16
        elif m == "ssm":
            from repro_torch.models.ssm import ssm_dims

            d_inner, n_heads, d_state, conv_ch, _ = ssm_dims(cfg)
            kv_bytes_full += n_heads * cfg.ssm_head_dim * d_state * 2
    if cfg.is_encoder_decoder:
        kv_bytes_full += cfg.n_layers * 2 * (S + cfg.encoder_seq) * cfg.n_kv_heads * dh * 2

    if cell.kind == "train":
        w = 4 * P * 2 / tp
        opt = 24 * P / (tp * dp)
        acts = L * 16 * B_loc * S * D * 2
        logits = 2 * B_loc * S * V * 4
        return w + opt + acts + logits
    if cell.kind == "prefill":
        w = P * 2 / tp
        acts = L * 8 * B_loc * S * D * 2
        cache_w = B_loc * kv_bytes_full / tp
        return w + acts + cache_w
    # decode
    w = P * 2 / tp
    cache_rw = B_loc * kv_bytes_full / tp  # read whole cache + write slot
    acts = L * 8 * B_loc * 1 * D * 2
    logits = 2 * B_loc * V * 4
    return w + cache_rw + acts + logits


def analytic_peak_memory(cfg, cell, mesh_shape: dict, microbatches: int = 1) -> float:
    """Per-device peak HBM estimate from first principles.

      train:  opt state (12 B/param, FSDP+TP-sharded) + f32 grad accum
              + per-microbatch layer-boundary activations + logits + one
              gathered layer's weights
      decode: bf16 params (sharded) + KV/SSM cache shard + small activations
    """
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    P = total_params(cfg)
    D, Vp = cfg.d_model, cfg.padded_vocab
    B, S = cell.global_batch, cell.seq_len
    b_loc = max(B // dp, 1)
    shards = tp * dp
    dh = cfg.resolved_head_dim
    if cfg.is_encoder_decoder:
        n_bound = cfg.n_layers + cfg.n_encoder_layers
    else:
        n_bound = cfg.n_layers // max(cfg.period, 1)
    max_layer_params = P / max(cfg.n_layers, 1)

    cache_dev = 0.0
    for m, _ in cfg.layer_kinds:
        if m.startswith("attn"):
            eff = S if not (m == "attn_local" and cfg.sliding_window) else min(
                S, cfg.sliding_window
            )
            cache_dev += 2 * eff * cfg.n_kv_heads * dh * 2
        elif m == "ssm":
            from repro_torch.models.ssm import ssm_dims

            d_inner, n_heads, d_state, conv_ch, _ = ssm_dims(cfg)
            cache_dev += n_heads * cfg.ssm_head_dim * d_state * 2
    if cfg.is_encoder_decoder:
        cache_dev += cfg.n_layers * 2 * (S + cfg.encoder_seq) * cfg.n_kv_heads * dh * 2
    cache_dev *= max(B // dp, 1) / tp if B >= dp else 1.0 / (tp * dp)
    cache_dev = cache_dev if B >= dp else cache_dev * B  # B=1 long-context

    if cell.kind == "train":
        b_mb = max(b_loc // microbatches, 1)
        opt = 12 * P / shards
        gacc = (4 * P / shards) if microbatches > 1 else 0
        acts = n_bound * b_mb * S * D * 2
        logits = b_mb * S * Vp * 4 / tp
        wset = 2 * max_layer_params * 2 / tp
        return opt + gacc + acts + logits + wset
    if cell.kind == "prefill":
        w = 2 * P / shards
        acts = 4 * b_loc * S * D * 2
        return w + acts + cache_dev
    w = 2 * P / shards
    return w + cache_dev + b_loc * Vp * 4 / tp


def active_params(cfg) -> float:
    """Active parameter count (MoE counts top-k experts only)."""
    D, V = cfg.d_model, cfg.vocab_size
    dh = cfg.resolved_head_dim
    total = V * D * (1 if cfg.tie_embeddings else 2)
    for mixer, ffn in cfg.layer_kinds:
        if mixer == "ssm":
            from repro_torch.models.ssm import ssm_dims

            d_inner, n_heads, d_state, conv_ch, d_in_proj = ssm_dims(cfg)
            total += D * d_in_proj + d_inner * D + conv_ch * cfg.ssm_conv_dim
        else:
            total += D * (cfg.n_heads + cfg.n_kv_heads * 2) * dh + cfg.n_heads * dh * D
        if ffn == "moe":
            total += cfg.n_active_experts * 3 * D * cfg.moe_d_ff + D * cfg.n_experts
        elif cfg.mlp_type in ("swiglu", "geglu"):
            total += 3 * D * cfg.d_ff
        else:
            total += 2 * D * cfg.d_ff
    if cfg.is_encoder_decoder:
        # encoder layers + decoder cross-attention
        total += cfg.n_encoder_layers * (
            D * (cfg.n_heads + cfg.n_kv_heads * 2) * dh
            + cfg.n_heads * dh * D
            + 2 * D * cfg.d_ff
        )
        total += cfg.n_layers * (D * (cfg.n_heads + cfg.n_kv_heads * 2) * dh + cfg.n_heads * dh * D)
    return float(total)
