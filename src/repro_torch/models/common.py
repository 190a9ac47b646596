"""Model config + parameter definitions (torch).

A model is described by a tree (dicts and lists) of ``ParamDef`` leaves with
the JAX package's shapes and initial distributions.  :func:`init_params`
materializes it from an explicit ``torch.Generator`` on an explicit device.

Serving holds parameters the way the model uses them: matrices in
``cfg.dtype`` (the JAX package keeps f32 masters and casts every matrix to
``cfg.dtype`` at each use, which gives the same values), norm scales in f32
(the JAX package reads them in f32).  Training holds f32 masters
(``init_params(..., master=True)``), as the JAX package does, and
:func:`compute_params` casts them to the serving layout with a
differentiable ``.to()`` once per step, so each gradient lands on its f32
master and AdamW updates in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "silu"
    mlp_type: str = "swiglu"          # swiglu | geglu | mlp
    norm_type: str = "rmsnorm"
    qkv_bias: bool = False
    act_impl: str = "exact"           # exact | jnp | kernel | fused (sfu.IMPLS)
    # backward of the fused sites: "fused" (the backward kernels) |
    # "recompute" (plain recomputation, the oracle); None = the ambient
    # kernels.fused.use_impl_bwd default
    act_impl_bwd: Optional[str] = None
    act_breakpoints: int = 32
    act_site_specs: tuple = ()        # ((site_key, ApproxSpec), ...) pins
    pwl_softmax: bool = False         # PWL-exp softmax (paper Sec. V-B)
    act_table_dtype: str = "f32"
    act_plan: Any = None              # explicit sfu.ActivationPlan
    sliding_window: Optional[int] = None
    global_every: Optional[int] = None
    rope_theta: float = 10000.0
    n_experts: int = 0
    n_active_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    attn_every: Optional[int] = None
    moe_every: Optional[int] = None
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500           # stub frame-embedding length
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True                # recompute each layer in the backward
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; pad logits are masked."""
        m = 256
        return -(-self.vocab_size // m) * m

    @property
    def layer_kinds(self) -> list[tuple[str, str]]:
        """Per-layer (mixer, ffn) kinds."""
        kinds = []
        for i in range(self.n_layers):
            if self.attn_every:
                mixer = "attn" if i % self.attn_every == self.attn_every // 2 else "ssm"
            elif self.family == "ssm":
                mixer = "ssm"
            elif self.global_every:
                mixer = "attn_global" if (i + 1) % self.global_every == 0 else "attn_local"
            elif self.sliding_window:
                mixer = "attn_local"
            else:
                mixer = "attn"
            if self.moe_every:
                ffn = "moe" if i % self.moe_every == 1 else "dense"
            elif self.n_experts > 0:
                ffn = "moe"
            else:
                ffn = "dense"
            kinds.append((mixer, ffn))
        return kinds

    @property
    def period(self) -> int:
        """Smallest repeating period of layer kinds (the stacking unit)."""
        kinds = self.layer_kinds
        for p in range(1, len(kinds) + 1):
            if all(kinds[i] == kinds[i % p] for i in range(len(kinds))):
                if len(kinds) % p == 0:
                    return p
        return len(kinds)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | small_normal
    matrix: bool = True       # held in cfg.dtype (else f32)

    def materialize(self, gen: torch.Generator, device, dtype) -> torch.Tensor:
        """The parameter in ``dtype`` if it is a matrix, else in f32."""
        dt = dtype if self.matrix else torch.float32
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        # the JAX package's fan-in is the second-to-last dim (first dim of a
        # vector), with a stacked layer axis in front
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[0]
        scale = 0.02 if self.init == "small_normal" else 1.0 / math.sqrt(fan_in)
        w = torch.randn(self.shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dt)


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: _map_defs(fn, v) for k, v in defs.items()}
    return [_map_defs(fn, v) for v in defs]


def init_params(defs, seed: int, device, dtype, master: bool = False) -> Any:
    """Materialize a ParamDef tree from a seeded generator on ``device``.

    The distributions are the JAX package's (normal with 1/sqrt(fan_in),
    0.02 for ``small_normal``, zeros/ones); the numbers differ, since a torch
    generator is not a JAX key.  Leaves draw in tree order from one
    generator.  ``master=True`` holds every leaf in f32 (training masters);
    the values are the ones :func:`compute_params` casts back."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = torch.float32 if master else dtype
    return _map_defs(lambda d: d.materialize(gen, dev, dt), defs)


def compute_params(defs, params, dtype) -> Any:
    """The tree the model computes with: every matrix of ``params`` cast to
    ``dtype`` by a differentiable ``.to()`` (a no-op on a tree already
    held so), every other leaf as it is."""
    if isinstance(defs, ParamDef):
        return params.to(dtype) if defs.matrix else params
    if isinstance(defs, dict):
        return {k: compute_params(v, params[k], dtype) for k, v in defs.items()}
    return [compute_params(d, p, dtype) for d, p in zip(defs, params)]
