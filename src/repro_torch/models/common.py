"""Model config + parameter definitions (torch).

A model is described by a tree (dicts and lists) of ``ParamDef`` leaves with
the JAX package's shapes and initial distributions.  :func:`init_params`
materializes it from an explicit ``torch.Generator`` on an explicit device.

Serving holds parameters the way the model uses them: matrices in
``cfg.dtype`` (the JAX package keeps f32 masters and casts every matrix to
``cfg.dtype`` at each use, which gives the same values), norm scales in f32
(the JAX package reads them in f32).  Each leaf carries the JAX package's logical axes, which
:func:`logical_specs` lists for the sharding rules.  Training holds f32 masters
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

from repro_torch.distributed.sharding import fsdp_gather


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
    ssm_state: int = 0                # mamba2: state size N, head dim P, expand,
    ssm_head_dim: int = 64            # causal conv width, SSD chunk length
    ssm_expand: int = 2
    ssm_conv_dim: int = 4
    ssm_chunk: int = 128
    attn_every: Optional[int] = None  # jamba: 1 attention layer per N (else SSM)
    moe_every: Optional[int] = None   # jamba: MoE FFN every N layers
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500           # stub frame-embedding length
    n_vision_tokens: int = 0          # stub patch-embedding prefix length
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True                # recompute each layer in the backward
    # small-model full data parallelism under a mesh (steps.make_cell_rules):
    # None decides by the parameter count, True / False force it
    force_dp_only: object = None
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


# The largest leaf drawn whole: olmoe-1b-7b's stacked expert matrices, 2^31
# elements.  The draw of every leaf up to it is the one its weights were
# first made with; a larger leaf is drawn a slice at a time.
DRAW_WHOLE_MAX = 1 << 31


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    # one logical axis per dim ("embed", "heads", "mlp", ...), the JAX
    # package's, which the sharding rules map to mesh axes
    logical_axes: tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | small_normal
    matrix: bool = True       # held in cfg.dtype (else f32)

    def materialize(self, gen: torch.Generator, device, dtype) -> torch.Tensor:
        """The parameter in ``dtype`` if it is a matrix, else in f32.

        A leaf of at most ``DRAW_WHOLE_MAX`` elements is drawn whole in f32
        and scaled in place; a larger one (qwen2.5-32b's stacked FFN
        matrices, 9.06e9 elements) one slice of its first axis at a time
        into the tensor it returns, so the f32 draw never holds more than a
        slice (a whole draw, and its scaled copy, would be 36 GB each)."""
        dt = dtype if self.matrix else torch.float32
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        if math.prod(self.shape) == 0:  # mamba2's (D, 0) / (0, D) FFN: nothing to draw
            return torch.empty(self.shape, dtype=dt, device=device)
        # the JAX package's fan-in is the second-to-last dim (first dim of a
        # vector), with a stacked layer axis in front
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[0]
        scale = 0.02 if self.init == "small_normal" else 1.0 / math.sqrt(fan_in)
        if math.prod(self.shape) <= DRAW_WHOLE_MAX:
            w = torch.randn(self.shape, generator=gen, device=device, dtype=torch.float32)
            return w.mul_(scale).to(dt)
        out = torch.empty(self.shape, dtype=dt, device=device)
        for i in range(self.shape[0]):
            w = torch.randn(self.shape[1:], generator=gen, device=device, dtype=torch.float32)
            out[i] = w.mul_(scale)
        return out


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: _map_defs(fn, v) for k, v in defs.items()}
    return [_map_defs(fn, v) for v in defs]


def zip_defs(fn, defs, other) -> Any:
    """``fn(def, o)`` over a ParamDef tree and a tree of its shape (specs,
    tensors)."""
    if isinstance(defs, ParamDef):
        return fn(defs, other)
    if isinstance(defs, dict):
        return {k: zip_defs(fn, v, other[k]) for k, v in defs.items()}
    return [zip_defs(fn, d, o) for d, o in zip(defs, other)]


def zeros_like_defs(defs, dtype, device, rules=None, specs=None) -> Any:
    """A cache of zeros in ``dtype`` shaped as ``defs``; under ``rules``
    each leaf placed by its spec in ``specs`` (a tree of defs' shape)."""
    if rules is None:
        return _map_defs(lambda d: torch.zeros(d.shape, dtype=dtype, device=device), defs)
    from repro_torch.distributed import shard_fused as shf

    return zip_defs(lambda d, s: shf.place(torch.zeros(d.shape, dtype=dtype, device=device),
                                           rules.mesh, s), defs, specs)


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
    held so), every other leaf as it is.  A DTensor leaf (a sharded state)
    outside the stacked layers is then gathered over its FSDP ("embed")
    axes: the products read whole rows, and the gradient is reduce-scattered
    back to the shard (the per-use gather GSPMD makes of an FSDP weight).
    The layer loops gather each layer where it runs (:func:`gather_layer`),
    so one layer's weights are whole at a time."""
    if isinstance(defs, ParamDef):
        p = params.to(dtype) if defs.matrix else params
        return p if defs.logical_axes[:1] == ("layers",) else fsdp_gather(p, defs.logical_axes)
    if isinstance(defs, dict):
        return {k: compute_params(v, params[k], dtype) for k, v in defs.items()}
    return [compute_params(d, p, dtype) for d, p in zip(defs, params)]


def shape_structs(defs, dtype) -> Any:
    """The tree of meta tensors a ParamDef tree describes, each in ``dtype``
    if it is a matrix, else f32: shapes and dtypes with no storage and no
    generator (the dry run's parameters and caches)."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=dtype if d.matrix else torch.float32,
                                           device="meta"), defs)


def logical_specs(defs) -> Any:
    """The tree of logical-axis tuples matching the parameter tree."""
    return _map_defs(lambda d: d.logical_axes, defs)


def gather_layer(defs, layer) -> Any:
    """One layer of a stacked tree (``layer``, its leaves DTensors under a
    mesh) with each leaf gathered over its FSDP axes; ``defs`` is the
    layer's unstacked ParamDef tree."""
    if isinstance(defs, ParamDef):
        return fsdp_gather(layer, defs.logical_axes)
    if isinstance(defs, dict):
        return {k: gather_layer(v, layer[k]) for k, v in defs.items()}
    return [gather_layer(d, x) for d, x in zip(defs, layer)]
