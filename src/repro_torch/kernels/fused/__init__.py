"""Kernels with the PWL activation inside: producer epilogues (the fused
GLU, the per-expert MoE GLU, the fused linear layer and the fused RMSNorm,
forward and backward) and the PWL-exp softmax of attention (row softmax
forward and backward, split-KV paged decode, flash forward and backward)."""
from .attention import (
    flash_reference_attention,
    fused_flash_attention,
    fused_flash_attention_bwd,
    fused_flash_attention_bwd_plain,
    fused_flash_attention_plain,
)
from .backward import IMPL_BWD_MODES, current_impl_bwd, resolve_impl_bwd, use_impl_bwd
from .decoding import merge_split_partials, paged_flash_decode, paged_flash_decode_plain
from .epilogue import (
    IDENTITY,
    EpiloguePlan,
    exact_plan,
    pack_table,
    plan_and_operands,
    pwl_value_and_slope,
    table_dtype_name,
)
from .glu import fused_glu, fused_glu_bwd, fused_glu_bwd_plain, fused_glu_plain
from .linear import fused_linear, fused_linear_bwd, fused_linear_bwd_plain, fused_linear_plain
from .moe import fused_moe_glu
from .norm import fused_rmsnorm, fused_rmsnorm_bwd, fused_rmsnorm_bwd_plain, fused_rmsnorm_plain
from .softmax import (
    fused_pwl_softmax,
    fused_pwl_softmax_bwd,
    fused_pwl_softmax_bwd_plain,
    fused_pwl_softmax_plain,
)

__all__ = [
    "IDENTITY",
    "IMPL_BWD_MODES",
    "EpiloguePlan",
    "current_impl_bwd",
    "exact_plan",
    "flash_reference_attention",
    "fused_flash_attention",
    "fused_flash_attention_bwd",
    "fused_flash_attention_bwd_plain",
    "fused_flash_attention_plain",
    "fused_glu",
    "fused_glu_bwd",
    "fused_glu_bwd_plain",
    "fused_glu_plain",
    "fused_linear",
    "fused_linear_bwd",
    "fused_linear_bwd_plain",
    "fused_linear_plain",
    "fused_moe_glu",
    "fused_pwl_softmax",
    "fused_pwl_softmax_bwd",
    "fused_pwl_softmax_bwd_plain",
    "fused_pwl_softmax_plain",
    "fused_rmsnorm",
    "fused_rmsnorm_bwd",
    "fused_rmsnorm_bwd_plain",
    "fused_rmsnorm_plain",
    "merge_split_partials",
    "pack_table",
    "paged_flash_decode",
    "paged_flash_decode_plain",
    "plan_and_operands",
    "pwl_value_and_slope",
    "resolve_impl_bwd",
    "table_dtype_name",
    "use_impl_bwd",
]
