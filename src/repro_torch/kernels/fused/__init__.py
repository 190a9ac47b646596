"""Kernels with the PWL activation inside: producer epilogues (the fused
GLU) and the PWL-exp softmax of attention (row softmax, split-KV paged
decode, flash forward)."""
from .attention import fused_flash_attention, fused_flash_attention_plain
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
from .glu import fused_glu, fused_glu_plain
from .softmax import fused_pwl_softmax, fused_pwl_softmax_plain

__all__ = [
    "IDENTITY",
    "EpiloguePlan",
    "exact_plan",
    "fused_flash_attention",
    "fused_flash_attention_plain",
    "fused_glu",
    "fused_glu_plain",
    "fused_pwl_softmax",
    "fused_pwl_softmax_plain",
    "merge_split_partials",
    "pack_table",
    "paged_flash_decode",
    "paged_flash_decode_plain",
    "plan_and_operands",
    "pwl_value_and_slope",
    "table_dtype_name",
]
