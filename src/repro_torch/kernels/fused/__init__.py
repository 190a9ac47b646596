"""Producer kernels with the PWL activation as their epilogue."""
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

__all__ = [
    "IDENTITY",
    "EpiloguePlan",
    "exact_plan",
    "fused_glu",
    "fused_glu_plain",
    "pack_table",
    "plan_and_operands",
    "pwl_value_and_slope",
    "table_dtype_name",
]
