"""`repro_torch.roofline` — the analytic roofline of a config on an H100:
model FLOPs, parameter counts, HBM traffic and peak memory per step
(:mod:`.model`); one rank's collectives, FLOPs and op histogram from its
traced step (:mod:`.collectives`, the counterpart of the JAX package's HLO
parser); the dry run's tables (:mod:`.report`)."""
from .model import (
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    RooflineReport,
    active_params,
    analytic_memory_traffic,
    analytic_peak_memory,
    model_flops_decode,
    model_flops_train,
    total_params,
)

__all__ = [
    "HBM_BW",
    "NVLINK_BW",
    "PEAK_FLOPS",
    "RooflineReport",
    "active_params",
    "analytic_memory_traffic",
    "analytic_peak_memory",
    "model_flops_decode",
    "model_flops_train",
    "total_params",
]
