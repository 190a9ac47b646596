"""The autotuner's search space: per-site candidate specs.

The paper optimizes three axes per activation site — segment count (the
hardware-visible table depth), table data format (Sec. III multi-format
memories), and where the evaluation runs (beside the MAC array vs a
round-trip through memory).  This module enumerates the port's translation
of that space:

  * segments   — breakpoint counts matching the shipped table artifacts
                 (``core/tables/<fn>_<n>bp.npz``), so a full sweep never
                 triggers a fit-on-miss;
  * dtype      — the four :data:`repro_torch.sfu.spec.DTYPES` storage
                 formats, including the FQA-style ``int8`` full-space-quantized
                 grid;
  * impl       — ``fused`` (PWL decode as a producer-kernel epilogue),
                 ``jnp`` (unfused elementwise PWL), ``exact`` (reference
                 transcendental — the "don't approximate here" arm).

The JAX package also sweeps its Pallas kernels' tile shapes.  The CUDA
kernels fix their tiles themselves (the GLU family picks a configuration by
M; the flash kernels chain 512 keys a step, which also fixes their numbers),
so the port has no block axis: :func:`blocks_for` gives the single ``None``
block to every arm, which keeps the driver's measurement loop and report
schema the JAX package's.

Candidates are enumerated in deterministic order; the driver's argmin
tie-breaks on that order, which makes a warm-cache re-run byte-identical.
"""
from __future__ import annotations

from repro_torch.sfu.plan import FUSED_SITES
from repro_torch.sfu.spec import DEFAULT_FIT, ApproxSpec

# breakpoint counts with shipped artifacts (see src/repro_torch/core/tables/)
SEGMENT_SWEEP = (8, 16, 32, 64)
SEGMENT_SWEEP_QUICK = (8, 32)

DTYPE_SWEEP = ("f32", "bf16", "f16", "int8")
DTYPE_SWEEP_QUICK = ("f32", "int8")

# ordered fastest-datapath-first: the driver prefers earlier entries on a
# latency tie, and "fused" is the paper's headline configuration
IMPL_SWEEP = ("fused", "jnp", "exact")

# the canonical exact candidate: impl="exact" ignores segments/dtype, so a
# single representative avoids sweeping identical configurations
_EXACT_BP = 32


def candidates(site: str, fn: str, *, quick: bool = False) -> tuple[ApproxSpec, ...]:
    """All candidate specs for one plan site, in deterministic order.

    ``fused`` is only enumerated for sites a fused kernel covers
    (:data:`~repro_torch.sfu.plan.FUSED_SITES`); elsewhere the fused impl
    would silently run the jnp fallback, which the ``jnp`` arm already
    measures.
    """
    bps = SEGMENT_SWEEP_QUICK if quick else SEGMENT_SWEEP
    dtypes = DTYPE_SWEEP_QUICK if quick else DTYPE_SWEEP
    impls = [i for i in IMPL_SWEEP if i != "fused" or site in FUSED_SITES]
    out: list[ApproxSpec] = []
    for impl in impls:
        if impl == "exact":
            out.append(ApproxSpec(fn=fn, n_segments=_EXACT_BP + 1, dtype="f32",
                                  impl="exact", fit=DEFAULT_FIT))
            continue
        for bp in bps:
            for dtype in dtypes:
                out.append(ApproxSpec(fn=fn, n_segments=bp + 1, dtype=dtype,
                                      impl=impl, fit=DEFAULT_FIT))
    return tuple(out)


def blocks_for(site: str, impl: str, *, quick: bool = False) -> tuple:
    """Block shapes to sweep when measuring one (site, impl) arm: the
    single ``None`` block for every arm (the CUDA kernels take no tile
    argument)."""
    return (None,)
