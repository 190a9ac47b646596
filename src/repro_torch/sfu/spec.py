"""`ApproxSpec`: how one activation site is approximated.

A frozen, hashable record of the target function ``fn``, the segment count
(breakpoints + 1), the table storage format ``dtype``, the execution
strategy ``impl`` and the fit fingerprint ``fit``.  It round-trips through
the same JSON as the JAX package's spec, so plans move between the two.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import functions as F

# table storage formats; "int8" tables are de-quantized int8-grid values held
# in f32, so their evaluation dtype is float32
DTYPES = ("f32", "bf16", "f16", "int8")
TORCH_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "f16": torch.float16,
    "int8": torch.float32,
}

# execution strategies: exact transcendental, plain PWL, standalone PWL
# kernel, PWL as the epilogue of the producing kernel
IMPLS = ("exact", "jnp", "kernel", "fused")

FIT_SGD_V1 = "sgd-v1"      # shipped artifacts (SGD + breakpoint remove/insert)
FIT_UNIFORM = "uniform"    # uniform-breakpoint baseline, derived analytically
DEFAULT_FIT = FIT_SGD_V1


@dataclasses.dataclass(frozen=True)
class ApproxSpec:
    """How one activation site is approximated.  Frozen + hashable."""

    fn: str
    n_segments: int = 33
    dtype: str = "f32"
    impl: str = "jnp"
    fit: str = DEFAULT_FIT

    def __post_init__(self):
        F.get(self.fn)  # raises KeyError for unknown functions
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got '{self.impl}'")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got '{self.dtype}'")
        if self.n_segments < 3:
            raise ValueError(f"n_segments must be >= 3, got {self.n_segments}")

    @property
    def n_breakpoints(self) -> int:
        return self.n_segments - 1

    @property
    def is_exact(self) -> bool:
        return self.impl == "exact"

    @property
    def table_key(self) -> tuple[str, int, str, str]:
        """TableStore key: (fn, n_breakpoints, dtype, fit)."""
        return (self.fn, self.n_breakpoints, self.dtype, self.fit)

    def to_json(self) -> dict:
        return {
            "fn": self.fn,
            "n_segments": self.n_segments,
            "dtype": self.dtype,
            "impl": self.impl,
            "fit": self.fit,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ApproxSpec":
        return cls(
            fn=d["fn"],
            n_segments=int(d["n_segments"]),
            dtype=d.get("dtype", "f32"),
            impl=d.get("impl", "jnp"),
            fit=d.get("fit", DEFAULT_FIT),
        )
