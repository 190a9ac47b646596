"""`TableStore`: the port's fitted PWL table artifacts, keyed by
(fn, n_breakpoints, dtype, fit fingerprint).

The artifacts are the port's own copy of the shipped fits
(``repro_torch/core/tables/<fn>_<n>bp.npz``).  A missing artifact raises:
the uniform-breakpoint fallback and fit-on-miss need the fitting pipeline,
which is not ported yet.  Tables are host (CPU) tensors; kernels copy the
packed operands to the device once.
"""
from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import pwl

from .spec import DEFAULT_FIT, FIT_UNIFORM, TORCH_DTYPES, ApproxSpec

TABLE_DIR = pathlib.Path(__file__).parent.parent / "core" / "tables"


def quantize_table(table: pwl.PWLTable, dtype: str) -> pwl.PWLTable:
    """Round-trip a table's coefficients through a storage format: identity
    for "f32", the full-space int8 grid for "int8", a cast (round to nearest
    even) for "bf16"/"f16"."""
    if dtype == "f32":
        return table
    if dtype == "int8":
        from repro_torch.core.quantize import full_space_int8

        return full_space_int8(table)
    td = TORCH_DTYPES[dtype]
    return pwl.PWLTable(bp=table.bp.to(td), m=table.m.to(td), q=table.q.to(td),
                        name=table.name, storage=dtype)


class TableStore:
    """Read-only artifact store with a per-key cache."""

    def __init__(self, root: Optional[pathlib.Path] = None):
        self.root = pathlib.Path(root) if root is not None else TABLE_DIR
        self._cache: dict[tuple, pwl.PWLTable] = {}

    def artifact_path(self, fn: str, n_breakpoints: int, fit: str = DEFAULT_FIT) -> pathlib.Path:
        if fit == DEFAULT_FIT:
            return self.root / f"{fn}_{n_breakpoints}bp.npz"
        return self.root / f"{fn}_{n_breakpoints}bp__{fit}.npz"

    def get(
        self,
        spec: Optional[ApproxSpec] = None,
        *,
        fn: Optional[str] = None,
        n_breakpoints: int = 32,
        dtype: str = "f32",
        fit: str = DEFAULT_FIT,
    ) -> pwl.PWLTable:
        """Table for a spec (or keyword key), quantized to its dtype."""
        if spec is not None:
            fn, n_breakpoints, dtype, fit = spec.table_key
        if fn is None:
            raise TypeError("get() needs a spec or fn=")
        key = (fn, n_breakpoints, dtype, fit)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        if fit == FIT_UNIFORM:
            raise NotImplementedError(
                "uniform-breakpoint tables need the fitting slice, which is "
                "not ported yet")
        path = self.artifact_path(fn, n_breakpoints, fit)
        if not path.exists():
            raise FileNotFoundError(
                f"no fitted PWL table at {path}; the port reads only its "
                "shipped artifacts (fit-on-miss is not ported yet)")
        table = quantize_table(self._load(path, fn), dtype)
        self._cache[key] = table
        return table

    @staticmethod
    def _load(path: pathlib.Path, fn: str) -> pwl.PWLTable:
        with np.load(path) as data:
            return pwl.PWLTable(
                bp=torch.from_numpy(np.asarray(data["bp"], np.float32)),
                m=torch.from_numpy(np.asarray(data["m"], np.float32)),
                q=torch.from_numpy(np.asarray(data["q"], np.float32)),
                name=fn,
            )


_DEFAULT_STORE: Optional[TableStore] = None


def get_store() -> TableStore:
    """Process-wide default store over the shipped artifact directory."""
    global _DEFAULT_STORE
    if _DEFAULT_STORE is None:
        _DEFAULT_STORE = TableStore()
    return _DEFAULT_STORE
