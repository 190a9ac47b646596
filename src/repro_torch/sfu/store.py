"""`TableStore`: provenance-aware PWL table artifacts, keyed by
(fn, n_breakpoints, dtype, fit fingerprint).

Counterpart of ``repro/sfu/store.py``, and the same artifacts: an npz of
f32 ``bp`` / ``m`` / ``q`` with an embedded JSON provenance record (fit
fingerprint, fit config, error metrics, library version, creation time),
so either package reads what the other wrote.  Legacy artifacts without the
record keep loading (``provenance()`` -> None).

A request resolves in order: ``fit="uniform"`` is the analytic uniform
table (never a fallback); a fitted artifact on disk; fit-on-miss when asked
for (the paper's SGD fit, ``core/fit.py``, on ``fit_device``); else the
uniform-breakpoint fallback, which warns once per store and stays
upgradeable: a later request re-checks the artifact path.  The fallback is
the table semantics of the JAX package, not a move between devices.

Tables are host (CPU) tensors; kernels copy the packed operands to the
device once.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import fit as fitlib
from repro_torch.core import functions as F
from repro_torch.core import pwl

from .spec import DEFAULT_FIT, FIT_UNIFORM, TORCH_DTYPES, ApproxSpec

# the port's copy of the shipped artifacts
TABLE_DIR = pathlib.Path(__file__).parent.parent / "core" / "tables"

PROVENANCE_SCHEMA = 1


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
    """Artifact-backed table cache with fit-on-miss and fallback upgrade."""

    def __init__(
        self,
        root: Optional[pathlib.Path] = None,
        fit_on_miss: bool = False,
        fit_config: Optional[fitlib.FitConfig] = None,
        fit_device="cuda",
    ):
        self.root = pathlib.Path(root) if root is not None else TABLE_DIR
        self.fit_on_miss = fit_on_miss
        self.fit_config = fit_config
        self.fit_device = fit_device
        self._cache: dict[tuple, pwl.PWLTable] = {}
        self._fallback: set[tuple] = set()   # keys served by the uniform fallback
        self._warned_missing = False

    def artifact_path(self, fn: str, n_breakpoints: int, fit: str = DEFAULT_FIT) -> pathlib.Path:
        """On-disk artifact for a (fn, n_bp, fit) triple; the default fit
        keeps the historical ``<fn>_<n>bp.npz`` name."""
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
        if cached is not None and key not in self._fallback:
            return cached

        if fit == FIT_UNIFORM:
            table = quantize_table(self._uniform(fn, n_breakpoints), dtype)
            self._cache[key] = table
            return table

        path = self.artifact_path(fn, n_breakpoints, fit)
        if path.exists():
            table = quantize_table(self._load(path, fn), dtype)
            self._cache[key] = table
            self._fallback.discard(key)  # fallback upgraded to the fitted table
            return table

        if self.fit_on_miss:
            result = fitlib.fit(fn, n_breakpoints, cfg=self.fit_config, device=self.fit_device)
            self.put(result.table, fit=fit, mse=result.mse, mae=result.mae,
                     extra={"range": list(result.range), "trigger": "fit-on-miss"})
            return self.get(fn=fn, n_breakpoints=n_breakpoints, dtype=dtype, fit=fit)

        if cached is not None:  # known fallback, artifact still missing
            return cached
        if not self._warned_missing:
            self._warned_missing = True
            warnings.warn(
                f"no fitted PWL table at {path}; using uniform-breakpoint "
                "fallback for missing tables (run `python -m "
                "repro_torch.core.gen_tables` to generate fitted artifacts)")
        table = quantize_table(self._uniform(fn, n_breakpoints), dtype)
        self._cache[key] = table
        self._fallback.add(key)
        return table

    def provenance(self, fn: str, n_breakpoints: int, fit: str = DEFAULT_FIT) -> Optional[dict]:
        """Embedded provenance record of an artifact, or None (no artifact, or
        a legacy artifact written before provenance existed)."""
        path = self.artifact_path(fn, n_breakpoints, fit)
        if not path.exists():
            return None
        with np.load(path) as data:
            if "provenance" not in data.files:
                return None
            return json.loads(str(data["provenance"]))

    def put(
        self,
        table: pwl.PWLTable,
        fit: str = DEFAULT_FIT,
        mse: Optional[float] = None,
        mae: Optional[float] = None,
        extra: Optional[dict] = None,
    ) -> pathlib.Path:
        """Persist a fitted table with embedded provenance; drops the cache
        entries the new artifact supersedes (all dtypes)."""
        import repro_torch

        fn = table.name
        F.get(fn)  # the artifact must name a known function
        n_bp = int(table.bp.shape[0])
        self.root.mkdir(parents=True, exist_ok=True)
        path = self.artifact_path(fn, n_bp, fit)
        prov = {
            "schema": PROVENANCE_SCHEMA,
            "fn": fn,
            "n_breakpoints": n_bp,
            "n_segments": n_bp + 1,
            "fit": fit,
            "repro_version": repro_torch.__version__,
            "created_unix": int(time.time()),
        }
        if mse is not None:
            prov["mse"] = float(mse)
        if mae is not None:
            prov["mae"] = float(mae)
        if extra:
            prov.update(extra)
        payload = {
            "bp": _f32(table.bp),
            "m": _f32(table.m),
            "q": _f32(table.q),
            "provenance": json.dumps(prov),
        }
        if mse is not None:  # legacy keys some benchmarks read
            payload["mse"] = mse
        if mae is not None:
            payload["mae"] = mae
        np.savez(path, **payload)
        for key in [k for k in self._cache if k[0] == fn and k[1] == n_bp and k[3] == fit]:
            del self._cache[key]
            self._fallback.discard(key)
        return path

    def fit_and_put(
        self, fn: str, n_breakpoints: int, fit: str = DEFAULT_FIT,
        fit_config: Optional[fitlib.FitConfig] = None,
    ) -> fitlib.FitResult:
        """Run the paper's SGD fit (core/fit.py) on ``fit_device`` and persist
        the artifact."""
        cfg = fit_config or self.fit_config
        result = fitlib.fit(fn, n_breakpoints, cfg=cfg, device=self.fit_device)
        self.put(
            result.table, fit=fit, mse=result.mse, mae=result.mae,
            extra={
                "range": list(result.range),
                "fit_config": dataclasses.asdict(cfg) if cfg else "default",
            },
        )
        return result

    @staticmethod
    def _load(path: pathlib.Path, fn: str) -> pwl.PWLTable:
        with np.load(path) as data:
            return pwl.PWLTable(
                bp=torch.from_numpy(np.asarray(data["bp"], np.float32)),
                m=torch.from_numpy(np.asarray(data["m"], np.float32)),
                q=torch.from_numpy(np.asarray(data["q"], np.float32)),
                name=fn,
            )

    @staticmethod
    def _uniform(fn: str, n_breakpoints: int) -> pwl.PWLTable:
        return pwl.make_uniform_table(F.get(fn), n_breakpoints)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy()


_DEFAULT_STORE: Optional[TableStore] = None


def get_store() -> TableStore:
    """Process-wide default store over the shipped artifact directory."""
    global _DEFAULT_STORE
    if _DEFAULT_STORE is None:
        _DEFAULT_STORE = TableStore()
    return _DEFAULT_STORE
