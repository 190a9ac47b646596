"""MeasurementCache: the keyed artifact store behind incremental autotuning.

Same discipline as :class:`repro_torch.sfu.store.TableStore`, applied to
measurements instead of tables: every (site, spec, block, workload,
machine) point the driver ever measures is written to disk under a content
key, so

  * re-running a search is incremental — only never-measured points pay
    the wall-clock cost;
  * a warm cache plus a fixed seed makes the whole search deterministic —
    latencies are read back instead of re-sampled, so the argmin (and
    therefore the emitted plan bytes) cannot drift between runs.

Keys are plain JSON-able dicts; the filename is a sha1 of the
sorted-keys canonical encoding, the same fingerprint recipe
``ActivationPlan.fingerprint`` uses.  The driver includes the machine
identity (backend / device name / device count / package) in every key, so
numbers measured on the CPU's plain versions and on a GPU's kernels, or by
the JAX package, never alias.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Any, Callable, Optional


def cache_key_id(key: dict) -> str:
    """Stable 16-hex id of a JSON-able key dict (sorted-keys sha1)."""
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class MeasurementCache:
    """Disk-backed, in-memory-fronted map from key dict to JSON value."""

    def __init__(self, root) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._mem: dict[str, Any] = {}
        self.hits = 0
        self.misses = 0

    def _path(self, kid: str) -> pathlib.Path:
        return self.root / f"{kid}.json"

    def get(self, key: dict) -> Optional[Any]:
        kid = cache_key_id(key)
        if kid in self._mem:
            self.hits += 1
            return self._mem[kid]
        p = self._path(kid)
        if p.exists():
            entry = json.loads(p.read_text())
            self._mem[kid] = entry["value"]
            self.hits += 1
            return entry["value"]
        return None

    def put(self, key: dict, value: Any) -> Any:
        kid = cache_key_id(key)
        self._mem[kid] = value
        # the full key rides along so a human can audit what a file means
        self._path(kid).write_text(
            json.dumps({"key": key, "value": value}, indent=2, sort_keys=True)
            + "\n"
        )
        return value

    def get_or(self, key: dict, compute: Callable[[], Any]) -> Any:
        found = self.get(key)
        if found is not None:
            return found
        self.misses += 1
        return self.put(key, compute())

    def __len__(self) -> int:
        return len(list(self.root.glob("*.json")))
