"""`repro_torch.sfu.autotune` — per-site (segments x dtype x impl) plan
search.

The paper hand-picks one operating point (32 segments, per-format tables);
this subsystem searches the whole space the SFU design exposes, per
activation site of a target architecture, against a two-part objective:

  * an **accuracy budget** — per-function table MSE within ``mse_scale`` x
    the config's own baseline plan, plus a Table-3-style end-to-end
    logit/top-1 gate on the assembled plan;
  * a **measured-latency objective** — median wall time of representative
    per-site workloads at the config's dimensions, in its dtype, on the
    device the search runs on (``cuda`` by default).

The winner is emitted as ordinary ``ActivationPlan`` JSON — directly
consumable by the ``--plan`` flag on train/serve — and every
measurement is cached on disk (:class:`MeasurementCache`) so re-runs are
incremental and a warm cache + fixed seed reproduces the plan
byte-for-byte.  CLI: ``python -m repro_torch.launch.autotune``.

This package is imported lazily (``from repro_torch.sfu import autotune``),
never from ``repro_torch.sfu.__init__`` — it reaches into
``repro_torch.configs`` / ``repro_torch.models``, which themselves import
``repro_torch.sfu``.
"""
from .cache import MeasurementCache, cache_key_id
from .driver import (
    DEFAULT_CACHE_DIR,
    AutotuneConfig,
    AutotuneResult,
    autotune,
)
from .measure import (
    e2e_logit_check,
    logit_metrics,
    machine_id,
    measure_site_latency,
    provenance,
    site_mse,
    time_fn,
    workload_for,
)
from .space import blocks_for, candidates

__all__ = [
    "AutotuneConfig",
    "AutotuneResult",
    "DEFAULT_CACHE_DIR",
    "MeasurementCache",
    "autotune",
    "blocks_for",
    "cache_key_id",
    "candidates",
    "e2e_logit_check",
    "logit_metrics",
    "machine_id",
    "measure_site_latency",
    "provenance",
    "site_mse",
    "time_fn",
    "workload_for",
]
