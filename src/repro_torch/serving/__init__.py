"""`repro_torch.serving` — paged KV cache, continuous batching, serving
engine (the torch port of ``repro.serving``).

The page writes are hand-written CUDA kernels that update the pools in
place (:mod:`.kv_cache`); the scheduler and the resilience types are the
port's own copies of the JAX package's pure-Python host logic.
"""
from .engine import PagedServingEngine
from .kv_cache import (
    SENTINEL_PAGE,
    PageAllocator,
    append_kv_,
    gather_pages,
    write_prompt_pages_,
)
from .resilience import (
    FINISH_REASONS,
    POLICIES,
    PagePoolExhausted,
    RequestRejected,
    RetryPolicy,
    ServingError,
    StepRetriesExhausted,
    UnsupportedCacheError,
)
from .scheduler import Admission, ContinuousBatchingScheduler, GenRequest, GenResult

__all__ = [
    "SENTINEL_PAGE",
    "PageAllocator",
    "PagedServingEngine",
    "ContinuousBatchingScheduler",
    "Admission",
    "GenRequest",
    "GenResult",
    "append_kv_",
    "gather_pages",
    "write_prompt_pages_",
    "FINISH_REASONS",
    "POLICIES",
    "PagePoolExhausted",
    "RequestRejected",
    "RetryPolicy",
    "ServingError",
    "StepRetriesExhausted",
    "UnsupportedCacheError",
]
