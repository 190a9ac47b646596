"""`repro_torch.serving` — paged KV cache, continuous batching, serving
engine (the torch port of ``repro.serving``).

The page writes are hand-written CUDA kernels that update the pools in
place (:mod:`.kv_cache`); the scheduler, the resilience types and the
deterministic fault injector (:mod:`.faults`) are the port's own copies of
the JAX package's pure-Python host logic.
"""
from .engine import PagedServingEngine
from .faults import FAULT_KINDS, FaultInjector, FaultSpec, chaos_specs
from .kv_cache import (
    SENTINEL_PAGE,
    PageAllocator,
    append_kv_,
    gather_pages,
    make_page_pool,
    write_prompt_pages_,
)
from .resilience import (
    FINISH_REASONS,
    POLICIES,
    PagePoolExhausted,
    RequestRejected,
    RetryPolicy,
    ServingError,
    SimulatedKernelFailure,
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
    "make_page_pool",
    "write_prompt_pages_",
    "FINISH_REASONS",
    "POLICIES",
    "FAULT_KINDS",
    "FaultInjector",
    "FaultSpec",
    "chaos_specs",
    "PagePoolExhausted",
    "RequestRejected",
    "RetryPolicy",
    "ServingError",
    "SimulatedKernelFailure",
    "StepRetriesExhausted",
    "UnsupportedCacheError",
]
