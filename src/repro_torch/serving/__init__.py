"""Serving subsystem: async micro-batched GNN inference over a shared
multi-graph plan cache.

    queue ──► density sketch ──► SharedPlanCache ──► batched dispatch

See ``repro_torch.serving.engine`` for the request path (including the
degraded-mode ladder: compiled → eager → bisected per-request retry →
quarantine), ``repro_torch.serving.cache`` for the process-wide cache +
persistence, and ``repro_torch.serving.faults`` for the seeded chaos
injector.
"""
from repro_torch.serving.cache import (GraphKey, SharedPlanCache,
                                       get_shared_cache, set_shared_cache)
from repro_torch.serving.engine import (RequestStats, ServingConfig,
                                        ServingEngine, ServingStats,
                                        batched_mm, stacked_transport)
from repro_torch.serving.faults import (DeadlineExceeded, FaultInjector,
                                        InjectedFault)
from repro_torch.serving.sketch import SketchConfig

__all__ = [
    "GraphKey", "SharedPlanCache", "get_shared_cache", "set_shared_cache",
    "RequestStats", "ServingConfig", "ServingEngine", "ServingStats",
    "batched_mm", "stacked_transport", "SketchConfig",
    "DeadlineExceeded", "FaultInjector", "InjectedFault",
]
