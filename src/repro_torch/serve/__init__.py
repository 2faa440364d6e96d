"""Serving, ported from ``src/repro/serve``: DLS continuous batching, the
decode engine, two-level cluster routing, elastic resizing and the
resilience layer."""

from .cluster import (  # noqa: F401
    ClusterConfig,
    ClusterEvent,
    ClusterRecord,
    ClusterRouter,
    ReplicaKill,
    ReplicaRecover,
    ReplicaSpeed,
    ScaleTo,
    TwoLevelSpec,
    cluster_grid,
    make_traffic,
    simulate_cluster,
    simulate_cluster_batch,
)
from .elastic import (  # noqa: F401
    elastic_handoff,
    neutralize_worker_state,
    resize_scheduler,
)
from .engine import DecodeEngine, EngineStats  # noqa: F401
from .resilience import (  # noqa: F401
    HealthTracker,
    ReclaimGrant,
    ResilienceConfig,
    simulate_cluster_resilient,
)
from .scheduler import Request, RequestScheduler, simulate_serving  # noqa: F401
