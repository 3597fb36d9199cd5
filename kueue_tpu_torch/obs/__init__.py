"""Observability plane: the per-cycle flight recorder and the operator
debug surface it feeds (see kueue_tpu/obs/OBSERVABILITY.md).

The port's copy of kueue_tpu/obs/__init__.py.
"""

from kueue_tpu_torch.obs.recorder import (
    DEFAULT_CAPACITY,
    CycleTrace,
    FlightRecorder,
)
from kueue_tpu_torch.obs.journey import JourneyLedger, WorkloadJourney
from kueue_tpu_torch.obs.queryplane import QueryPlane, SealedView
from kueue_tpu_torch.obs.status import (
    DebugEndpoints,
    aging_status,
    arena_status,
    breaker_status,
    degrade_status,
    journey_status,
    pipeline_status,
    queryplane_status,
    recovery_status,
    router_status,
    shards_status,
    warmup_status,
)
from kueue_tpu_torch.obs.trend import AgingWatch, TrendMonitor

__all__ = [
    "DEFAULT_CAPACITY",
    "AgingWatch",
    "CycleTrace",
    "FlightRecorder",
    "JourneyLedger",
    "QueryPlane",
    "SealedView",
    "TrendMonitor",
    "WorkloadJourney",
    "DebugEndpoints",
    "aging_status",
    "arena_status",
    "breaker_status",
    "degrade_status",
    "journey_status",
    "pipeline_status",
    "queryplane_status",
    "recovery_status",
    "router_status",
    "shards_status",
    "warmup_status",
]
