"""Namespace LimitRange summaries and validation.

Equivalent of the reference's pkg/util/limitrange: Summarize merges all
LimitRanges in a namespace; ValidatePodSpec checks min/max constraints
(used by the scheduler's nominate step, scheduler.go:542-566). The
defaulting of the JAX package's copy (apply_defaults, the webhook's)
has no caller in the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kueue_tpu_torch.api.corev1 import PodSpec, ResourceList
from kueue_tpu_torch.core.resources import pod_effective_requests

LIMIT_TYPE_POD = "Pod"
LIMIT_TYPE_CONTAINER = "Container"


@dataclass
class LimitRangeItem:
    type: str = LIMIT_TYPE_CONTAINER
    max: ResourceList = field(default_factory=dict)
    min: ResourceList = field(default_factory=dict)
    default: ResourceList = field(default_factory=dict)
    default_request: ResourceList = field(default_factory=dict)


@dataclass
class LimitRange:
    namespace: str = ""
    name: str = ""
    limits: list = field(default_factory=list)  # list[LimitRangeItem]
    # populated lazily so the object can live in the sim store
    metadata: object = None

    def __post_init__(self):
        if self.metadata is None:
            from kueue_tpu_torch.api.meta import ObjectMeta
            self.metadata = ObjectMeta(name=self.name, namespace=self.namespace)


@dataclass
class Summary:
    """Merged constraints per limit type."""
    items: dict = field(default_factory=dict)  # type -> LimitRangeItem


def summarize(*ranges: LimitRange) -> Summary:
    summary = Summary()
    for lr in ranges:
        for item in lr.limits:
            merged = summary.items.setdefault(item.type, LimitRangeItem(type=item.type))
            # min: keep the largest lower bound; max: keep the smallest upper bound
            for res, v in item.min.items():
                merged.min[res] = max(merged.min.get(res, v), v)
            for res, v in item.max.items():
                merged.max[res] = min(merged.max.get(res, v), v)
            # defaults: first writer wins (matching the reference's merge)
            for res, v in item.default.items():
                merged.default.setdefault(res, v)
            for res, v in item.default_request.items():
                merged.default_request.setdefault(res, v)
    return summary


def validate_pod_spec(spec: PodSpec, summary: Summary, path: str = "") -> list:
    """Return human-readable constraint violations
    (reference: limitrange ValidatePodSpec)."""
    reasons = []
    citem = summary.items.get(LIMIT_TYPE_CONTAINER)
    if citem is not None:
        for c in list(spec.containers) + list(spec.init_containers):
            for res, v in c.requests.items():
                if res in citem.min and v < citem.min[res]:
                    reasons.append(f"{path}: container {c.name} requests {res} below LimitRange min")
                if res in citem.max and v > citem.max[res]:
                    reasons.append(f"{path}: container {c.name} requests {res} above LimitRange max")
    pitem = summary.items.get(LIMIT_TYPE_POD)
    if pitem is not None:
        total = pod_effective_requests(spec)
        for res, v in total.items():
            if res in pitem.min and v < pitem.min[res]:
                reasons.append(f"{path}: pod requests {res} below LimitRange min")
            if res in pitem.max and v > pitem.max[res]:
                reasons.append(f"{path}: pod requests {res} above LimitRange max")
    return reasons
