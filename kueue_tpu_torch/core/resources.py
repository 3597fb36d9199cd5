"""Integer resource arithmetic keyed by (flavor, resource).

Equivalent of the reference's pkg/resources (resource.go:1-30,
requests.go:69): quantities are canonical integers (milli for cpu, raw
scalar otherwise — see kueue_tpu_torch.api.corev1.parse_quantity).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

from kueue_tpu_torch.api.corev1 import Container, PodSpec, ResourceList


class FlavorResource(NamedTuple):
    flavor: str
    resource: str


# dict[FlavorResource, int]
FlavorResourceQuantities = dict

Requests = dict  # dict[str, int]: resource name -> quantity


def add_requests(a: ResourceList, b: ResourceList) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def max_requests(a: ResourceList, b: ResourceList) -> ResourceList:
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0), v)
    return out


def scale_requests(r: ResourceList, f: int) -> ResourceList:
    return {k: v * f for k, v in r.items()}


def pod_effective_requests(spec: PodSpec) -> ResourceList:
    """Effective per-pod requests: elementwise
    max(sum of containers, max of init containers) + overhead.

    Equivalent of limitrange.TotalRequests in the reference
    (used at pkg/workload/workload.go:316).
    """
    total: ResourceList = {}
    for c in spec.containers:
        total = add_requests(total, c.requests)
    init_max: ResourceList = {}
    for c in spec.init_containers:
        init_max = max_requests(init_max, c.requests)
    total = max_requests(total, init_max)
    return add_requests(total, spec.overhead)


def container_limits_violations(containers: Iterable[Container]) -> list[str]:
    """Resources whose requests exceed their limits (scheduler validation,
    reference scheduler.go:509-540)."""
    bad = []
    for c in containers:
        for res, req in c.requests.items():
            if res in c.limits and req > c.limits[res]:
                bad.append(res)
    return bad


def add_flavor_quantities(dst: FlavorResourceQuantities, src: FlavorResourceQuantities, sign: int = 1) -> None:
    for fr, q in src.items():
        dst[fr] = dst.get(fr, 0) + sign * q
