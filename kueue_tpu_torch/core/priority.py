"""Workload priority resolution (reference: pkg/util/priority/priority.go).

Priority order of sources: explicit spec.priority (populated by the
webhook/defaulter from WorkloadPriorityClass > pod PriorityClass), else 0.
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api import kueue as api


def priority(wl: api.Workload) -> int:
    if wl.spec.priority is not None:
        return wl.spec.priority
    return 0


def priority_from_classes(
    pod_priority_class: str,
    workload_priority_class: str,
    workload_priority_classes: dict,
    priority_classes: dict,
) -> tuple[str, str, int]:
    """Resolve (class_source, class_name, value): WorkloadPriorityClass wins
    over pod PriorityClass (reference: jobframework/reconciler.go:879-962).
    """
    if workload_priority_class:
        wpc: Optional[api.WorkloadPriorityClass] = workload_priority_classes.get(workload_priority_class)
        if wpc is not None:
            return api.WORKLOAD_PRIORITY_CLASS_SOURCE, workload_priority_class, wpc.value
    if pod_priority_class:
        pc: Optional[api.PriorityClass] = priority_classes.get(pod_priority_class)
        if pc is not None:
            return api.POD_PRIORITY_CLASS_SOURCE, pod_priority_class, pc.value
    return "", "", 0
