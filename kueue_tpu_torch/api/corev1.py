"""Subset of k8s core/v1 pod types that the reference framework consumes.

The scheduler never runs pods; it only needs requests/limits, node
selectors/affinity, tolerations and scheduling gates — the inputs of
flavor assignment (reference: pkg/scheduler/flavorassigner) and the
fields the job integrations inject/restore (reference: pkg/podset).

Resource quantities are represented canonically as integers:
- "cpu": milli-CPU (reference: resources.Requests uses MilliValue for cpu,
  reference: pkg/resources/requests.go:69)
- everything else: raw scalar value (bytes for memory, count for pods/GPUs).
Strings like "500m" / "2Gi" are accepted and parsed by `parse_quantity`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"

_SUFFIXES = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}


def parse_quantity(value: Union[str, int, float], resource: str = "") -> int:
    """Parse a k8s-style quantity into the canonical integer unit.

    For cpu the canonical unit is milli ("1" -> 1000, "500m" -> 500);
    for all other resources it is the scalar value ("2Gi" -> 2147483648).
    """
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        scalar = float(value)
        return round(scalar * 1000) if resource == RESOURCE_CPU else round(scalar)
    s = str(value).strip()
    if not s:
        return 0
    if s.endswith("m"):
        milli = float(s[:-1])
        if resource == RESOURCE_CPU:
            return round(milli)
        return round(milli / 1000)
    for suffix, mult in sorted(_SUFFIXES.items(), key=lambda kv: -len(kv[0])):
        if s.endswith(suffix):
            scalar = float(s[: -len(suffix)]) * mult
            return round(scalar * 1000) if resource == RESOURCE_CPU else round(scalar)
    scalar = float(s)
    return round(scalar * 1000) if resource == RESOURCE_CPU else round(scalar)


def format_quantity(value: int, resource: str) -> str:
    if resource == RESOURCE_CPU:
        if value % 1000 == 0:
            return str(value // 1000)
        return f"{value}m"
    return str(value)


ResourceList = dict[str, int]  # resource name -> canonical integer quantity


def parse_resource_list(raw: dict[str, Union[str, int, float]]) -> ResourceList:
    return {name: parse_quantity(v, name) for name, v in raw.items()}


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


def find_untolerated_taint(taints: list[Taint], tolerations: list[Toleration]) -> Optional[Taint]:
    """FindMatchingUntoleratedTaint over NoSchedule/NoExecute taints
    (reference: flavorassigner.go:440-445)."""
    for taint in taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(tol.tolerates(taint) for tol in tolerations):
            return taint
    return None


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: list[str] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        val = labels.get(self.key)
        if self.operator == "In":
            return val is not None and val in self.values
        if self.operator == "NotIn":
            return val is None or val not in self.values
        if self.operator == "Exists":
            return self.key in labels
        if self.operator == "DoesNotExist":
            return self.key not in labels
        if self.operator == "Gt":
            return val is not None and val.lstrip("-").isdigit() and int(val) > int(self.values[0])
        if self.operator == "Lt":
            return val is not None and val.lstrip("-").isdigit() and int(val) < int(self.values[0])
        raise ValueError(f"unknown node selector operator {self.operator}")


@dataclass
class NodeSelectorTerm:
    match_expressions: list[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        return all(e.matches(labels) for e in self.match_expressions)


@dataclass
class NodeSelector:
    # Terms are ORed.
    node_selector_terms: list[NodeSelectorTerm] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        if not self.node_selector_terms:
            return True
        return any(t.matches(labels) for t in self.node_selector_terms)


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None


@dataclass
class Container:
    name: str = ""
    requests: ResourceList = field(default_factory=dict)
    limits: ResourceList = field(default_factory=dict)


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[Toleration] = field(default_factory=list)
    affinity: Optional[Affinity] = None
    priority_class_name: str = ""
    priority: Optional[int] = None
    scheduling_gates: list[str] = field(default_factory=list)
    restart_policy: str = "Never"
    overhead: ResourceList = field(default_factory=dict)


@dataclass
class PodTemplateSpec:
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    spec: PodSpec = field(default_factory=PodSpec)


POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    conditions: list = field(default_factory=list)


@dataclass
class Pod:
    """corev1.Pod — enough for the plain-pod integration
    (reference: pkg/controller/jobs/pod)."""
    metadata: "ObjectMeta" = None
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"

    def __post_init__(self):
        if self.metadata is None:
            from kueue_tpu_torch.api.meta import ObjectMeta
            self.metadata = ObjectMeta()


@dataclass
class Namespace:
    """corev1.Namespace — only labels matter (CQ namespaceSelector,
    reference: scheduler.go:421-425)."""
    metadata: "ObjectMeta" = None

    KIND = "Namespace"

    def __post_init__(self):
        if self.metadata is None:
            from kueue_tpu_torch.api.meta import ObjectMeta
            self.metadata = ObjectMeta()
