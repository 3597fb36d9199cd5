"""PodSetInfo: node-selector/toleration/count injection & restore.

Equivalent of the reference's pkg/podset/podset.go:42-176:
- from_assignment: flavor assignment -> nodeLabels/tolerations to inject
- merge: apply the info into a job's pod template (conflict-checked)
- restore: undo the injection on suspend/requeue
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.corev1 import PodTemplateSpec, Toleration


class PermanentError(Exception):
    """Unrecoverable merge conflict (reference: podset.go:184 marker)."""


@dataclass
class PodSetInfo:
    name: str = ""
    count: int = 0
    annotations: dict = field(default_factory=dict)
    labels: dict = field(default_factory=dict)
    node_selector: dict = field(default_factory=dict)
    tolerations: list = field(default_factory=list)


def from_assignment(psa: api.PodSetAssignment, resource_flavors: dict,
                    default_count: int) -> PodSetInfo:
    """Build injection info from a PodSetAssignment
    (reference: podset.go:53)."""
    info = PodSetInfo(name=psa.name,
                      count=psa.count if psa.count is not None else default_count)
    seen_flavors = set()
    for flavor_name in psa.flavors.values():
        if flavor_name in seen_flavors:
            continue
        seen_flavors.add(flavor_name)
        flavor = resource_flavors.get(flavor_name)
        if flavor is None:
            raise PermanentError(f"flavor {flavor_name} not found")
        for k, v in flavor.spec.node_labels.items():
            if k in info.node_selector and info.node_selector[k] != v:
                raise PermanentError(f"conflicting node selector for key {k}")
            info.node_selector[k] = v
        info.tolerations.extend(flavor.spec.tolerations)
    return info


def from_update(update: api.PodSetUpdate) -> PodSetInfo:
    return PodSetInfo(name=update.name, labels=dict(update.labels),
                      annotations=dict(update.annotations),
                      node_selector=dict(update.node_selector),
                      tolerations=list(update.tolerations))


def merge(info: PodSetInfo, other: PodSetInfo) -> PodSetInfo:
    """Merge two infos, raising PermanentError on conflicts
    (reference: podset.go:136)."""
    out = PodSetInfo(name=info.name, count=info.count,
                     annotations=dict(info.annotations), labels=dict(info.labels),
                     node_selector=dict(info.node_selector),
                     tolerations=list(info.tolerations))
    for src, dst in ((other.annotations, out.annotations),
                     (other.labels, out.labels),
                     (other.node_selector, out.node_selector)):
        for k, v in src.items():
            if k in dst and dst[k] != v:
                raise PermanentError(f"conflict for key {k}")
            dst[k] = v
    for tol in other.tolerations:
        if tol not in out.tolerations:
            out.tolerations.append(tol)
    return out


def merge_into_template(template: PodTemplateSpec, info: PodSetInfo) -> None:
    """Inject into a pod template (reference: podset.Merge on PodSpec)."""
    for k, v in info.labels.items():
        if template.labels.get(k, v) != v:
            raise PermanentError(f"conflicting label {k}")
        template.labels[k] = v
    for k, v in info.annotations.items():
        if template.annotations.get(k, v) != v:
            raise PermanentError(f"conflicting annotation {k}")
        template.annotations[k] = v
    for k, v in info.node_selector.items():
        if template.spec.node_selector.get(k, v) != v:
            raise PermanentError(f"conflicting node selector {k}")
        template.spec.node_selector[k] = v
    for tol in info.tolerations:
        if tol not in template.spec.tolerations:
            template.spec.tolerations.append(tol)


def restore_template(template: PodTemplateSpec, original: PodSetInfo) -> bool:
    """Reset template to the recorded original (reference: RestorePodSpec).
    Returns True if anything changed."""
    changed = (template.labels != original.labels
               or template.annotations != original.annotations
               or template.spec.node_selector != original.node_selector
               or template.spec.tolerations != original.tolerations)
    template.labels = dict(original.labels)
    template.annotations = dict(original.annotations)
    template.spec.node_selector = dict(original.node_selector)
    template.spec.tolerations = list(original.tolerations)
    return changed


def snapshot_template(name: str, count: int, template: PodTemplateSpec) -> PodSetInfo:
    """Record the pre-injection state for later restore."""
    return PodSetInfo(name=name, count=count,
                      labels=dict(template.labels),
                      annotations=dict(template.annotations),
                      node_selector=dict(template.spec.node_selector),
                      tolerations=list(template.spec.tolerations))
