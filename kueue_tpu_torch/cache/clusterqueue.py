"""Cache-side ClusterQueue and Cohort internals.

Equivalent of the reference's pkg/cache/clusterqueue.go + cohort.go:
spec ingestion into ResourceNode quotas, usage accounting for
admitted/assumed workloads, activity status, allocatable-resource
generation, per-LocalQueue usage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch import features
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.cache import resource_node as rnode
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.resources import FlavorResource

# ClusterQueue status (reference: pkg/metrics ClusterQueueStatus)
PENDING = "pending"
ACTIVE = "active"
TERMINATING = "terminating"


@dataclass
class ResourceGroupInfo:
    covered_resources: set = field(default_factory=set)
    flavors: list = field(default_factory=list)  # ordered flavor names
    label_keys: set = field(default_factory=set)  # node-label keys across flavors

    def clone(self) -> "ResourceGroupInfo":
        return ResourceGroupInfo(covered_resources=set(self.covered_resources),
                                 flavors=list(self.flavors),
                                 label_keys=set(self.label_keys))


def build_quotas(spec_groups: list) -> dict:
    """Flatten API resource groups into FlavorResource -> ResourceQuota,
    honoring the LendingLimit feature gate."""
    quotas: dict = {}
    lending_enabled = features.enabled(features.LENDING_LIMIT)
    for rg in spec_groups:
        for fq in rg.flavors:
            for rq in fq.resources:
                quotas[FlavorResource(fq.name, rq.name)] = rnode.ResourceQuota(
                    nominal=rq.nominal_quota,
                    borrowing_limit=rq.borrowing_limit,
                    lending_limit=rq.lending_limit if lending_enabled else None,
                )
    return quotas


class CohortCache:
    """Cache-side cohort node (reference: pkg/cache/cohort.go). Supports
    arbitrary-depth trees via the v1alpha1 Cohort parent edge
    (cohort_types.go:26-100); quota math walks the chain
    (resource_node.go:89-146)."""

    def __init__(self, name: str):
        self.name = name
        self.resource_node = rnode.ResourceNode()
        self.manager = None  # set by Cache

    def _node(self):
        return self.manager.cohorts.get(self.name) if self.manager else None

    def parent_node(self) -> Optional["CohortCache"]:
        node = self._node()
        if node is None or node.parent is None:
            return None
        return node.parent.payload

    def root(self) -> "CohortCache":
        c = self
        while (p := c.parent_node()) is not None:
            c = p
        return c

    def child_cqs(self) -> list:
        node = self._node()
        return list(node.child_cqs.values()) if node else []

    def child_cohorts(self) -> list:
        node = self._node()
        return [n.payload for n in node.child_cohorts.values()] if node else []


class ClusterQueueCache:
    """Cache-side ClusterQueue (reference: pkg/cache/clusterqueue.go)."""

    def __init__(self, cq: api.ClusterQueue):
        self.name = cq.metadata.name
        self.resource_node = rnode.ResourceNode()
        self.workloads: dict = {}  # key -> Info
        self.workloads_not_ready: set = set()
        self.admitted_usage: dict = {}  # FlavorResource -> int (Admitted=True only)
        self.admitted_workloads_count = 0
        # monotonic: bumped on every usage-moving mutation (cheap status
        # change-detection for the CQ/LQ reconcilers at scale)
        self.usage_version = 0
        self.allocatable_resource_generation = 0
        self.cohort: Optional[CohortCache] = None
        self.missing_flavors: list = []
        self.missing_checks: list = []
        self.inactive_checks: list = []
        self.multiple_single_instance_controller_checks = False
        self.local_queues: dict = {}  # "ns/name" -> LocalQueueUsage
        self.update(cq)

    def update(self, cq: api.ClusterQueue) -> None:
        spec = cq.spec
        self.spec = spec
        self.cohort_name = spec.cohort
        self.queueing_strategy = spec.queueing_strategy
        self.namespace_selector = spec.namespace_selector
        self.preemption = spec.preemption
        self.flavor_fungibility = spec.flavor_fungibility
        self.fair_weight = spec.fair_sharing.weight if spec.fair_sharing else 1000
        self.stop_policy = spec.stop_policy
        self.admission_checks = admission_checks_map(spec)
        self.resource_groups = []
        for rg in spec.resource_groups:
            info = ResourceGroupInfo(covered_resources=set(rg.covered_resources),
                                     flavors=[fq.name for fq in rg.flavors])
            self.resource_groups.append(info)
        new_quotas = build_quotas(spec.resource_groups)
        if new_quotas != self.resource_node.quotas:
            self.allocatable_resource_generation += 1
        self.resource_node.quotas = new_quotas
        update_cluster_queue_resource_node(self)

    # --- hierarchicalResourceNode protocol ---

    def parent_node(self) -> Optional[CohortCache]:
        return self.cohort

    # --- flavor/check availability (activity gating) ---

    def update_with_flavors(self, flavors: dict) -> None:
        self.missing_flavors = [
            f for rg in self.resource_groups for f in rg.flavors if f not in flavors]
        for rg in self.resource_groups:
            rg.label_keys = set()
            for f in rg.flavors:
                rf = flavors.get(f)
                if rf is not None:
                    rg.label_keys.update(rf.spec.node_labels.keys())

    def update_with_checks(self, checks: dict) -> None:
        """checks: name -> AdmissionCheck cache entry with .active flag."""
        self.missing_checks = []
        self.inactive_checks = []
        for name in self.admission_checks:
            entry = checks.get(name)
            if entry is None:
                self.missing_checks.append(name)
            elif not entry.active:
                self.inactive_checks.append(name)

    @property
    def active(self) -> bool:
        return (self.status != TERMINATING
                and self.stop_policy == api.STOP_POLICY_NONE
                and not self.missing_flavors
                and not self.missing_checks
                and not self.inactive_checks)

    status = ACTIVE  # overridden to TERMINATING by Cache on delete

    def inactive_reason(self) -> str:
        if self.stop_policy != api.STOP_POLICY_NONE:
            return "Stopped"
        if self.missing_flavors:
            return f"FlavorNotFound: {', '.join(self.missing_flavors)}"
        if self.missing_checks:
            return f"CheckNotFoundOrInactive: {', '.join(self.missing_checks)}"
        if self.inactive_checks:
            return f"CheckNotFoundOrInactive: {', '.join(self.inactive_checks)}"
        return ""

    # --- usage accounting ---

    def add_workload(self, info: wlpkg.Info) -> None:
        self.workloads[info.key] = info
        self._update_usage(info, +1)

    def delete_workload(self, info: wlpkg.Info) -> None:
        if info.key not in self.workloads:
            return
        del self.workloads[info.key]
        self._update_usage(info, -1)
        # Freed capacity invalidates flavor-iteration resume state
        # (reference: cache.go deleteWorkload bumps the generation).
        self.allocatable_resource_generation += 1

    def _update_usage(self, info: wlpkg.Info, sign: int) -> None:
        self.usage_version += 1
        usage = info.flavor_resource_usage()
        for fr, q in usage.items():
            if sign > 0:
                rnode.add_usage(self, fr, q)
            else:
                rnode.remove_usage(self, fr, q)
        admitted = wlpkg.is_admitted(info.obj)
        if admitted:
            for fr, q in usage.items():
                self.admitted_usage[fr] = self.admitted_usage.get(fr, 0) + sign * q
            self.admitted_workloads_count += sign
        lq_key = wlpkg.queue_key(info.obj)
        lq = self.local_queues.get(lq_key)
        if lq is not None:
            lq.version += 1
            for fr, q in usage.items():
                lq.usage[fr] = lq.usage.get(fr, 0) + sign * q
                if admitted:
                    lq.admitted_usage[fr] = lq.admitted_usage.get(fr, 0) + sign * q
            lq.reserving_workloads += sign
            if admitted:
                lq.admitted_workloads += sign

    def reserving_workloads_count(self) -> int:
        return len(self.workloads)


@dataclass
class LocalQueueUsage:
    usage: dict = field(default_factory=dict)
    admitted_usage: dict = field(default_factory=dict)
    reserving_workloads: int = 0
    admitted_workloads: int = 0
    version: int = 0  # bumped on every mutation (change detection)


def admission_checks_map(spec: api.ClusterQueueSpec) -> dict:
    """Aggregate admissionChecks + admissionChecksStrategy into
    name -> set of flavors (empty set = all flavors)
    (reference: clusterqueue_snapshot.go:41-44)."""
    out: dict = {}
    for name in spec.admission_checks:
        out[name] = set()
    for rule in spec.admission_checks_strategy:
        out[rule.name] = set(rule.on_flavors)
    return out


def update_cluster_queue_resource_node(cq: ClusterQueueCache) -> None:
    """SubtreeQuota(CQ) = nominal quotas
    (reference: resource_node.go:156-161)."""
    cq.resource_node.subtree_quota = {
        fr: q.nominal for fr, q in cq.resource_node.quotas.items()}


def update_cohort_resource_node(cohort: CohortCache) -> None:
    """Recompute subtree quotas/usage for the whole tree containing
    `cohort` (reference: resource_node.go:163-179, extended recursively
    over child cohorts for hierarchical v1alpha1 cohorts)."""
    _update_cohort_subtree(cohort.root())


def _update_cohort_subtree(cohort: CohortCache) -> None:
    """Post-order: children's subtree quotas feed the parent; a child's
    lendable capacity is its subtree quota minus its guaranteed quota, and
    only over-guaranteed usage bubbles up."""
    rn = cohort.resource_node
    rn.subtree_quota = {fr: q.nominal for fr, q in rn.quotas.items()}
    rn.usage = {}

    def _fold(child_rn: rnode.ResourceNode) -> None:
        for fr, child_quota in child_rn.subtree_quota.items():
            rn.subtree_quota[fr] = (rn.subtree_quota.get(fr, 0)
                                    + child_quota - child_rn.guaranteed_quota(fr))
        for fr, child_usage in child_rn.usage.items():
            over = max(0, child_usage - child_rn.guaranteed_quota(fr))
            if over:
                rn.usage[fr] = rn.usage.get(fr, 0) + over

    for child in cohort.child_cohorts():
        _update_cohort_subtree(child)
        _fold(child.resource_node)
    for child in cohort.child_cqs():
        update_cluster_queue_resource_node(child)
        _fold(child.resource_node)
