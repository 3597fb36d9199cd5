"""The Cache: authoritative in-memory mirror of admitted usage.

Equivalent of the reference's pkg/cache/cache.go:89-595: tracks
ClusterQueues/cohorts/flavors/checks/local-queues plus assumed workloads
(optimistic admission before the API write), and produces deep-copied
Snapshots for lock-free scheduling cycles.

The port keeps the full-rebuild path only (the JAX package's
Cache(incremental_snapshots=False)): no usage journal, no incremental
snapshot maintainer, no handout recycling, no remote-cluster columns.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import is_condition_true
from kueue_tpu_torch.cache.clusterqueue import (
    TERMINATING,
    ClusterQueueCache,
    CohortCache,
    LocalQueueUsage,
    build_quotas,
    update_cohort_resource_node,
)
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot, CohortSnapshot, Snapshot
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.hierarchy import Manager as HierarchyManager


@dataclass
class AdmissionCheckEntry:
    controller_name: str = ""
    active: bool = False
    single_instance_in_cluster_queue: bool = False


class Cache:
    def __init__(self, pods_ready_tracking: bool = False,
                 excluded_resource_prefixes: Optional[list] = None):
        self._lock = threading.RLock()
        self._pods_ready_cond = threading.Condition(self._lock)
        self.hm: HierarchyManager = HierarchyManager(cohort_factory=self._new_cohort)
        self.resource_flavors: dict = {}  # name -> ResourceFlavor
        self.admission_checks: dict = {}  # name -> AdmissionCheckEntry
        self.assumed_workloads: dict = {}  # wl key -> cq name
        self.pods_ready_tracking = pods_ready_tracking
        self.excluded_resource_prefixes = excluded_resource_prefixes or []
        # Bumped on cohort-object changes (re-parent, cohort quotas):
        # structural edits invisible to per-CQ generations.
        self.cohort_epoch = 0
        # Monotonic capacity version: bumped on ANY capacity-affecting
        # change (CQ/cohort/flavor edits, workload removal). Snapshot
        # cohorts carry it as their allocatable generation so stored
        # flavor-resume state is invalidated by a simple `>` check — a
        # per-tree sum would shrink when a tree loses members and stall
        # invalidation forever.
        self._capacity_version = 0
        # Bumped on ResourceFlavor spec changes (taints / node labels):
        # they alter flavor eligibility without touching any CQ quota
        # generation, so topology-derived caches key on this too.
        self.flavor_spec_epoch = 0
        # Bumped on any change to the encoded solver TOPOLOGY (CQ set /
        # quotas / cohort tree / flavors / activity) — deliberately NOT on
        # workload add/remove, which only moves usage. The solver keys its
        # topology tensors on this instead of per-CQ allocatable
        # generations (those bump on every workload deletion purely to
        # invalidate flavor-resume state).
        self.topology_epoch = 0

    def _new_cohort(self, name: str) -> CohortCache:
        cohort = CohortCache(name)
        cohort.manager = self.hm
        return cohort

    # --- ClusterQueues ---

    def add_cluster_queue(self, cq: api.ClusterQueue) -> ClusterQueueCache:
        with self._lock:
            self._capacity_version += 1
            self.topology_epoch += 1
            cqc = ClusterQueueCache(cq)
            self.hm.add_cluster_queue(cqc.name, cqc)
            self.hm.update_cluster_queue_edge(cqc.name, cq.spec.cohort)
            self._wire_cohort(cqc)
            cqc.update_with_flavors(self.resource_flavors)
            cqc.update_with_checks(self.admission_checks)
            self._refresh_cohort(cqc)
            return cqc

    @staticmethod
    def _topo_signature(cqc) -> tuple:
        """The CQ fields the solver topology encodes: changes here (and
        only here) invalidate the encoded tensors. Reconcilers re-push
        ClusterQueues on every STATUS write; bumping the epoch on those
        would rebuild the topology (and drop device-resident solver
        state) every admission cycle."""
        return (cqc.cohort_name,
                tuple((tuple(sorted(rg.covered_resources)), tuple(rg.flavors))
                      for rg in cqc.resource_groups),
                tuple(sorted(cqc.resource_node.quotas.items())),
                cqc.fair_weight,
                cqc.flavor_fungibility.when_can_borrow,
                cqc.active,
                tuple(sorted((k, tuple(sorted(v)))
                             for k, v in cqc.admission_checks.items())))

    def update_cluster_queue(self, cq: api.ClusterQueue) -> None:
        with self._lock:
            self._capacity_version += 1
            cqc = self.hm.cluster_queues.get(cq.metadata.name)
            if cqc is None:
                return
            old_sig = self._topo_signature(cqc)
            old_cohort = cqc.cohort
            cqc.update(cq)
            self.hm.update_cluster_queue_edge(cqc.name, cq.spec.cohort)
            self._wire_cohort(cqc)
            cqc.update_with_flavors(self.resource_flavors)
            cqc.update_with_checks(self.admission_checks)
            if old_cohort is not None and old_cohort is not cqc.cohort:
                update_cohort_resource_node(old_cohort)
            self._refresh_cohort(cqc)
            if self._topo_signature(cqc) != old_sig:
                self.topology_epoch += 1

    def terminate_cluster_queue(self, name: str) -> None:
        """Stop admissions while keeping the usage accounting alive until
        the last reserving workload finishes (reference:
        cache.TerminateClusterQueue, cache.go:~300)."""
        with self._lock:
            cqc = self.hm.cluster_queues.get(name)
            if cqc is not None:
                cqc.status = TERMINATING
                self.topology_epoch += 1

    def delete_cluster_queue(self, name: str) -> None:
        with self._lock:
            self._capacity_version += 1
            self.topology_epoch += 1
            cqc = self.hm.cluster_queues.get(name)
            if cqc is None:
                return
            cqc.status = TERMINATING
            old_cohort = cqc.cohort
            self.hm.delete_cluster_queue(name)
            if old_cohort is not None:
                update_cohort_resource_node(old_cohort)

    def cluster_queue(self, name: str) -> Optional[ClusterQueueCache]:
        return self.hm.cluster_queues.get(name)

    def cluster_queue_active(self, name: str) -> bool:
        cqc = self.hm.cluster_queues.get(name)
        return cqc is not None and cqc.active

    def _wire_cohort(self, cqc: ClusterQueueCache) -> None:
        node = self.hm.cohort_of(cqc.name)
        cqc.cohort = node.payload if node else None

    def _refresh_cohort(self, cqc: ClusterQueueCache) -> None:
        if cqc.cohort is not None:
            update_cohort_resource_node(cqc.cohort)

    # --- Cohorts (explicit v1alpha1 objects with quotas) ---

    def add_or_update_cohort(self, cohort: api.Cohort) -> None:
        """Raises ValueError on a cycle-inducing parent edge; the quota
        update still lands and both trees stay consistent."""
        with self._lock:
            existing = self.hm.cohorts.get(cohort.metadata.name)
            if existing is not None:
                # No-op re-push guard (reconcilers re-deliver on status
                # writes): same parent + quotas -> keep the epochs, or
                # every resync would drop the solver topology + device
                # residency.
                parent = (existing.parent.name
                          if existing.parent is not None else "")
                if parent == (cohort.spec.parent or "") \
                        and existing.payload.resource_node.quotas \
                        == build_quotas(cohort.spec.resource_groups):
                    return
            self.cohort_epoch += 1
            self._capacity_version += 1
            self.topology_epoch += 1
            node = self.hm.add_cohort(cohort.metadata.name)
            node.payload.resource_node.quotas = build_quotas(cohort.spec.resource_groups)
            old_root = node.payload.root()
            try:
                self.hm.update_cohort_edge(cohort.metadata.name,
                                           cohort.spec.parent or "")
            finally:
                # A re-parent detaches this subtree: refresh the old tree
                # too (and always re-aggregate the quota edit above, even
                # when the edge update raises on a cycle).
                if old_root.name != node.payload.root().name:
                    update_cohort_resource_node(old_root)
                update_cohort_resource_node(node.payload)

    def delete_cohort(self, name: str) -> None:
        with self._lock:
            self.cohort_epoch += 1
            self._capacity_version += 1
            self.topology_epoch += 1
            node = self.hm.cohorts.get(name)
            if node is None:
                return
            payload = node.payload
            payload.resource_node.quotas = {}
            old_root = payload.root()
            self.hm.delete_cohort(name)
            if old_root is not payload:
                update_cohort_resource_node(old_root)
            if name in self.hm.cohorts:  # still referenced by CQs/children
                update_cohort_resource_node(payload)

    # --- flavors & checks ---

    def add_or_update_resource_flavor(self, rf: api.ResourceFlavor) -> set:
        with self._lock:
            old = self.resource_flavors.get(rf.metadata.name)
            self.resource_flavors[rf.metadata.name] = rf
            if old is not None and old.spec == rf.spec:
                # No-op re-push (reconcilers re-deliver on status/metadata
                # writes): eligibility didn't change, keep the epochs —
                # bumping them drops solver topology + device residency.
                return set()
            return self._refresh_flavor_dependents()

    def delete_resource_flavor(self, name: str) -> set:
        with self._lock:
            self.resource_flavors.pop(name, None)
            return self._refresh_flavor_dependents()

    def _refresh_flavor_dependents(self) -> set:
        self._capacity_version += 1
        self.flavor_spec_epoch += 1
        self.topology_epoch += 1
        affected = set()
        for cqc in self.hm.cluster_queues.values():
            was = cqc.active
            cqc.update_with_flavors(self.resource_flavors)
            if cqc.active != was:
                affected.add(cqc.name)
        return affected

    def add_or_update_admission_check(self, ac: api.AdmissionCheck) -> set:
        with self._lock:
            entry = AdmissionCheckEntry(
                controller_name=ac.spec.controller_name,
                active=is_condition_true(ac.status.conditions, api.ADMISSION_CHECK_ACTIVE))
            if self.admission_checks.get(ac.metadata.name) == entry:
                # No-op re-push: CQ activity can't change, keep the epoch.
                return set()
            self.admission_checks[ac.metadata.name] = entry
            return self._refresh_check_dependents()

    def delete_admission_check(self, name: str) -> set:
        with self._lock:
            self.admission_checks.pop(name, None)
            return self._refresh_check_dependents()

    def _refresh_check_dependents(self) -> set:
        self.topology_epoch += 1
        affected = set()
        for cqc in self.hm.cluster_queues.values():
            was = cqc.active
            cqc.update_with_checks(self.admission_checks)
            if cqc.active != was:
                affected.add(cqc.name)
        return affected

    # --- local queues ---

    def add_local_queue(self, lq: api.LocalQueue) -> None:
        with self._lock:
            cqc = self.hm.cluster_queues.get(lq.spec.cluster_queue)
            if cqc is None:
                return
            key = f"{lq.metadata.namespace}/{lq.metadata.name}"
            usage = LocalQueueUsage()
            # Rebuild usage from workloads already in the CQ (reference:
            # clusterqueue.go:440-448).
            for info in cqc.workloads.values():
                if wlpkg.queue_key(info.obj) != key:
                    continue
                for fr, q in info.flavor_resource_usage().items():
                    usage.usage[fr] = usage.usage.get(fr, 0) + q
                    if wlpkg.is_admitted(info.obj):
                        usage.admitted_usage[fr] = usage.admitted_usage.get(fr, 0) + q
                usage.reserving_workloads += 1
                if wlpkg.is_admitted(info.obj):
                    usage.admitted_workloads += 1
            cqc.local_queues[key] = usage

    def delete_local_queue(self, lq: api.LocalQueue) -> None:
        with self._lock:
            cqc = self.hm.cluster_queues.get(lq.spec.cluster_queue)
            if cqc is not None:
                cqc.local_queues.pop(f"{lq.metadata.namespace}/{lq.metadata.name}", None)

    def local_queue_usage(self, lq: api.LocalQueue) -> Optional[LocalQueueUsage]:
        cqc = self.hm.cluster_queues.get(lq.spec.cluster_queue)
        if cqc is None:
            return None
        return cqc.local_queues.get(f"{lq.metadata.namespace}/{lq.metadata.name}")

    # --- workloads (reference: cache.go:390-595) ---

    def add_or_update_workload(self, wl: api.Workload) -> bool:
        with self._lock:
            self._delete_workload_locked(wl)
            if wl.status.admission is None:
                return False
            cqc = self.hm.cluster_queues.get(wl.status.admission.cluster_queue)
            if cqc is None:
                return False
            info = self._new_info(wl)
            cqc.add_workload(info)
            not_ready = (self.pods_ready_tracking and not is_condition_true(
                wl.status.conditions, api.WORKLOAD_PODS_READY))
            if not_ready:
                cqc.workloads_not_ready.add(info.key)
            self._pods_ready_cond.notify_all()
            return True

    def delete_workload(self, wl: api.Workload) -> bool:
        with self._lock:
            deleted = self._delete_workload_locked(wl)
            self._pods_ready_cond.notify_all()
            return deleted

    def _delete_workload_locked(self, wl: api.Workload) -> bool:
        key = wlpkg.key(wl)
        cq_name = self.assumed_workloads.pop(key, None)
        if cq_name is None and wl.status.admission is not None:
            cq_name = wl.status.admission.cluster_queue
        if cq_name is None:
            # The admission may already be cleared on the object (eviction
            # completed); fall back to membership lookup by key.
            for candidate in self.hm.cluster_queues.values():
                if key in candidate.workloads:
                    cq_name = candidate.name
                    break
        if cq_name is None:
            return False
        cqc = self.hm.cluster_queues.get(cq_name)
        if cqc is None:
            return False
        info = cqc.workloads.get(key)
        if info is None:
            return False
        cqc.delete_workload(info)
        cqc.workloads_not_ready.discard(key)
        self._capacity_version += 1  # freed capacity invalidates resume state
        return True

    def assume_workload(self, wl: api.Workload,
                        info: Optional[wlpkg.Info] = None) -> None:
        """Optimistically account for a workload before the API write
        (reference: cache.go:546). `info` (optional) skips re-parsing the
        admission when the caller just built it (scheduler admit path)."""
        with self._lock:
            key = wlpkg.key(wl)
            if key in self.assumed_workloads:
                raise KeyError(f"workload {key} already assumed")
            if wl.status.admission is None:
                raise ValueError("cannot assume workload without admission")
            cqc = self.hm.cluster_queues.get(wl.status.admission.cluster_queue)
            if cqc is None:
                raise KeyError(f"cluster queue {wl.status.admission.cluster_queue} not found")
            if info is None or info.obj is not wl:
                info = self._new_info(wl)
            cqc.add_workload(info)
            not_ready = (self.pods_ready_tracking and not is_condition_true(
                wl.status.conditions, api.WORKLOAD_PODS_READY))
            if not_ready:
                cqc.workloads_not_ready.add(key)
            self.assumed_workloads[key] = cqc.name

    def forget_workload(self, wl: api.Workload) -> None:
        with self._lock:
            key = wlpkg.key(wl)
            if key not in self.assumed_workloads:
                raise KeyError(f"workload {key} not assumed")
            self._delete_workload_locked(wl)
            self._pods_ready_cond.notify_all()

    def is_assumed_or_admitted(self, info: wlpkg.Info) -> bool:
        with self._lock:
            key = info.key
            if key in self.assumed_workloads:
                return True
            cqc = self.hm.cluster_queues.get(info.cluster_queue)
            return cqc is not None and key in cqc.workloads

    def _new_info(self, wl: api.Workload) -> wlpkg.Info:
        return wlpkg.Info(wl, excluded_resource_prefixes=self.excluded_resource_prefixes)

    # --- PodsReady gating (reference: cache.go:145-192) ---

    def pods_ready_for_all_admitted_workloads(self) -> bool:
        with self._lock:
            if not self.pods_ready_tracking:
                return True
            return all(not cqc.workloads_not_ready
                       for cqc in self.hm.cluster_queues.values())

    def mark_workload_pods_ready(self, wl: api.Workload) -> None:
        with self._lock:
            key = wlpkg.key(wl)
            for cqc in self.hm.cluster_queues.values():
                if key in cqc.workloads_not_ready:
                    cqc.workloads_not_ready.discard(key)
            self._pods_ready_cond.notify_all()

    def wait_for_pods_ready(self, timeout: Optional[float] = None) -> bool:
        with self._pods_ready_cond:
            return self._pods_ready_cond.wait_for(
                lambda: all(not c.workloads_not_ready
                            for c in self.hm.cluster_queues.values()),
                timeout=timeout)

    # --- snapshot (reference: snapshot.go:79-142) ---

    def snapshot(self) -> Snapshot:
        """A full deep-cloned snapshot (the JAX package's
        incremental_snapshots=False path)."""
        with self._lock:
            return self._build_snapshot()

    def _build_snapshot(self) -> Snapshot:
        """From-scratch snapshot construction: a deep clone of every
        active CQ's trees and of every cohort's resource node."""
        with self._lock:
            snap = Snapshot()
            for name, cqc in self.hm.cluster_queues.items():
                if not cqc.active:
                    snap.inactive_cluster_queue_sets.add(name)
                    continue
                snap.cluster_queues[name] = ClusterQueueSnapshot(cqc)
            snap.resource_flavors = dict(self.resource_flavors)
            cohort_snaps: dict = {}
            for cname, node in self.hm.cohorts.items():
                cohort_snap = CohortSnapshot(
                    cname, node.payload.resource_node.clone())
                # The monotonic capacity version: any capacity change
                # anywhere (including in sibling subtrees of a tree)
                # invalidates stored flavor-resume state via a `>` check.
                cohort_snap.allocatable_resource_generation = self._capacity_version
                cohort_snaps[cname] = cohort_snap
                for cqc in node.child_cqs.values():
                    if cqc.name in snap.cluster_queues:
                        cq_snap = snap.cluster_queues[cqc.name]
                        cq_snap.cohort = cohort_snap
                        cohort_snap.members.add(cq_snap)
            # Wire the cohort tree (hierarchical v1alpha1 cohorts).
            for cname, node in self.hm.cohorts.items():
                if node.parent is not None:
                    parent_snap = cohort_snaps[node.parent.name]
                    cohort_snaps[cname].parent = parent_snap
                    parent_snap.child_cohorts.add(cohort_snaps[cname])
            snap.cohort_epoch = self.cohort_epoch
            snap.flavor_spec_epoch = self.flavor_spec_epoch
            snap.topology_epoch = self.topology_epoch
            return snap

    # --- usage reporting (status/metrics) ---

    def usage_for_cluster_queue(self, name: str) -> tuple:
        """(reservation usage, admitted usage) as FlavorResource dicts."""
        with self._lock:
            cqc = self.hm.cluster_queues.get(name)
            if cqc is None:
                return {}, {}
            return dict(cqc.resource_node.usage), dict(cqc.admitted_usage)
