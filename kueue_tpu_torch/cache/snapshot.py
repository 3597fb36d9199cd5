"""Scheduling snapshot: deep copy of usage trees for lock-free cycles.

Equivalent of the reference's pkg/cache/snapshot.go:79-142 +
clusterqueue_snapshot.go + cohort_snapshot.go + the DRF share math
(clusterqueue.go:503-564); the port of kueue_tpu/cache/snapshot.py, with
its copy-on-write shells for the incremental maintainer
(cache/incremental.py) and its light (shared, read-only) snapshots.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.cache import resource_node as rnode
from kueue_tpu_torch.cache.clusterqueue import ClusterQueueCache, ResourceGroupInfo
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.resources import FlavorResource


class CohortSnapshot:
    # Copy-on-write flag (incremental snapshots, see incremental.py):
    # marks a handout shell sharing the maintainer's usage node until
    # first mutation. The class-level default keeps plain deep-clone
    # snapshots zero-cost; the maintainer tracks which of ITS containers
    # are shared with handouts on its own side (name sets, not flags).
    _shared = False

    def __init__(self, name: str, resource_node: rnode.ResourceNode):
        self.name = name
        self.resource_node = resource_node
        self.members: set = set()  # direct ClusterQueueSnapshot children
        self.child_cohorts: set = set()  # direct CohortSnapshot children
        self.parent: Optional["CohortSnapshot"] = None
        self.allocatable_resource_generation = 0

    def clone_shell(self) -> "CohortSnapshot":
        """Shallow copy-on-write view for an incremental-snapshot
        handout: shares the usage node until first mutation (the tree
        wiring — members/parent/child_cohorts — is rebuilt per handout
        so each snapshot's cohort graph is self-contained)."""
        shell = CohortSnapshot.__new__(CohortSnapshot)
        shell.name = self.name
        shell.resource_node = self.resource_node
        shell.members = set()
        shell.child_cohorts = set()
        shell.parent = None
        shell.allocatable_resource_generation = \
            self.allocatable_resource_generation
        shell._shared = True
        return shell

    def parent_node(self) -> Optional["CohortSnapshot"]:
        return self.parent

    def root(self) -> "CohortSnapshot":
        c = self
        while c.parent is not None:
            c = c.parent
        return c

    def subtree_cqs(self):
        """All member CQs in this cohort's subtree (the borrowing domain
        for hierarchical cohorts)."""
        yield from self.members
        for child in self.child_cohorts:
            yield from child.subtree_cqs()


class ClusterQueueSnapshot:
    # Copy-on-write flag, as on CohortSnapshot. The maintainer stamps
    # _shared=True onto its master objects once, so the hot handout loop
    # (incremental.py:_handout) propagates it through a plain __dict__
    # copy — masters are never mutated through add_usage, so the flag is
    # only ever honored on handed-out shells.
    _shared = False

    def __init__(self, cq: ClusterQueueCache, light: bool = False):
        """light=True shares the cache's structures instead of cloning
        (READ-ONLY consumers only): pipelined all-fit cycles never
        simulate on the snapshot — they read selectors, generations and
        admission checks — and cloning 2k resource trees per cycle was
        measurable. Any path that mutates snapshot state (preemption
        simulation, intra-cycle accounting) must use a full snapshot.

        Thread-safety contract: light readers may race cache mutators,
        so they may only read (a) scalar fields and (b) container fields
        the cache replaces WHOLESALE on update (resource_groups, quotas,
        admission_checks, selectors — see ClusterQueueCache.update);
        in-place-mutated containers (resource_node.usage, workloads) must
        not be iterated through a light snapshot (the solver's establish
        path re-takes a full snapshot for exactly this reason)."""
        self.name = cq.name
        self.cohort: Optional[CohortSnapshot] = None
        self.light = light
        if light:
            self.resource_groups = cq.resource_groups
            self.workloads = cq.workloads
            self.workloads_not_ready = cq.workloads_not_ready
            self.admission_checks = cq.admission_checks
            self.resource_node = cq.resource_node
        else:
            self.resource_groups = [rg.clone() for rg in cq.resource_groups]
            self.workloads = dict(cq.workloads)
            self.workloads_not_ready = set(cq.workloads_not_ready)
            self.admission_checks = {k: set(v)
                                     for k, v in cq.admission_checks.items()}
            self.resource_node = cq.resource_node.clone()
        self.namespace_selector = cq.namespace_selector
        self.preemption = cq.preemption
        self.fair_weight = cq.fair_weight
        self.flavor_fungibility = cq.flavor_fungibility
        self.allocatable_resource_generation = cq.allocatable_resource_generation

    def _materialize(self) -> None:
        """First mutation of a copy-on-write shell: privatize this CQ's
        containers and the cohort chain's usage nodes, so preemption
        simulation and intra-cycle accounting never write through to the
        maintainer's persistent snapshot. Bounds per-cycle cloning to
        the CQs a cycle actually touches. resource_groups and
        admission_checks stay shared — no cycle path mutates them."""
        self.workloads = dict(self.workloads)
        self.workloads_not_ready = set(self.workloads_not_ready)
        self.resource_node = self.resource_node.clone()
        self._shared = False
        cohort = self.cohort
        while cohort is not None and cohort._shared:
            cohort.resource_node = cohort.resource_node.clone()
            cohort._shared = False
            cohort = cohort.parent

    # --- hierarchicalResourceNode protocol ---

    def parent_node(self) -> Optional[CohortSnapshot]:
        return self.cohort

    # --- quota queries (reference: clusterqueue_snapshot.go:53-135) ---

    def rg_by_resource(self, resource: str) -> Optional[ResourceGroupInfo]:
        for rg in self.resource_groups:
            if resource in rg.covered_resources:
                return rg
        return None

    def quota_for(self, fr: FlavorResource) -> rnode.ResourceQuota:
        return self.resource_node.quota_for(fr)

    def usage_for(self, fr: FlavorResource) -> int:
        return self.resource_node.usage.get(fr, 0)

    def available(self, fr: FlavorResource) -> int:
        return rnode.available(self, fr, True)

    def potential_available(self, fr: FlavorResource) -> int:
        return rnode.potential_available(self, fr)

    def borrowing_with(self, fr: FlavorResource, val: int) -> bool:
        return self.usage_for(fr) + val > self.quota_for(fr).nominal

    def borrowing(self, fr: FlavorResource) -> bool:
        return self.borrowing_with(fr, 0)

    def fits(self, usage: dict) -> bool:
        return all(self.available(fr) >= q for fr, q in usage.items())

    def add_usage(self, usage: dict) -> None:
        if self.light:
            # writing through a light snapshot would mutate the LIVE
            # cache's trees — corruption, not simulation
            raise RuntimeError("mutating a light (shared) snapshot")
        if self._shared:
            self._materialize()
        for fr, q in usage.items():
            rnode.add_usage(self, fr, q)

    def remove_usage(self, usage: dict) -> None:
        if self.light:
            raise RuntimeError("mutating a light (shared) snapshot")
        if self._shared:
            self._materialize()
        for fr, q in usage.items():
            rnode.remove_usage(self, fr, q)

    # --- DRF fair share (reference: clusterqueue.go:503-564) ---

    def dominant_resource_share(self) -> tuple:
        return dominant_resource_share(self, None, 0)

    def dominant_resource_share_with(self, wl_req: dict) -> tuple:
        return dominant_resource_share(self, wl_req, 1)

    def dominant_resource_share_without(self, wl_req: dict) -> tuple:
        return dominant_resource_share(self, wl_req, -1)


def dominant_resource_share(cq: ClusterQueueSnapshot, wl_req: Optional[dict], m: int) -> tuple:
    """(share, resource): share in [0, 1e6] — max over resources of
    (usage above remaining nominal quota / cohort lendable) * 1000,
    divided by the fair weight. Zero weight -> maxsize."""
    if cq.cohort is None:
        return 0, ""
    if cq.fair_weight == 0:
        return sys.maxsize, ""
    borrowing: dict = {}
    for fr in _flavor_resources(cq):
        remaining = cq.quota_for(fr).nominal - cq.usage_for(fr)
        b = (m * (wl_req or {}).get(fr, 0)) - remaining
        if b > 0:
            borrowing[fr.resource] = borrowing.get(fr.resource, 0) + b
    if not borrowing:
        return 0, ""
    # The borrowing domain is the whole cohort tree: the denominator is
    # the root's lendable capacity so shares are comparable across
    # subtrees (flat cohorts: root() is the cohort itself).
    lendable = cq.cohort.root().resource_node.calculate_lendable()
    drs, d_res = -1, ""
    for r_name in sorted(borrowing):
        lr = lendable.get(r_name, 0)
        if lr > 0:
            ratio = borrowing[r_name] * 1000 // lr
            if ratio > drs:
                drs, d_res = ratio, r_name
    dws = drs * 1000 // cq.fair_weight
    return dws, d_res


def _flavor_resources(cq: ClusterQueueSnapshot):
    for rg in cq.resource_groups:
        for f in rg.flavors:
            for r in rg.covered_resources:
                yield FlavorResource(f, r)


@dataclass
class Snapshot:
    cluster_queues: dict = field(default_factory=dict)  # name -> ClusterQueueSnapshot
    resource_flavors: dict = field(default_factory=dict)  # name -> ResourceFlavor
    inactive_cluster_queue_sets: set = field(default_factory=set)
    cohort_epoch: int = 0  # cohort-object structure version (Cache.cohort_epoch)
    flavor_spec_epoch: int = 0  # ResourceFlavor spec version (taints/labels)
    topology_epoch: int = 0  # solver-topology version (Cache.topology_epoch)
    # The cache's usage-journal position when the snapshot was taken:
    # the solver drains the journal up to here before each cycle.
    journal_seq: int = 0
    light: bool = False  # shared (not cloned) state; read-only consumers
    # MultiKueue remote-cluster capacity columns: an ordered tuple of
    # (cluster_name, {(flavor, resource): available}, active), stamped
    # by Cache.snapshot() from its remote_capacity_source. A lost
    # cluster stamps active=False, so its columns take no placement on
    # the next cycle. The source rebuilds the tuple on change.
    remote_clusters: tuple = ()
    # the AdmissionCheck names the MultiKueue controller owns: the
    # encoder marks the CQs that carry one as routing through the columns
    mk_check_names: frozenset = frozenset()

    def remove_workload(self, wl: wlpkg.Info) -> None:
        """Simulate removal (reference: snapshot.go:39)."""
        if self.light:
            raise RuntimeError("mutating a light (shared) snapshot")
        cq = self.cluster_queues[wl.cluster_queue]
        if cq._shared:
            cq._materialize()
        cq.workloads.pop(wl.key, None)
        cq.remove_usage(wl.flavor_resource_usage())

    def add_workload(self, wl: wlpkg.Info) -> None:
        if self.light:
            raise RuntimeError("mutating a light (shared) snapshot")
        cq = self.cluster_queues[wl.cluster_queue]
        if cq._shared:
            cq._materialize()
        cq.workloads[wl.key] = wl
        cq.add_usage(wl.flavor_resource_usage())
