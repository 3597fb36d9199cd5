"""Bidirectional ClusterQueue <-> Cohort graph with implicit-cohort lifecycle.

Equivalent of the reference's pkg/hierarchy/manager.go:14-90: cohorts
can exist implicitly (referenced by a CQ but not created as API objects)
and are garbage-collected when the last reference is gone; explicit
cohorts (v1alpha1 Cohort objects) may carry their own quotas and a
parent, forming arbitrary-depth trees.
"""

from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar

CQ = TypeVar("CQ")
C = TypeVar("C")


class CohortNode(Generic[CQ, C]):
    def __init__(self, name: str, payload: C):
        self.name = name
        self.payload = payload
        self.explicit = False
        self.child_cqs: dict[str, CQ] = {}
        self.child_cohorts: dict[str, "CohortNode[CQ, C]"] = {}
        self.parent: Optional["CohortNode[CQ, C]"] = None

    def has_parent(self) -> bool:
        return self.parent is not None


class Manager(Generic[CQ, C]):
    """Tracks CQ->cohort and cohort->cohort edges.

    cohort_factory builds the payload for a newly-materialized cohort.
    """

    def __init__(self, cohort_factory: Callable[[str], C]):
        self._cohort_factory = cohort_factory
        self.cluster_queues: dict[str, CQ] = {}
        self.cohorts: dict[str, CohortNode[CQ, C]] = {}
        self._cq_cohort: dict[str, str] = {}

    # --- ClusterQueues ---

    def add_cluster_queue(self, name: str, cq: CQ) -> None:
        self.cluster_queues[name] = cq

    def update_cluster_queue_edge(self, name: str, cohort_name: str) -> None:
        """Point CQ at cohort ('' = none), materializing/gc-ing implicit
        cohorts (reference: manager.go:35-78)."""
        old = self._cq_cohort.get(name, "")
        if old == cohort_name:
            return
        if old:
            node = self.cohorts.get(old)
            if node:
                node.child_cqs.pop(name, None)
                self._gc_if_unreferenced(node)
        if cohort_name:
            node = self._get_or_create(cohort_name)
            node.child_cqs[name] = self.cluster_queues[name]
            self._cq_cohort[name] = cohort_name
        else:
            self._cq_cohort.pop(name, None)

    def delete_cluster_queue(self, name: str) -> None:
        self.update_cluster_queue_edge(name, "")
        self.cluster_queues.pop(name, None)

    def cohort_of(self, cq_name: str) -> Optional[CohortNode[CQ, C]]:
        cname = self._cq_cohort.get(cq_name, "")
        return self.cohorts.get(cname) if cname else None

    # --- Cohorts ---

    def add_cohort(self, name: str) -> CohortNode[CQ, C]:
        """Make cohort explicit (API object exists)."""
        node = self._get_or_create(name)
        node.explicit = True
        return node

    def update_cohort_edge(self, name: str, parent_name: str) -> None:
        # Cycle check BEFORE any mutation: a raise must leave the graph
        # untouched (a partial detach would corrupt quota aggregation).
        if parent_name and self._would_cycle(name, parent_name):
            raise ValueError(f"cohort cycle: {name} -> {parent_name}")
        node = self._get_or_create(name)
        if node.parent is not None:
            if node.parent.name == parent_name:
                return
            node.parent.child_cohorts.pop(name, None)
            old_parent = node.parent
            node.parent = None
            self._gc_if_unreferenced(old_parent)
        if parent_name:
            parent = self._get_or_create(parent_name)
            parent.child_cohorts[name] = node
            node.parent = parent

    def delete_cohort(self, name: str) -> None:
        node = self.cohorts.get(name)
        if node is None:
            return
        node.explicit = False
        self.update_cohort_edge(name, "")
        self._gc_if_unreferenced(node)

    def root(self, node: CohortNode[CQ, C]) -> CohortNode[CQ, C]:
        while node.parent is not None:
            node = node.parent
        return node

    def cycle_free(self) -> bool:
        for name in self.cohorts:
            seen = set()
            node = self.cohorts[name]
            while node is not None:
                if node.name in seen:
                    return False
                seen.add(node.name)
                node = node.parent
        return True

    def _would_cycle(self, child: str, parent: str) -> bool:
        node = self.cohorts.get(parent)
        while node is not None:
            if node.name == child:
                return True
            node = node.parent
        return False

    def _get_or_create(self, name: str) -> CohortNode[CQ, C]:
        node = self.cohorts.get(name)
        if node is None:
            node = CohortNode(name, self._cohort_factory(name))
            self.cohorts[name] = node
        return node

    def _gc_if_unreferenced(self, node: CohortNode) -> None:
        if not node.explicit and not node.child_cqs and not node.child_cohorts and node.parent is None:
            self.cohorts.pop(node.name, None)
