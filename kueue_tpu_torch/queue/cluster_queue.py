"""Per-ClusterQueue pending heap with inadmissible-workload parking.

The port's copy of kueue_tpu/queue/cluster_queue.py, equivalent of the
reference's pkg/queue/cluster_queue.go: a
priority+timestamp heap, a separate inadmissibleWorkloads map with
requeue-backoff gating, popCycle/queueInadmissibleCycle race avoidance,
and strategy-dependent requeue (StrictFIFO requeues to the heap,
BestEffortFIFO parks inadmissible workloads until a relevant event).
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Callable, Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import Clock, find_condition, is_condition_false
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.utils.heap import Heap


class RequeueReason(Enum):
    GENERIC = ""
    FAILED_AFTER_NOMINATION = "FailedAfterNomination"
    NAMESPACE_MISMATCH = "NamespaceMismatch"
    PENDING_PREEMPTION = "PendingPreemption"


def queue_ordering_func(ordering: wlpkg.Ordering) -> Callable:
    """Priority desc, then queue-order timestamp asc
    (reference: cluster_queue.go:416-429)."""

    def less(a: wlpkg.Info, b: wlpkg.Info) -> bool:
        p1 = prioritypkg.priority(a.obj)
        p2 = prioritypkg.priority(b.obj)
        if p1 != p2:
            return p1 > p2
        return ordering.queue_order_timestamp(a.obj) <= ordering.queue_order_timestamp(b.obj)

    return less


class ClusterQueueHeap:
    def __init__(self, cq: api.ClusterQueue, ordering: wlpkg.Ordering, clock: Clock):
        self._less = queue_ordering_func(ordering)
        self.heap: Heap = Heap(key_func=lambda i: i.key, less_func=self._less)
        self.inadmissible: dict = {}  # key -> Info
        self.pop_cycle = 0
        self.queue_inadmissible_cycle = -1
        self.inflight: Optional[wlpkg.Info] = None
        self.clock = clock
        self._lock = threading.RLock()
        self.update(cq)

    def update(self, cq: api.ClusterQueue) -> None:
        with self._lock:
            self.name = cq.metadata.name
            self.queueing_strategy = cq.spec.queueing_strategy
            self.namespace_selector = cq.spec.namespace_selector
            self.cohort = cq.spec.cohort
            self.active = True  # refreshed by the manager from cache state

    # --- push/pop ---

    def push_or_update(self, info: wlpkg.Info) -> None:
        with self._lock:
            key = info.key
            self._forget_inflight(key)
            old = self.inadmissible.get(key)
            if old is not None:
                # Keep parked if nothing admission-relevant changed
                # (reference: cluster_queue.go:150-166).
                if self._equivalent_for_requeue(old.obj, info.obj):
                    self.inadmissible[key] = info
                    return
                del self.inadmissible[key]
            if self.heap.get_by_key(key) is None and not self.backoff_expired(info):
                self.inadmissible[key] = info
                return
            self.heap.push_or_update(info)

    @staticmethod
    def _equivalent_for_requeue(old: api.Workload, new: api.Workload) -> bool:
        return (old.spec == new.spec
                and old.status.reclaimable_pods == new.status.reclaimable_pods
                and find_condition(old.status.conditions, api.WORKLOAD_EVICTED)
                == find_condition(new.status.conditions, api.WORKLOAD_EVICTED)
                and find_condition(old.status.conditions, api.WORKLOAD_REQUEUED)
                == find_condition(new.status.conditions, api.WORKLOAD_REQUEUED))

    def backoff_expired(self, info: wlpkg.Info) -> bool:
        """reference: cluster_queue.go:176-190."""
        if is_condition_false(info.obj.status.conditions, api.WORKLOAD_REQUEUED):
            return False
        rs = info.obj.status.requeue_state
        if rs is None or rs.requeue_at is None:
            return True
        if wlpkg.is_evicted_by_pods_ready_timeout(info.obj) is None:
            return True
        return self.clock.now() >= rs.requeue_at

    def pop(self) -> Optional[wlpkg.Info]:
        with self._lock:
            self.pop_cycle += 1
            info = self.heap.pop()
            self.inflight = info
            return info

    def delete(self, wl: api.Workload) -> None:
        with self._lock:
            key = wlpkg.key(wl)
            self.inadmissible.pop(key, None)
            self.heap.delete(key)
            self._forget_inflight(key)

    def _forget_inflight(self, key: str) -> None:
        if self.inflight is not None and self.inflight.key == key:
            self.inflight = None

    # --- requeue (reference: cluster_queue.go:228-255, 405-410) ---

    def requeue_if_not_present(self, info: wlpkg.Info, reason: RequeueReason) -> bool:
        if self.queueing_strategy == api.STRICT_FIFO:
            immediate = reason != RequeueReason.NAMESPACE_MISMATCH
        else:
            immediate = reason in (RequeueReason.FAILED_AFTER_NOMINATION,
                                   RequeueReason.PENDING_PREEMPTION)
        return self._requeue_if_not_present(info, immediate)

    def _requeue_if_not_present(self, info: wlpkg.Info, immediate: bool) -> bool:
        with self._lock:
            key = info.key
            self._forget_inflight(key)
            pending_flavors = (info.last_assignment is not None
                               and info.last_assignment.pending_flavors())
            if self.backoff_expired(info) and (
                    immediate or self.queue_inadmissible_cycle >= self.pop_cycle
                    or pending_flavors):
                parked = self.inadmissible.pop(key, None)
                if parked is not None:
                    info = parked
                return self.heap.push_if_not_present(info)
            if key in self.inadmissible or self.heap.get_by_key(key) is not None:
                return False
            self.inadmissible[key] = info
            return True

    def queue_inadmissible_workloads(self, namespace_labels: Callable) -> bool:
        """Flush parked workloads whose namespace still matches and whose
        backoff expired (reference: cluster_queue.go:265-287).

        namespace_labels(namespace) -> labels dict or None if missing.
        """
        with self._lock:
            self.queue_inadmissible_cycle = self.pop_cycle
            if not self.inadmissible:
                return False
            remaining: dict = {}
            moved = False
            for key, info in self.inadmissible.items():
                labels = namespace_labels(info.obj.metadata.namespace)
                if (labels is None
                        or self.namespace_selector is None
                        or not self.namespace_selector.matches(labels)
                        or not self.backoff_expired(info)):
                    remaining[key] = info
                else:
                    moved = self.heap.push_if_not_present(info) or moved
            self.inadmissible = remaining
            return moved

    # --- introspection ---

    def pending_active(self) -> int:
        with self._lock:
            return len(self.heap) + (1 if self.inflight is not None else 0)

    def pending_inadmissible(self) -> int:
        with self._lock:
            return len(self.inadmissible)

    def pending(self) -> int:
        return self.pending_active() + self.pending_inadmissible()

    def total_elements(self) -> list:
        with self._lock:
            out = self.heap.items() + list(self.inadmissible.values())
            if self.inflight is not None:
                out.append(self.inflight)
            return out

    def snapshot_sorted(self) -> list:
        """All pending workloads in queue order (for visibility API)."""
        import functools
        elements = self.total_elements()
        return sorted(elements, key=functools.cmp_to_key(
            lambda a, b: -1 if self._less(a, b) else 1))

    def dump(self) -> list:
        with self._lock:
            return self.heap.keys()
