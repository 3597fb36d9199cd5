"""Queue Manager: LocalQueues -> ClusterQueue heaps -> Heads().

The port's copy of kueue_tpu/queue/manager.py, equivalent of the
reference's pkg/queue/manager.go:73-606:
- one ClusterQueueHeap per CQ, LocalQueue item tracking
- Heads() blocks on a condition variable until any CQ head exists, then
  pops at most one head per CQ per cycle
- cohort-wide inadmissible flush when usage changes
- the workload delta feed that maintains the solver's encode arena

- the journey listeners of the observability layer (obs/journey.py)
- the per-shard cq_filter on every heads pop

Left out (the JAX package has them): the QueueVisibility top-N snapshots
(update_snapshot) and the manager's cron that refreshes them. They come
with their reader, the visibility server (ROADMAP item 5b).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import REAL_CLOCK, Clock
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.queue.cluster_queue import ClusterQueueHeap, RequeueReason


class LocalQueueItems:
    def __init__(self, lq: api.LocalQueue):
        self.key = f"{lq.metadata.namespace}/{lq.metadata.name}"
        self.cluster_queue = lq.spec.cluster_queue
        self.items: dict = {}  # wl key -> Info


class Manager:
    def __init__(self, ordering: Optional[wlpkg.Ordering] = None,
                 clock: Clock = REAL_CLOCK,
                 namespace_labels: Optional[Callable] = None,
                 excluded_resource_prefixes: Optional[list] = None):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.ordering = ordering or wlpkg.Ordering()
        self.clock = clock
        self.cluster_queues: dict = {}  # name -> ClusterQueueHeap
        self.local_queues: dict = {}    # "ns/name" -> LocalQueueItems
        # namespace_labels(ns) -> labels dict or None; default allows all.
        self.namespace_labels = namespace_labels or (lambda ns: {})
        self.excluded_resource_prefixes = excluded_resource_prefixes or []
        self._stopped = False
        # Workload delta feed (solver encode arena): every pending-set
        # mutation that can change a workload's encoded rows notifies
        # the registered listeners, so derived per-workload state is
        # maintained by deltas instead of rescanned per cycle.
        self._workload_listeners: list = []
        # Info-carrying variant of the same feed (the journey ledger,
        # obs/journey.py): cb(kind, key, info); the arrival hook needs the
        # Info (creation timestamp, CQ), which the key-only arena feed
        # omits (kueue_tpu/queue/manager.py:49-53).
        self._journey_listeners: list = []

    def add_workload_listener(self, cb: Callable[[str, str], None]) -> None:
        """Register cb(kind, key): 'upsert' = the workload was added or
        its object replaced (any derived encoding is stale); 'del' = it
        left the pending set. Called under the manager lock — listeners
        must only enqueue, never block or call back into the manager.
        Requeues of an unchanged Info deliberately do NOT notify: the
        common per-cycle requeue churn must keep derived rows valid."""
        with self._lock:
            self._workload_listeners.append(cb)

    def add_journey_listener(self, cb: Callable[[str, str, object], None]
                             ) -> None:
        """Like add_workload_listener, but cb(kind, key, info) carries
        the Info (None when the mutator no longer holds it). Same
        contract: fired under the manager lock, listeners only record."""
        with self._lock:
            self._journey_listeners.append(cb)

    def _notify(self, kind: str, key: str, info=None) -> None:
        for cb in self._workload_listeners:
            cb(kind, key)
        for cb in self._journey_listeners:
            cb(kind, key, info)

    def _new_info(self, wl: api.Workload) -> wlpkg.Info:
        return wlpkg.Info(wl, excluded_resource_prefixes=self.excluded_resource_prefixes)

    def any_strict_fifo(self) -> bool:
        """True when any CQ uses StrictFIFO: its requeued head must block
        the queue, so the scheduler may not pop the next cycle's heads
        before the previous cycle's requeues (the pipeline's gate,
        kueue_tpu/queue/manager.py:83-89)."""
        with self._lock:
            return any(cqh.queueing_strategy == api.STRICT_FIFO
                       for cqh in self.cluster_queues.values())

    # --- ClusterQueues ---

    def add_cluster_queue(self, cq: api.ClusterQueue) -> None:
        with self._lock:
            name = cq.metadata.name
            if name in self.cluster_queues:
                return
            cqh = ClusterQueueHeap(cq, self.ordering, self.clock)
            self.cluster_queues[name] = cqh
            # Adopt pending workloads from matching LocalQueues.
            added = False
            for lq in self.local_queues.values():
                if lq.cluster_queue == name:
                    for info in lq.items.values():
                        added = cqh.heap.push_if_not_present(info) or added
            if added:
                self._cond.notify_all()

    def update_cluster_queue(self, cq: api.ClusterQueue, spec_updated: bool = True) -> None:
        with self._lock:
            cqh = self.cluster_queues.get(cq.metadata.name)
            if cqh is None:
                return
            old_strategy = cqh.queueing_strategy
            cqh.update(cq)
            if spec_updated or old_strategy != cqh.queueing_strategy:
                if cqh.queue_inadmissible_workloads(self.namespace_labels):
                    self._cond.notify_all()

    def delete_cluster_queue(self, name: str) -> None:
        with self._lock:
            self.cluster_queues.pop(name, None)

    # --- LocalQueues ---

    def add_local_queue(self, lq: api.LocalQueue, workloads: Optional[list] = None) -> None:
        """workloads: pre-existing Workloads pointing at this queue
        (reference lists them from the informer cache)."""
        with self._lock:
            items = LocalQueueItems(lq)
            if items.key in self.local_queues:
                return
            self.local_queues[items.key] = items
            for wl in workloads or []:
                if wl.spec.queue_name != lq.metadata.name or wlpkg.has_quota_reservation(wl):
                    continue
                info = self._new_info(wl)
                info.cluster_queue = items.cluster_queue
                items.items[wlpkg.key(wl)] = info
                self._notify("upsert", wlpkg.key(wl), info)
            cqh = self.cluster_queues.get(items.cluster_queue)
            if cqh is not None:
                added = False
                for info in items.items.values():
                    added = cqh.heap.push_if_not_present(info) or added
                if added:
                    self._cond.notify_all()

    def update_local_queue(self, lq: api.LocalQueue) -> None:
        with self._lock:
            key = f"{lq.metadata.namespace}/{lq.metadata.name}"
            items = self.local_queues.get(key)
            if items is None or items.cluster_queue == lq.spec.cluster_queue:
                return
            old_cq = self.cluster_queues.get(items.cluster_queue)
            if old_cq is not None:
                for info in items.items.values():
                    old_cq.delete(info.obj)
            items.cluster_queue = lq.spec.cluster_queue
            # The target ClusterQueue changed: every member's encoded
            # rows are keyed to the old CQ — invalidate the arena rows
            # (feed) AND the per-Info oracle cache, which keys only on
            # (topo token, resourceVersion) and would otherwise serve
            # the old CQ's row.
            for info in items.items.values():
                info._solver_enc = None
                self._notify("upsert", info.key, info)
            new_cq = self.cluster_queues.get(items.cluster_queue)
            if new_cq is not None:
                added = False
                for info in items.items.values():
                    added = new_cq.heap.push_if_not_present(info) or added
                if added:
                    self._cond.notify_all()

    def delete_local_queue(self, lq: api.LocalQueue) -> None:
        with self._lock:
            key = f"{lq.metadata.namespace}/{lq.metadata.name}"
            items = self.local_queues.pop(key, None)
            if items is None:
                return
            cqh = self.cluster_queues.get(items.cluster_queue)
            for info in items.items.values():
                if cqh is not None:
                    cqh.delete(info.obj)
                self._notify("del", info.key, info)

    # --- workload flow ---

    def add_or_update_workload(self, wl: api.Workload) -> bool:
        with self._lock:
            return self._add_or_update_workload_locked(wl)

    def _add_or_update_workload_locked(self, wl: api.Workload) -> bool:
        items = self.local_queues.get(wlpkg.queue_key(wl))
        if items is None:
            return False
        info = self._new_info(wl)
        info.cluster_queue = items.cluster_queue
        items.items[info.key] = info
        self._notify("upsert", info.key, info)
        cqh = self.cluster_queues.get(items.cluster_queue)
        if cqh is None:
            return False
        cqh.push_or_update(info)
        self._cond.notify_all()
        return True

    def update_workload(self, old: api.Workload, new: api.Workload) -> bool:
        with self._lock:
            if old.spec.queue_name != new.spec.queue_name:
                self._delete_workload_locked(old)
            return self._add_or_update_workload_locked(new)

    def delete_workload(self, wl: api.Workload) -> None:
        with self._lock:
            self._delete_workload_locked(wl)

    def _delete_workload_locked(self, wl: api.Workload) -> None:
        items = self.local_queues.get(wlpkg.queue_key(wl))
        if items is not None:
            info = items.items.pop(wlpkg.key(wl), None)
            if info is not None:
                self._notify("del", wlpkg.key(wl), info)
            cqh = self.cluster_queues.get(items.cluster_queue)
            if cqh is not None:
                cqh.delete(wl)

    def requeue_workload(self, info: wlpkg.Info, reason: RequeueReason) -> bool:
        """reference: manager.go:325 — re-fetches the workload upstream;
        here the caller passes the current Info."""
        with self._lock:
            if wlpkg.has_quota_reservation(info.obj) or not wlpkg.is_active(info.obj):
                return False
            items = self.local_queues.get(wlpkg.queue_key(info.obj))
            if items is None:
                return False
            items.items[info.key] = info
            cqh = self.cluster_queues.get(items.cluster_queue)
            if cqh is None:
                return False
            added = cqh.requeue_if_not_present(info, reason)
            if added:
                self._cond.notify_all()
            return added

    def cluster_queue_for_workload(self, wl: api.Workload) -> Optional[str]:
        with self._lock:
            items = self.local_queues.get(wlpkg.queue_key(wl))
            if items is None:
                return None
            if items.cluster_queue in self.cluster_queues:
                return items.cluster_queue
            return None

    # --- inadmissible flushing (reference: manager.go:381-450) ---

    def queue_associated_inadmissible_workloads_after(self, wl: api.Workload,
                                                      action: Optional[Callable] = None) -> None:
        """After a workload releases quota, flush the whole cohort's parked
        workloads (reference: manager.go:381)."""
        with self._lock:
            if action:
                action()
            if wl.status.admission is None:
                return
            cqh = self.cluster_queues.get(wl.status.admission.cluster_queue)
            if cqh is None:
                return
            self._queue_all_inadmissible_in_cohort(cqh)

    def queue_inadmissible_workloads(self, cq_names: set) -> None:
        with self._lock:
            queued = False
            for name in cq_names:
                cqh = self.cluster_queues.get(name)
                if cqh is None:
                    continue
                queued = self._queue_all_inadmissible_in_cohort(cqh) or queued
            if queued:
                self._cond.notify_all()

    def _queue_all_inadmissible_in_cohort(self, cqh: ClusterQueueHeap) -> bool:
        queued = False
        if cqh.cohort:
            for other in self.cluster_queues.values():
                if other.cohort == cqh.cohort:
                    queued = other.queue_inadmissible_workloads(self.namespace_labels) or queued
        else:
            queued = cqh.queue_inadmissible_workloads(self.namespace_labels)
        if queued:
            self._cond.notify_all()
        return queued

    # --- heads (reference: manager.go:471-509) ---

    def heads(self, timeout: Optional[float] = None,
              cq_filter=None) -> list:
        """Block until any CQ has a head, then pop one head per CQ.
        Returns [] when stopped (or on timeout if given).
        ``cq_filter(cq_name) -> bool`` restricts the pop to the CQs it
        accepts (an admission shard's; kueue_tpu/queue/manager.py:
        303-330)."""
        with self._cond:
            while not self._stopped:
                h = self._heads_locked(cq_filter)
                if h:
                    return h
                if not self._cond.wait(timeout=timeout):
                    return []
            return []

    def heads_nonblocking(self, cq_filter=None) -> list:
        with self._lock:
            return self._heads_locked(cq_filter)

    def _heads_locked(self, cq_filter=None) -> list:
        out = []
        for cqh in self.cluster_queues.values():
            if not cqh.active:
                continue
            if cq_filter is not None and not cq_filter(cqh.name):
                continue
            info = cqh.pop()
            if info is not None:
                info.cluster_queue = cqh.name
                out.append(info)
        return out

    def set_cluster_queue_active(self, name: str, active: bool) -> None:
        with self._lock:
            cqh = self.cluster_queues.get(name)
            if cqh is not None:
                cqh.active = active
                if active:
                    self._cond.notify_all()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._cond.notify_all()

    def broadcast(self) -> None:
        with self._lock:
            self._cond.notify_all()

    # --- pending counts ---

    def pending(self, cq_name: str) -> int:
        with self._lock:
            cqh = self.cluster_queues.get(cq_name)
            return cqh.pending() if cqh else 0

    def pending_total(self) -> int:
        """Total pending (active + inadmissible) across all CQs."""
        with self._lock:
            return sum(cqh.pending() for cqh in self.cluster_queues.values())

    def pending_order(self, cq_name: str) -> list:
        """One CQ's pending workloads in queue order."""
        cqh = self.cluster_queues.get(cq_name)
        return cqh.snapshot_sorted() if cqh else []

    def pending_workloads_in_local_queue(self, lq_key: str) -> int:
        with self._lock:
            items = self.local_queues.get(lq_key)
            return len(items.items) if items else 0
