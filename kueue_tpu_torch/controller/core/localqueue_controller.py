"""LocalQueueReconciler: status + Active condition + StopPolicy.

Equivalent of the reference's pkg/controller/core/localqueue_controller.go:
status counts (pending from queue manager, reserving/admitted + flavor
usage from cache), Active condition gated on the target ClusterQueue's
existence/active state and the LQ's own StopPolicy.
"""

from __future__ import annotations

import copy as _copy

from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import Condition, set_condition
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.sim import ADDED, DELETED, Store
from kueue_tpu_torch.sim.runtime import EventRecorder


class LocalQueueReconciler:
    def __init__(self, store: Store, queues, cache, recorder: EventRecorder,
                 clock, metrics=None):
        self.store = store
        self.queues = queues
        self.cache = cache
        self.recorder = recorder
        self.clock = clock
        self.metrics = metrics
        self._last_sig: dict = {}  # lq key -> last written status inputs
        from kueue_tpu_torch.controller.core.status_usage import FlavorUsageCache
        self._usage_cache = FlavorUsageCache()

    def reconcile(self, key: str):
        namespace, name = key.split("/", 1)
        lq = self.store.try_get("LocalQueue", namespace, name,
                                copy_object=False)
        if lq is None:
            return None
        cq = self.store.try_get("ClusterQueue", "", lq.spec.cluster_queue,
                                copy_object=False)
        # Cheap change signature: most LQ reconciles at scale are fan-out
        # echoes of unrelated events — skip the full status rebuild (and
        # its no-op update_status compare) when the inputs are unchanged.
        # The CQ's resourceVersion covers spec changes (the flavor usage
        # rows are built from cq.spec).
        usage0 = self.cache.local_queue_usage(lq)
        sig = (lq.metadata.resource_version,
               cq.metadata.resource_version if cq is not None else None,
               self.queues.pending_workloads_in_local_queue(key),
               self.cache.cluster_queue_active(lq.spec.cluster_queue),
               usage0.version if usage0 is not None else None)
        if self._last_sig.get(key) == sig:
            return None
        self._last_sig[key] = sig
        status_obj = _copy.copy(lq)
        status_obj.status = api.LocalQueueStatus(
            conditions=[_copy.copy(c) for c in lq.status.conditions])
        lq = status_obj
        now = self.clock.now()
        if lq.spec.stop_policy != api.STOP_POLICY_NONE:
            cond = Condition(type=api.LOCAL_QUEUE_ACTIVE, status="False",
                             reason="Stopped", message="LocalQueue is stopped",
                             observed_generation=lq.metadata.generation)
        else:
            if cq is None:
                cond = Condition(
                    type=api.LOCAL_QUEUE_ACTIVE, status="False",
                    reason="ClusterQueueDoesNotExist",
                    message="Can't submit new workloads to clusterQueue",
                    observed_generation=lq.metadata.generation)
            elif not self.cache.cluster_queue_active(lq.spec.cluster_queue):
                cond = Condition(
                    type=api.LOCAL_QUEUE_ACTIVE, status="False",
                    reason="ClusterQueueIsInactive",
                    message="Can't submit new workloads to clusterQueue",
                    observed_generation=lq.metadata.generation)
            else:
                cond = Condition(type=api.LOCAL_QUEUE_ACTIVE, status="True",
                                 reason="Ready", message="Can submit new workloads to clusterQueue",
                                 observed_generation=lq.metadata.generation)
        set_condition(lq.status.conditions, cond, now)

        lq.status.pending_workloads = self.queues.pending_workloads_in_local_queue(key)
        usage = self.cache.local_queue_usage(lq)
        if usage is not None:
            lq.status.reserving_workloads = usage.reserving_workloads
            lq.status.admitted_workloads = usage.admitted_workloads
            if cq is not None:
                lq.status.flavors_reservation = self._usage_cache.build(
                    key, "resv", cq.spec, usage.usage, borrowed=False)
                lq.status.flavors_usage = self._usage_cache.build(
                    key, "adm", cq.spec, usage.admitted_usage, borrowed=False)
        else:
            lq.status.reserving_workloads = 0
            lq.status.admitted_workloads = 0
        self.store.update_status(lq, owned_status=True)
        return None

    # -- watch handlers -------------------------------------------------

    def handle_event(self, event: str, lq: api.LocalQueue,
                     old: Optional[api.LocalQueue], enqueue) -> None:
        key = f"{lq.metadata.namespace}/{lq.metadata.name}"
        if event == ADDED:
            workloads = self.store.list(
                "Workload", namespace=lq.metadata.namespace,
                where=lambda wl: wl.spec.queue_name == lq.metadata.name
                and not wlpkg.is_finished(wl))
            self.queues.add_local_queue(lq, workloads)
            self.cache.add_local_queue(lq)
        elif event == DELETED:
            self.queues.delete_local_queue(lq)
            self.cache.delete_local_queue(lq)
            self._last_sig.pop(key, None)
            self._usage_cache.forget(key)
            return
        else:
            if old is not None and old.spec.cluster_queue != lq.spec.cluster_queue:
                self.cache.delete_local_queue(old)
                self.cache.add_local_queue(lq)
            self.queues.update_local_queue(lq)
        enqueue(key)



