"""ClusterQueueReconciler: status, Active condition, terminating finalization.

Equivalent of the reference's
pkg/controller/core/clusterqueue_controller.go:159-203 (+ status update
:334-449, QueueVisibility snapshot cron :553+):
- mirrors spec into cache + queue manager (watch handlers)
- status: pending/reserving/admitted counts, flavorsReservation/Usage,
  Active condition with the cache's inactive reason
- finalizer removed only once no workload reserves quota
- per-CQ metrics incl. optional resource quotas/usage
"""

from __future__ import annotations

import copy as _copy

from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import Condition, set_condition
from kueue_tpu_torch.sim import ADDED, DELETED, Store
from kueue_tpu_torch.sim.runtime import EventRecorder

REQUEUE_TERMINATING_SECONDS = 1.0


class ClusterQueueReconciler:
    def __init__(self, store: Store, queues, cache, recorder: EventRecorder,
                 clock, metrics=None, report_resource_metrics: bool = False):
        self.store = store
        self.queues = queues
        self.cache = cache
        self.recorder = recorder
        self.clock = clock
        self.metrics = metrics
        self.report_resource_metrics = report_resource_metrics
        self._last_sig: dict = {}  # cq name -> last written status inputs
        from kueue_tpu_torch.controller.core.status_usage import FlavorUsageCache
        self._usage_cache = FlavorUsageCache()

    def reconcile(self, key: str):
        cq = self.store.try_get("ClusterQueue", "", key, copy_object=False)
        if cq is None:
            return None
        now = self.clock.now()

        if cq.metadata.deletion_timestamp is not None:
            # finalize only when nothing reserves quota anymore
            # (reference: :173-190)
            cqc = self.cache.cluster_queue(key)
            if cqc is not None and cqc.reserving_workloads_count() > 0:
                if self.metrics:
                    self.metrics.report_cluster_queue_status(key, "terminating")
                return REQUEUE_TERMINATING_SECONDS
            if api.RESOURCE_IN_USE_FINALIZER in cq.metadata.finalizers:
                cq = _copy.deepcopy(cq)
                cq.metadata.finalizers.remove(api.RESOURCE_IN_USE_FINALIZER)
                self.store.update(cq)
            return None

        cqc = self.cache.cluster_queue(key)
        if cqc is None:
            return None

        # Cheap change signature: skip rebuilding the full 32-flavor
        # status object (and its no-op update_status compare) when the
        # inputs are unchanged — at scale most CQ reconciles are fan-out
        # echoes of unrelated admissions.
        act = self.queues.cluster_queues.get(key)
        sig = (cq.metadata.resource_version,
               (act.pending_active(), act.pending_inadmissible())
               if act is not None else self.queues.pending(key),
               cqc.usage_version,
               cqc.active,
               # Cohort-level inputs: a sibling CQ's or cohort's quota
               # change alters this CQ's weighted share / lendable math,
               # and the inactive message can change (different missing
               # flavor) while `active` stays False. topology_epoch moves
               # on spec-level changes only — not workload churn — so the
               # fan-out-echo skip stays effective.
               self.cache.topology_epoch,
               cqc.inactive_reason() if not cqc.active else "")
        if self._last_sig.get(key) == sig:
            return None
        self._last_sig[key] = sig
        # status (reference: :334-449)
        reservation_usage, admitted_usage = self.cache.usage_for_cluster_queue(key)
        status_obj = _copy.copy(cq)
        status_obj.status = api.ClusterQueueStatus(
            conditions=[_copy.copy(c) for c in cq.status.conditions],
            fair_sharing_weighted_share=cq.status.fair_sharing_weighted_share,
            pending_workloads=self.queues.pending(key),
            reserving_workloads=cqc.reserving_workloads_count(),
            admitted_workloads=cqc.admitted_workloads_count,
            flavors_reservation=self._usage_cache.build(
                key, "resv", cq.spec, reservation_usage, borrowed=True),
            flavors_usage=self._usage_cache.build(
                key, "adm", cq.spec, admitted_usage, borrowed=True))
        cq = status_obj

        active = cqc.active
        if active:
            cond = Condition(type=api.CLUSTER_QUEUE_ACTIVE, status="True",
                             reason="Ready", message="Can admit new workloads",
                             observed_generation=cq.metadata.generation)
        else:
            cond = Condition(type=api.CLUSTER_QUEUE_ACTIVE, status="False",
                             reason=_reason_token(cqc.inactive_reason()),
                             message=f"Can't admit new workloads: {cqc.inactive_reason()}",
                             observed_generation=cq.metadata.generation)
        set_condition(cq.status.conditions, cond, now)
        self.store.update_status(cq, owned_status=True)
        self.queues.set_cluster_queue_active(key, active)

        if self.metrics:
            self.metrics.report_cluster_queue_status(
                key, "active" if active else "pending")
            self.metrics.reserving_active_workloads.set(
                cq.status.reserving_workloads, cluster_queue=key)
            self.metrics.admitted_active_workloads.set(
                cq.status.admitted_workloads, cluster_queue=key)
            act = self.queues.cluster_queues.get(key)
            if act is not None:
                self.metrics.report_pending_workloads(
                    key, act.pending_active(), act.pending_inadmissible())
            if self.report_resource_metrics:
                self._report_resource_metrics(cq, reservation_usage, admitted_usage)

        # QueueVisibility top-N snapshots refresh on the manager's timed
        # task (reference: :553+ runs them on the QueueVisibility
        # interval, not per reconcile — a full backlog sort per status
        # echo was a top control-plane cost at the 2k-CQ scale).
        return None

    def _report_resource_metrics(self, cq, reservation_usage, admitted_usage):
        cohort = cq.spec.cohort
        for rg in cq.spec.resource_groups:
            for fq in rg.flavors:
                for quota in fq.resources:
                    fr = (fq.name, quota.name)
                    self.metrics.report_cluster_queue_quotas(
                        cohort, cq.metadata.name, fq.name, quota.name,
                        quota.nominal_quota,
                        quota.borrowing_limit if quota.borrowing_limit is not None else -1,
                        quota.lending_limit if quota.lending_limit is not None else -1)
                    lbl = dict(cohort=cohort, cluster_queue=cq.metadata.name,
                               flavor=fq.name, resource=quota.name)
                    self.metrics.cluster_queue_resource_reservation.set(
                        reservation_usage.get(fr, 0), **lbl)
                    self.metrics.cluster_queue_resource_usage.set(
                        admitted_usage.get(fr, 0), **lbl)

    # -- watch handlers (reference: clusterqueue_controller.go event side) --

    def handle_event(self, event: str, cq: api.ClusterQueue,
                     old: Optional[api.ClusterQueue], enqueue) -> None:
        name = cq.metadata.name
        if event == ADDED:
            self.cache.add_cluster_queue(cq)
            self.queues.add_cluster_queue(cq)
        elif event == DELETED:
            self.cache.delete_cluster_queue(name)
            self.queues.delete_cluster_queue(name)
            self._last_sig.pop(name, None)
            self._usage_cache.forget(name)
            if self.metrics:
                self.metrics.clear_cluster_queue_metrics(name)
            return
        else:
            if cq.metadata.deletion_timestamp is not None:
                # terminating: cache flips status so no new admissions
                self.cache.terminate_cluster_queue(name)
            # Status-subresource writes share the stored spec object
            # (store.update_status copies only status), so an identity
            # check skips the cache/queue spec re-ingest for the CQ
            # reconciler's own counter refreshes — the dominant CQ event
            # class at scale.
            if old is None or old.spec is not cq.spec:
                self.cache.update_cluster_queue(cq)
                self.queues.update_cluster_queue(
                    cq, spec_updated=old is None or old.spec != cq.spec)
        enqueue(name)


def _reason_token(reason: str) -> str:
    return reason.split(":", 1)[0] if reason else "Unknown"



