"""Core controller wiring.

Equivalent of the reference's pkg/controller/core/core.go:36-112
(SetupControllers) plus the watch registrations each reconciler's
SetupWithManager performs: store watch events feed the queue manager and
cache (the informer event-handler role) and enqueue reconcile keys,
including the cross-kind fan-outs (CQ events re-enqueue that queue's
workloads and LQs; AC/RF events re-enqueue referencing CQs).
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.controller.core.admissioncheck_controller import (
    AdmissionCheckReconciler,
    ResourceFlavorReconciler,
)
from kueue_tpu_torch.controller.core.clusterqueue_controller import ClusterQueueReconciler
from kueue_tpu_torch.controller.core.localqueue_controller import LocalQueueReconciler
from kueue_tpu_torch.controller.core.workload_controller import WorkloadReconciler
from kueue_tpu_torch.sim import DELETED, Store
from kueue_tpu_torch.sim.runtime import EventRecorder, Runtime


class CoreControllers:
    def __init__(self, wl, cq, lq, ac, rf):
        self.workload = wl
        self.cluster_queue = cq
        self.local_queue = lq
        self.admission_check = ac
        self.resource_flavor = rf


def setup_core_controllers(runtime: Runtime, store: Store, queues, cache,
                           recorder: EventRecorder, cfg=None, metrics=None,
                           registered_check_controllers: Optional[set] = None,
                           obs_recorder=None, journeys=None) -> CoreControllers:
    clock = runtime.clock
    wl_r = WorkloadReconciler(store, queues, cache, recorder, clock, cfg,
                              metrics, obs_recorder=obs_recorder,
                              journeys=journeys)
    cq_r = ClusterQueueReconciler(store, queues, cache, recorder, clock, metrics)
    lq_r = LocalQueueReconciler(store, queues, cache, recorder, clock, metrics)
    ac_r = AdmissionCheckReconciler(store, queues, cache, recorder, clock,
                                    registered_check_controllers)
    rf_r = ResourceFlavorReconciler(store, queues, cache, recorder, clock)

    wl_ctrl = runtime.controller("workload", wl_r.reconcile)
    cq_ctrl = runtime.controller("clusterqueue", cq_r.reconcile)
    lq_ctrl = runtime.controller("localqueue", lq_r.reconcile)
    ac_ctrl = runtime.controller("admissioncheck", ac_r.reconcile)
    rf_ctrl = runtime.controller("resourceflavor", rf_r.reconcile)

    def on_workload(event, wl, old):
        wl_r.handle_event(event, wl, old, wl_ctrl.enqueue)
        # keep LQ/CQ status counts fresh (reference: per-CRD watches on
        # Workload in clusterqueue/localqueue controllers)
        lq_ctrl.enqueue(f"{wl.metadata.namespace}/{wl.spec.queue_name}")
        cq_name = queues.cluster_queue_for_workload(wl)
        if cq_name:
            cq_ctrl.enqueue(cq_name)
        elif wl.status.admission is not None:
            cq_ctrl.enqueue(wl.status.admission.cluster_queue)

    def on_cluster_queue(event, cq, old):
        cq_r.handle_event(event, cq, old, cq_ctrl.enqueue)
        # Fan out to the queue's LQs/workloads only on spec changes or
        # deletion — status-only writes (the CQ reconciler's own) would
        # otherwise cost O(N^2) reconciles per cycle (reference:
        # workloadQueueHandler, workload_controller.go:757+).
        if event != DELETED and old is not None and old.spec == cq.spec:
            return
        name = cq.metadata.name
        for lq in store.list("LocalQueue", where=lambda q: q.spec.cluster_queue == name):
            lq_ctrl.enqueue(f"{lq.metadata.namespace}/{lq.metadata.name}")
            for wl in store.list("Workload", namespace=lq.metadata.namespace,
                                 where=lambda w: w.spec.queue_name == lq.metadata.name):
                wl_ctrl.enqueue(f"{wl.metadata.namespace}/{wl.metadata.name}")
        # flavors referenced by a deleted CQ may now be finalizable
        if event == DELETED:
            for rg in cq.spec.resource_groups:
                for fq in rg.flavors:
                    rf_ctrl.enqueue(fq.name)

    def on_local_queue(event, lq, old):
        lq_r.handle_event(event, lq, old, lq_ctrl.enqueue)
        # status-only writes (pending counts) don't re-enqueue the
        # queue's workloads — that would cost O(N^2) per admission cycle
        if event != DELETED and old is not None and old.spec == lq.spec:
            return
        if lq.spec.cluster_queue:
            cq_ctrl.enqueue(lq.spec.cluster_queue)
        for wl in store.list("Workload", namespace=lq.metadata.namespace,
                             where=lambda w: w.spec.queue_name == lq.metadata.name):
            wl_ctrl.enqueue(f"{wl.metadata.namespace}/{wl.metadata.name}")

    def on_admission_check(event, ac, old):
        ac_r.handle_event(event, ac, old, ac_ctrl.enqueue)
        name = ac.metadata.name
        for cq in store.list("ClusterQueue", copy_objects=False):
            checks = set(cq.spec.admission_checks) | {
                r.name for r in cq.spec.admission_checks_strategy}
            if name in checks:
                cq_ctrl.enqueue(cq.metadata.name)

    def on_resource_flavor(event, rf, old):
        rf_r.handle_event(event, rf, old, rf_ctrl.enqueue)
        name = rf.metadata.name
        for cq in store.list("ClusterQueue", copy_objects=False):
            if any(fq.name == name for rg in cq.spec.resource_groups
                   for fq in rg.flavors):
                cq_ctrl.enqueue(cq.metadata.name)

    def on_cohort(event, cohort, old):
        # v1alpha1 Cohort objects: parent edges + own quotas feed the
        # cache's cohort tree (reference: the cohort controller wiring in
        # cache.AddOrUpdateCohort, pkg/cache/cache.go:418). A topology
        # change can unblock any parked workload whose CQ sits in a
        # cohort, so flush those queues (cohort events are rare).
        if event == DELETED:
            cache.delete_cohort(cohort.metadata.name)
        else:
            try:
                cache.add_or_update_cohort(cohort)
            except ValueError as exc:  # cycle-inducing parent edge
                recorder.event(cohort, "Warning", "CohortCycle", str(exc))
        names = {name for name, cqc in cache.hm.cluster_queues.items()
                 if cqc.cohort is not None}
        queues.queue_inadmissible_workloads(names)
        for n in names:
            cq_ctrl.enqueue(n)

    store.watch("Workload", on_workload)
    store.watch("Cohort", on_cohort)
    store.watch("ClusterQueue", on_cluster_queue)
    store.watch("LocalQueue", on_local_queue)
    store.watch("AdmissionCheck", on_admission_check)
    store.watch("ResourceFlavor", on_resource_flavor)

    return CoreControllers(wl_r, cq_r, lq_r, ac_r, rf_r)
