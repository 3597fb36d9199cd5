"""MultiKueue: multi-cluster dispatch as an AdmissionCheck.

Equivalent of the reference's pkg/controller/admissionchecks/multikueue
(multikueuecluster.go:67-307, workload.go:137-420):
- each MultiKueueCluster names a worker cluster; the reference dials it
  via a kubeconfig secret with fsnotify-driven reconnect — the sim
  resolves the name through an injected registry of remote stores
  (worker clusters are full KueueManagers in tests, the analogue of the
  reference's two envtest instances in one process)
- for every local workload with QuotaReserved and a multikueue check,
  mirror the workload (and its batch Job, via the adapter) into every
  cluster of the check's MultiKueueConfig
- the FIRST cluster to reserve quota wins: the mirrors on the other
  clusters are deleted; the check turns Ready and records the cluster
- the remote Finished condition is copied back, then remotes are GC'd
- if the reserving cluster disappears, the check flips to Retry after
  worker_lost_timeout (config multiKueue.workerLostTimeout)
"""

from __future__ import annotations

import copy
from typing import Optional

from kueue_tpu_torch.api import autoscaling as asapi
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.corev1 import RESOURCE_PODS
from kueue_tpu_torch.api.meta import Condition, find_condition, is_condition_true, set_condition
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.sim import DELETED, Store

CONTROLLER_NAME = "kueue.x-k8s.io/multikueue"
ORIGIN_LABEL = "kueue.x-k8s.io/multikueue-origin"


class MultiKueueAdapter:
    """Per-job-kind remote sync (reference: jobframework.MultiKueueAdapter,
    interface.go:160-196)."""

    KIND = ""

    def sync_job(self, local_store: Store, remote_store: Store,
                 wl: api.Workload, origin: str) -> None:
        """Create/refresh the remote job object and copy its status back."""

    def delete_remote(self, remote_store: Store, namespace: str, name: str) -> None:
        pass

    def keep_admission_check_pending(self) -> bool:
        """reference: KeepAdmissionCheckPending — batch Jobs run remotely
        while the local check stays Pending (managedBy gate absent)."""
        return False


class BatchJobAdapter(MultiKueueAdapter):
    KIND = "Job"

    def sync_job(self, local_store, remote_store, wl, origin):
        owner = next((o for o in wl.metadata.owner_references
                      if o.controller and o.kind == "Job"), None)
        if owner is None:
            return
        local_job = local_store.try_get("Job", wl.metadata.namespace, owner.name)
        if local_job is None:
            return
        remote_job = remote_store.try_get("Job", wl.metadata.namespace, owner.name)
        if remote_job is None:
            clone = copy.deepcopy(local_job)
            clone.metadata.resource_version = 0
            clone.metadata.uid = ""
            clone.metadata.labels[ORIGIN_LABEL] = origin
            # bind the remote job to the mirrored Workload so the worker's
            # jobframework doesn't construct a duplicate (reference:
            # job_multikueue_adapter.go sets the prebuilt-workload label)
            clone.metadata.labels[api.PREBUILT_WORKLOAD_LABEL] = wl.metadata.name
            remote_store.create(clone)
            return
        # copy remote status back to the local job (reference:
        # job_multikueue_adapter.go SyncJob)
        if remote_job.status != local_job.status:
            local_job.status = remote_job.status
            local_store.update(local_job)

    def delete_remote(self, remote_store, namespace, name):
        try:
            remote_store.delete("Job", namespace, name)
        except KeyError:
            pass


ADAPTERS = {"Job": BatchJobAdapter()}


def _remote_available(cache) -> dict:
    """{(flavor, resource): available} across a worker cluster's CQs:
    nominal minus usage, clamped at zero, summed per flavor-resource —
    the capacity envelope one column of the batched placement solve
    offers. Reads under the remote cache's lock (worker managers never
    lock back into the local one, so the order is acyclic)."""
    caps: dict = {}
    with cache._lock:
        for cqc in cache.hm.cluster_queues.values():
            rn = cqc.resource_node
            for fr, quota in rn.quotas.items():
                avail = quota.nominal - rn.usage.get(fr, 0)
                if avail > 0:
                    key = (fr.flavor, fr.resource)
                    caps[key] = caps.get(key, 0) + avail
    return caps


class MultiKueueController:
    def __init__(self, store: Store, recorder, clock,
                 remote_clusters: Optional[dict] = None,
                 origin: str = "multikueue",
                 worker_lost_timeout: float = 15 * 60.0):
        self.store = store
        self.recorder = recorder
        self.clock = clock
        # cluster name -> remote Store (or KueueManager, resolved below)
        self.remote_clusters = remote_clusters if remote_clusters is not None else {}
        self.origin = origin
        self.worker_lost_timeout = worker_lost_timeout
        self._lost_since: dict = {}  # wl key -> first-noticed-lost time
        # Activity probe (reference: multikueuecluster.go connection
        # monitor): clusters marked lost are unreachable — excluded from
        # placement, mirror deletion and orphan GC — until rejoined.
        # Scenario scripts and (eventually) a real connection prober
        # flip these; the sim's "worker cluster loss" failure mode
        # is exercised through exactly this surface.
        self.lost_clusters: set = set()
        # wl key -> cluster the Ready check recorded. Placement is
        # sticky: on reconcile the recorded cluster is probed FIRST, so
        # a lost cluster rejoining with a stale reserved mirror cannot
        # steal the workload back from its re-placement (the stale
        # mirror is deleted by the first-wins branch instead) — the
        # no-double-dispatch invariant under cluster loss/rejoin.
        self._reserving: dict = {}
        # wl key -> cluster the BATCHED solve chose: the admission
        # cycle scores remote clusters as capacity columns
        # (kernel.score_cluster_columns, K12 on the card / the
        # scheduler's host oracle) and forwards decisions here via note_placement. A
        # planned workload mirrors ONLY to its chosen cluster — this
        # controller becomes the executor of device-made decisions
        # instead of racing mirrors across the fleet per workload.
        # Un-planned workloads keep the reference's mirror-to-all race.
        self.planned: dict = {}
        self._planned_at: dict = {}    # wl key -> decision time (staleness)
        self.placements_planned = 0    # decisions received
        self.placements_executed = 0   # single-cluster mirrors performed
        self.placements_expired = 0    # plans dropped to the mirror race
        # Optional obs JourneyLedger (manager wiring): the planned-
        # mirror lifecycle stamps mk-planned/executed/expired spans —
        # with the cluster name — onto the workload's journey, so
        # cross-cluster placement stays causal in the timeline.
        self.journeys = None
        self._ctrl = None  # workqueue handle, set by setup_*

    def _remote_store(self, cluster_name: str) -> Optional[Store]:
        if cluster_name in self.lost_clusters:
            return None  # unreachable: no reads, writes, or deletes
        remote = self.remote_clusters.get(cluster_name)
        if remote is None:
            return None
        return remote.store if hasattr(remote, "store") else remote

    def cluster_active(self, cluster_name: str) -> bool:
        return self._remote_store(cluster_name) is not None \
            and self.store.try_get("MultiKueueCluster", "", cluster_name) is not None

    # -- activity probe (cluster loss / rejoin) -------------------------

    def mark_cluster_lost(self, cluster_name: str) -> None:
        """The worker became unreachable (connection probe failure):
        exclude it everywhere and re-reconcile so workloads reserved
        there start their worker-lost timeout."""
        if cluster_name in self.lost_clusters:
            return
        self.lost_clusters.add(cluster_name)
        self.recorder.system_event(
            "Warning", "MultiKueueClusterLost",
            f'worker cluster "{cluster_name}" is unreachable')
        self._requeue_all()

    def mark_cluster_rejoined(self, cluster_name: str) -> None:
        """The worker is reachable again: re-reconcile so stale mirrors
        left from before the loss are cleaned up (sticky placement keeps
        re-placed workloads where they landed) and the cluster returns
        to the placement set."""
        if cluster_name not in self.lost_clusters:
            return
        self.lost_clusters.discard(cluster_name)
        self.recorder.system_event(
            "Normal", "MultiKueueClusterRejoined",
            f'worker cluster "{cluster_name}" rejoined')
        self._requeue_all()

    def _requeue_all(self) -> None:
        """Re-enqueue every local workload (reference: the cluster
        connection watcher queues all workloads on connect/disconnect,
        multikueuecluster.go:187-253). Non-multikueue workloads no-op
        in reconcile."""
        if self._ctrl is None:
            return
        for wl in self.store.list("Workload", copy_objects=False):
            self._ctrl.enqueue(wlpkg.key(wl))

    # -- batched placement (capacity columns of the solve) ---------------

    def note_placement(self, wl_key: str, cluster_name: str) -> None:
        """Record a solve-made placement decision (scheduler hook). The
        next reconcile of this workload mirrors only to the chosen
        cluster. Idempotent; later decisions overwrite earlier ones
        (a re-placed workload after cluster loss gets a fresh choice)."""
        self.planned[wl_key] = cluster_name
        self._planned_at[wl_key] = self.clock.now()
        self.placements_planned += 1
        if self.journeys is not None:
            self.journeys.mk_event(wl_key, "planned", cluster_name)
        if self._ctrl is not None:
            self._ctrl.enqueue(wl_key)

    def capacity_columns(self) -> tuple:
        """(columns, mk_check_names) for Cache snapshot stamping:
        columns is an ordered tuple of
        (cluster_name, {(flavor, resource): available}, active) in
        sorted-name order — the scoring order the batched solve, the
        host oracle and the planned-mirror path all share. Lost or
        unregistered clusters stamp active=False with NO capacity: the
        column masks to zero on the next snapshot, so re-placement of
        their workloads falls out of the next cycle's scoring.

        In-flight debit: a plan the remote has not RESERVED yet is
        capacity the remote usage read can't see (the mirror is still
        queueing there), so its request is consumed from the columns
        via the shared placement rule — without this, consecutive
        cycles would pile every head onto the same already-chosen
        cluster while its siblings sit idle."""
        cols = []
        for name in sorted(self.remote_clusters):
            active = self.cluster_active(name)
            caps: dict = {}
            remote = self.remote_clusters.get(name)
            cache = getattr(remote, "cache", None)
            if active and cache is not None:
                caps = _remote_available(cache)
            cols.append((name, caps, active))
        cols = tuple(cols)
        reqs, pinned = [], []
        covers_pods_memo: dict = {}
        # list(): reconcile pops plans concurrently in threaded
        # deployments — a mid-iteration mutation must not tear the
        # whole stamp down to "no columns this cycle".
        for key, cluster in list(self.planned.items()):
            if self._reserving.get(key) is not None:
                # Reserved ANYWHERE: the remote usage read covers it
                # (and if it reserved off-plan, debiting the planned
                # column would be wrong — reconcile drops such plans).
                continue
            namespace, wname = key.split("/", 1)
            wl = self.store.try_get("Workload", namespace, wname)
            if wl is None or not wlpkg.has_quota_reservation(wl):
                continue
            info = wlpkg.Info(wl)
            # the debit must consume the SAME request vector the
            # placement scored (wlpkg.mk_request_vector is the one
            # shared fold): pods included when the local CQ covers it
            covers = covers_pods_memo.get(info.cluster_queue)
            if covers is None:
                cq = self.store.try_get("ClusterQueue", "",
                                        info.cluster_queue)
                covers = cq is not None and any(
                    RESOURCE_PODS in rg.covered_resources
                    for rg in cq.spec.resource_groups)
                covers_pods_memo[info.cluster_queue] = covers
            reqs.append(wlpkg.mk_request_vector(info, covers))
            pinned.append(cluster)
        if reqs:
            from kueue_tpu_torch.solver.encode import consume_remote_dicts
            cols = consume_remote_dicts(cols, reqs, pinned)
        checks = frozenset(
            ac.metadata.name
            for ac in self.store.list("AdmissionCheck", copy_objects=False)
            if ac.spec.controller_name == CONTROLLER_NAME)
        return cols, checks

    # -- check/config resolution ----------------------------------------

    def _check_for(self, wl: api.Workload) -> Optional[str]:
        for state in wl.status.admission_checks:
            ac = self.store.try_get("AdmissionCheck", "", state.name)
            if ac is not None and ac.spec.controller_name == CONTROLLER_NAME:
                return state.name
        return None

    def _clusters_for_check(self, check_name: str) -> list:
        ac = self.store.try_get("AdmissionCheck", "", check_name)
        if ac is None or ac.spec.parameters is None:
            return []
        config = self.store.try_get("MultiKueueConfig", "", ac.spec.parameters.name)
        if config is None:
            return []
        return [c for c in config.spec.clusters if self.cluster_active(c)]

    # -- reconcile ------------------------------------------------------

    def reconcile(self, key: str):
        namespace, name = key.split("/", 1)
        wl = self.store.try_get("Workload", namespace, name)
        if wl is None:
            self._gc_remotes(namespace, name)
            return None
        check_name = self._check_for(wl)
        if check_name is None:
            return None
        now = self.clock.now()
        state = wlpkg.find_admission_check(wl, check_name)

        if wlpkg.is_finished(wl):
            self._gc_remotes(namespace, name)
            return None
        if not wlpkg.has_quota_reservation(wl):
            self._gc_remotes(namespace, name)
            return None

        clusters = self._clusters_for_check(check_name)
        reserving = None
        # Sticky placement: probe the recorded reserving cluster first,
        # so a rejoined cluster holding a stale reserved mirror cannot
        # out-rank the workload's current placement (no double
        # dispatch; the stale mirror is GC'd below instead). The
        # solve-planned cluster probes next — with a planned single
        # mirror it is the only cluster that can be reserving anyway.
        recorded = self._reserving.get(wlpkg.key(wl))
        planned = self.planned.get(wlpkg.key(wl))
        head = [c for c in (recorded, planned) if c in clusters]
        ordered = head + [c for c in clusters if c not in head] \
            if head else clusters
        for cluster in ordered:
            remote = self._remote_store(cluster)
            if remote is None:
                continue  # lost: unreachable, cannot be observed reserving
            remote_wl = remote.try_get("Workload", namespace, name)
            if remote_wl is not None and wlpkg.has_quota_reservation(remote_wl):
                reserving = cluster
                break

        if reserving is None and state is not None \
                and state.state == api.CHECK_STATE_READY:
            # the reserving worker vanished (reference: wlReconciler
            # workerLostTimeout, workload.go:380-420)
            first = self._lost_since.setdefault(wlpkg.key(wl), now)
            remaining = self.worker_lost_timeout - (now - first)
            if remaining > 0:
                return float(remaining)
            self._lost_since.pop(wlpkg.key(wl), None)
            self._reserving.pop(wlpkg.key(wl), None)
            # the plan died with the worker: the next admission cycle
            # re-scores the workload against the masked columns
            self.planned.pop(wlpkg.key(wl), None)
            self._planned_at.pop(wlpkg.key(wl), None)
            wlpkg.set_admission_check_state(
                wl.status.admission_checks,
                api.AdmissionCheckState(
                    name=check_name, state=api.CHECK_STATE_RETRY,
                    message="Reserving remote lost"), now)
            self.store.update(wl)
            return None
        self._lost_since.pop(wlpkg.key(wl), None)

        if reserving is not None:
            self._reserving[wlpkg.key(wl)] = reserving
            if self.planned.get(wlpkg.key(wl)) not in (None, reserving):
                # Reality disagrees with the plan (the planned cluster
                # was lost and the mirror race placed elsewhere): drop
                # the stale plan, or capacity_columns would debit the
                # planned cluster's column for this workload's whole
                # lifetime.
                self.planned.pop(wlpkg.key(wl), None)
                self._planned_at.pop(wlpkg.key(wl), None)
            # first reservation wins: drop the other mirrors and their jobs
            adapter = self._adapter_for(wl)
            owner = next((o for o in wl.metadata.owner_references
                          if o.controller), None)
            for cluster in clusters:
                if cluster != reserving:
                    self._delete_mirror(cluster, namespace, name)
                    other = self._remote_store(cluster)
                    if adapter is not None and owner is not None \
                            and other is not None:
                        adapter.delete_remote(other, namespace, owner.name)
            remote = self._remote_store(reserving)
            remote_wl = remote.try_get("Workload", namespace, name)
            # copy the remote Finished condition back
            if remote_wl is not None and wlpkg.is_finished(remote_wl):
                fin = find_condition(remote_wl.status.conditions,
                                     api.WORKLOAD_FINISHED)
                set_condition(wl.status.conditions, copy.deepcopy(fin), now)
                self.store.update(wl)
                return None
            if adapter is not None:
                adapter.sync_job(self.store, remote, wl, self.origin)
            if state is not None and state.state != api.CHECK_STATE_READY:
                wlpkg.set_admission_check_state(
                    wl.status.admission_checks,
                    api.AdmissionCheckState(
                        name=check_name, state=api.CHECK_STATE_READY,
                        message=f'The workload got reservation on "{reserving}"'),
                    now)
                self.store.update(wl)
            return None

        # No remote reservation yet: with a solve-planned placement,
        # mirror ONLY to the chosen cluster — the per-workload
        # mirror-everywhere race (and its K-1 mirror deletions on the
        # win) leaves the admission hot path. A plan naming a cluster
        # that is currently lost/inactive falls back to the reference's
        # mirror-to-all race until the next cycle re-scores the
        # workload against the masked columns. Starvation bound: a plan
        # whose cluster never reserves within the worker-lost timeout
        # (wedged remote, capacity the scoring over-estimated) EXPIRES
        # back to the race — the planned path can delay cross-cluster
        # placement, never strand it.
        targets = clusters
        single_mirror = False
        requeue_after = None
        if planned is not None and planned in clusters:
            age = now - self._planned_at.get(wlpkg.key(wl), now)
            if age > self.worker_lost_timeout:
                self.planned.pop(wlpkg.key(wl), None)
                self._planned_at.pop(wlpkg.key(wl), None)
                self.placements_expired += 1
                if self.journeys is not None:
                    self.journeys.mk_event(wlpkg.key(wl), "expired",
                                           planned)
            else:
                targets = [planned]
                single_mirror = True
                # Schedule the expiry check: a planned cluster that
                # never reserves produces NO watch events, so without a
                # timed requeue the age gate above could never fire and
                # the workload would strand on one pending mirror —
                # the bounded-starvation contract needs the timer.
                requeue_after = float(self.worker_lost_timeout - age) + 1.0
        for cluster in targets:
            remote = self._remote_store(cluster)
            if remote is None:
                continue  # lost: mirrored on rejoin via _requeue_all
            if remote.try_get("Workload", namespace, name) is None:
                from kueue_tpu_torch.sim import AlreadyExists
                clone = self._clone_for_remote(wl)
                try:
                    remote.create(clone)
                    if single_mirror:
                        # counted per mirror actually CREATED on the
                        # planned cluster — re-reconciles of an
                        # existing mirror don't inflate the surface
                        self.placements_executed += 1
                        if self.journeys is not None:
                            self.journeys.mk_event(wlpkg.key(wl),
                                                   "executed", cluster)
                except AlreadyExists:
                    pass
            adapter = self._adapter_for(wl)
            if adapter is not None:
                adapter.sync_job(self.store, remote, wl, self.origin)
        return requeue_after

    def _adapter_for(self, wl: api.Workload) -> Optional[MultiKueueAdapter]:
        owner = next((o for o in wl.metadata.owner_references if o.controller), None)
        if owner is None:
            return None
        return ADAPTERS.get(owner.kind)

    def _clone_for_remote(self, wl: api.Workload) -> api.Workload:
        clone = copy.deepcopy(wl)
        clone.metadata.resource_version = 0
        clone.metadata.uid = ""
        clone.metadata.labels[ORIGIN_LABEL] = self.origin
        clone.metadata.owner_references = []
        clone.metadata.finalizers = []
        clone.status = api.WorkloadStatus()
        return clone

    def _delete_mirror(self, cluster: str, namespace: str, name: str) -> None:
        remote = self._remote_store(cluster)
        if remote is None:
            return
        remote_wl = remote.try_get("Workload", namespace, name)
        if remote_wl is None:
            return
        if remote_wl.metadata.labels.get(ORIGIN_LABEL) != self.origin:
            return  # not ours
        if remote_wl.metadata.finalizers:
            remote_wl.metadata.finalizers = []
            remote.update(remote_wl)
        try:
            remote.delete("Workload", namespace, name)
        except KeyError:
            pass

    def _gc_remotes(self, namespace: str, name: str) -> None:
        """Remote orphan GC (reference: multikueuecluster.go:255-305).
        Lost clusters are skipped (unreachable); their stale mirrors
        are collected by the periodic gc_orphans pass after rejoin."""
        self._reserving.pop(f"{namespace}/{name}", None)
        self.planned.pop(f"{namespace}/{name}", None)
        self._planned_at.pop(f"{namespace}/{name}", None)
        for cluster in list(self.remote_clusters):
            self._delete_mirror(cluster, namespace, name)

    def gc_orphans(self) -> int:
        """Periodic GC: remote workloads whose local original is gone
        (reference: GC interval, config multiKueue.gcInterval). Runs on
        the manager's runtime timer every multiKueue.gcInterval seconds;
        lost clusters are skipped until they rejoin."""
        removed = 0
        for cluster in list(self.remote_clusters):
            remote = self._remote_store(cluster)
            if remote is None:
                continue
            for remote_wl in remote.list(
                    "Workload", copy_objects=False,
                    where=lambda w: w.metadata.labels.get(ORIGIN_LABEL) == self.origin):
                local = self.store.try_get(
                    "Workload", remote_wl.metadata.namespace, remote_wl.metadata.name)
                if local is None:
                    self._delete_mirror(cluster, remote_wl.metadata.namespace,
                                        remote_wl.metadata.name)
                    removed += 1
        return removed


def setup_multikueue_controller(runtime, store: Store, recorder,
                                remote_clusters: Optional[dict] = None,
                                **kwargs) -> MultiKueueController:
    controller = MultiKueueController(store, recorder, runtime.clock,
                                      remote_clusters=remote_clusters, **kwargs)
    ctrl = runtime.controller("multikueue", controller.reconcile)
    controller._ctrl = ctrl

    def on_workload(event, wl, old):
        ctrl.enqueue(wlpkg.key(wl))

    store.watch("Workload", on_workload)

    # remote workload/job transitions re-trigger the local reconcile
    # (reference: watch fan-in channels, multikueuecluster.go:187-253)
    def watch_remote(cluster_name: str) -> None:
        remote = controller._remote_store(cluster_name)
        if remote is None:
            return
        def on_remote(event, obj, old):
            ctrl.enqueue(f"{obj.metadata.namespace}/{obj.metadata.name}")
        remote.watch("Workload", on_remote)

    controller.watch_remote = watch_remote
    for cluster_name in (remote_clusters or {}):
        watch_remote(cluster_name)
    return controller
