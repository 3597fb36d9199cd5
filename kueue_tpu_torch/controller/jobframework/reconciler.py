"""JobReconciler: the job <-> workload state machine.

Equivalent of the reference's pkg/controller/jobframework/reconciler.go:204-1000:
- ensureOneWorkload: 1:1 job->Workload with dedup + equivalence checks,
  prebuilt-workload support (:563-665)
- constructWorkload + priority resolution
  (WorkloadPriorityClass > job > pod PriorityClass, :879-962)
- startJob: inject PodSetInfo from the admission + admission-check
  podSetUpdates, unsuspend (:798-821, :964-1000)
- stopJob: suspend + restore pod templates, custom/composable stop
  (:823-866)
- eviction handling: stop, then once inactive clear the quota
  reservation and set Requeued (:435-455)
- PodsReady condition sync, reclaimable-pod propagation, finished
  propagation, parent-workload gating for owned jobs (:268-315)

One deviation, by design: the sim store has no ownerRef garbage
collector, so when a job disappears this reconciler deletes its child
workloads (the reference only strips finalizers and lets k8s GC
collect).
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import Condition, OwnerReference, find_condition, set_condition
from kueue_tpu_torch.core import podset as podsetpkg
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.controller.jobframework.interface import (
    ComposableJob,
    GenericJob,
    STOP_REASON_NOT_ADMITTED,
    STOP_REASON_NO_MATCHING_WORKLOAD,
    STOP_REASON_WORKLOAD_DELETED,
    STOP_REASON_WORKLOAD_EVICTED,
)
from kueue_tpu_torch.controller.jobframework.workload_names import workload_name_for_owner

JOB_UID_LABEL = "kueue.x-k8s.io/job-uid"
FAILED_TO_START_REASON = "FailedToStart"
FINISHED_SUCCEEDED = "Succeeded"
FINISHED_FAILED = "Failed"


def queue_name(job: GenericJob) -> str:
    """The queue-name label on the job (reference: QueueNameForObject)."""
    return job.object().metadata.labels.get(api.QUEUE_LABEL, "")


def prebuilt_workload_for(job: GenericJob) -> Optional[str]:
    return job.object().metadata.labels.get(api.PREBUILT_WORKLOAD_LABEL)


def workload_priority_class_name(job: GenericJob) -> str:
    return job.object().metadata.labels.get(api.PRIORITY_CLASS_LABEL, "")


def is_owner_managed_by_kueue(owner: OwnerReference) -> bool:
    from kueue_tpu_torch.controller.jobframework.interface import _registry
    return any(cb.kind == owner.kind for cb in _registry.values())


class JobReconciler:
    def __init__(self, store, recorder, clock, integration,
                 manage_jobs_without_queue_name: bool = False,
                 wait_for_pods_ready: bool = False,
                 label_keys_to_copy: Optional[list] = None):
        self.store = store
        self.recorder = recorder
        self.clock = clock
        self.integration = integration   # IntegrationCallbacks
        self.manage_jobs_without_queue_name = manage_jobs_without_queue_name
        self.wait_for_pods_ready = wait_for_pods_ready
        self.label_keys_to_copy = label_keys_to_copy or []

    # ------------------------------------------------------------------

    def reconcile(self, key: str):
        namespace, name = key.split("/", 1)
        if self.integration.composable:
            job = self.integration.new_job(None)
            drop_finalizers, found = job.load(self.store, namespace, name)
            obj = job.object() if found else None
            if obj is None:
                job_for_cleanup = job
                if drop_finalizers:
                    return self._drop_finalizers(job_for_cleanup, namespace, name)
                return None
        else:
            obj = self.store.try_get(self.integration.kind, namespace, name)
            job = self.integration.new_job(obj) if obj is not None else None
            drop_finalizers = obj is None or obj.metadata.deletion_timestamp is not None

        if job is not None and hasattr(job, "skip") and job.skip():
            return None

        if drop_finalizers:
            return self._drop_finalizers(job, namespace, name)

        # ownership: child jobs are gated on their parent's workload
        # (reference: :268-315)
        owner = next((o for o in obj.metadata.owner_references if o.controller), None)
        standalone = owner is None or not is_owner_managed_by_kueue(owner)

        if not self.manage_jobs_without_queue_name and not queue_name(job):
            if standalone:
                return None
            if not self._parent_job_managed(owner, namespace):
                return None

        if not standalone:
            _, _, finished = job.finished()
            if not finished and not job.is_suspended():
                parent_wl = self._parent_workload(owner, namespace)
                if parent_wl is None or not wlpkg.is_admitted(parent_wl):
                    job.suspend()
                    self.store.update(job.object())
                    self.recorder.event(obj, "Normal", "Suspended",
                                        "Kueue managed child job suspended")
            return None

        # 1. single-workload invariant
        wl = self._ensure_one_workload(job, obj)

        if wl is not None and wlpkg.is_finished(wl):
            self._finalize_job(job)
            self.recorder.event(obj, "Normal", "FinishedWorkload",
                                f"Workload '{wlpkg.key(wl)}' is declared finished")
            self._remove_workload_finalizer(wl)
            return None

        # 1.1 workload pending deletion
        if wl is not None and wl.metadata.deletion_timestamp is not None:
            self._stop_job(job, wl, STOP_REASON_WORKLOAD_DELETED, "Workload is deleted")
            self._remove_workload_finalizer(wl)
            return None

        # 2. job finished -> propagate Finished condition
        message, success, finished = job.finished()
        if finished:
            if wl is not None and not wlpkg.is_finished(wl):
                set_condition(wl.status.conditions, Condition(
                    type=api.WORKLOAD_FINISHED, status="True",
                    reason=FINISHED_SUCCEEDED if success else FINISHED_FAILED,
                    message=message,
                    observed_generation=wl.metadata.generation), self.clock.now())
                self.store.update(wl)
                self.recorder.event(obj, "Normal", "FinishedWorkload",
                                    f"Workload '{wlpkg.key(wl)}' is declared finished")
            self._finalize_job(job)
            return None

        # 3. no workload yet
        if wl is None:
            return self._handle_job_with_no_workload(job, obj)

        # 4. reclaimable pods
        if hasattr(job, "reclaimable_pods"):
            recl = job.reclaimable_pods()
            if _reclaimable_as_dict(recl) != _reclaimable_as_dict(wl.status.reclaimable_pods):
                wl.status.reclaimable_pods = recl
                self.store.update(wl)
                return None

        # 5. PodsReady condition
        if self.wait_for_pods_ready:
            cond = self._pods_ready_condition(job, wl)
            existing = find_condition(wl.status.conditions, api.WORKLOAD_PODS_READY)
            if existing is None or existing.status != cond.status:
                set_condition(wl.status.conditions, cond, self.clock.now())
                self.store.update(wl)

        # 6. eviction
        ev = find_condition(wl.status.conditions, api.WORKLOAD_EVICTED)
        if ev is not None and ev.status == "True":
            self._stop_job(job, wl, STOP_REASON_WORKLOAD_EVICTED, ev.message)
            if wlpkg.has_quota_reservation(wl) and not job.is_active():
                # Requeued=True immediately only for preemption/check
                # evictions; other reasons wait for their own trigger
                # (reference: :443-449)
                set_requeued = ev.reason in (api.EVICTED_BY_PREEMPTION,
                                             api.EVICTED_BY_ADMISSION_CHECK)
                wlpkg.set_requeued_condition(wl, ev.reason, ev.message,
                                             set_requeued, self.clock.now())
                wlpkg.unset_quota_reservation_with_condition(
                    wl, "Pending", ev.message, self.clock.now())
                self.store.update(wl)
            return None

        # 7. suspended
        if job.is_suspended():
            if wlpkg.is_admitted(wl):
                return self._start_job(job, obj, wl)
            q = queue_name(job)
            if wl.spec.queue_name != q:
                wl.spec.queue_name = q
                self.store.update(wl)
            return None

        # 8. unsuspended but not admitted
        if not wlpkg.is_admitted(wl):
            self._stop_job(job, wl, STOP_REASON_NOT_ADMITTED,
                           "Not admitted by cluster queue")
        return None

    # -- helpers --------------------------------------------------------

    def _drop_finalizers(self, job, namespace: str, name: str):
        """Sim plays the k8s GC role: orphaned child workloads are deleted."""
        if job is not None and isinstance(job, ComposableJob):
            children = job.list_child_workloads(self.store)
        else:
            children = self._child_workloads(namespace, name)
        for wl in children:
            if api.RESOURCE_IN_USE_FINALIZER in wl.metadata.finalizers:
                wl.metadata.finalizers.remove(api.RESOURCE_IN_USE_FINALIZER)
                self.store.update(wl)
            try:
                self.store.delete("Workload", wl.metadata.namespace, wl.metadata.name)
            except KeyError:
                pass
        if job is not None:
            self._finalize_job(job)
        return None

    def _child_workloads(self, namespace: str, owner_name: str) -> list:
        kind = self.integration.kind
        return self.store.list(
            "Workload", namespace=namespace,
            where=lambda wl: any(o.controller and o.kind == kind and o.name == owner_name
                                 for o in wl.metadata.owner_references))

    def _parent_workload(self, owner: OwnerReference, namespace: str):
        wl_name = workload_name_for_owner(owner.name, owner.uid, owner.kind.lower())
        for wl in self.store.list("Workload", namespace=namespace):
            if any(o.controller and o.name == owner.name and o.kind == owner.kind
                   for o in wl.metadata.owner_references):
                return wl
        return None

    def _parent_job_managed(self, owner: OwnerReference, namespace: str) -> bool:
        from kueue_tpu_torch.controller.jobframework.interface import _registry
        for cb in _registry.values():
            if cb.kind == owner.kind:
                parent = self.store.try_get(cb.kind, namespace, owner.name)
                if parent is not None and parent.metadata.labels.get(api.QUEUE_LABEL):
                    return True
        return False

    # -- ensureOneWorkload (reference: :563-665) ------------------------

    def _ensure_one_workload(self, job: GenericJob, obj):
        prebuilt = prebuilt_workload_for(job)
        if prebuilt is not None:
            wl = self.store.try_get("Workload", obj.metadata.namespace, prebuilt)
            if wl is None:
                return None
            if not self._ensure_prebuilt_ownership(wl, obj):
                return None
            if not self._prebuilt_in_sync(wl, job):
                # out-of-sync prebuilt workload: stop & deactivate
                # (reference: ensurePrebuiltWorkloadInSync -> Stop)
                self._stop_job(job, wl, STOP_REASON_NO_MATCHING_WORKLOAD,
                               "The prebuilt workload is out of sync with the job")
                return None
            return wl

        if isinstance(job, ComposableJob):
            match, to_delete = job.find_matching_workloads(self.store, self.recorder)
        else:
            match, to_delete = self._find_matching_workloads(job, obj)

        to_update = None
        if (match is None and to_delete and job.is_suspended()
                and not wlpkg.has_quota_reservation(to_delete[0])):
            to_update = to_delete[0]
            to_delete = to_delete[1:]

        if match is None and not job.is_suspended():
            w = to_delete[0] if len(to_delete) == 1 else None
            _, _, finished = job.finished()
            if not finished:
                msg = ("Missing Workload; unable to restore pod templates" if w is None
                       else "No matching Workload; restoring pod templates "
                            "according to existent Workload")
                self._stop_job(job, w, STOP_REASON_NO_MATCHING_WORKLOAD, msg)

        for wl in to_delete:
            self._remove_workload_finalizer(wl)
            try:
                self.store.delete("Workload", wl.metadata.namespace, wl.metadata.name)
                self.recorder.event(obj, "Normal", "DeletedWorkload",
                                    f"Deleted not matching Workload: {wlpkg.key(wl)}")
            except KeyError:
                pass

        if to_update is not None:
            return self._update_workload_to_match(job, obj, to_update)
        return match

    def _find_matching_workloads(self, job: GenericJob, obj):
        match = None
        to_delete = []
        for wl in self._child_workloads(obj.metadata.namespace, obj.metadata.name):
            if match is None and self._equivalent_to_workload(job, wl):
                match = wl
            else:
                to_delete.append(wl)
        return match, to_delete

    def _equivalent_to_workload(self, job: GenericJob, wl: api.Workload) -> bool:
        """reference: equivalentToWorkload (:753-777)."""
        job_podsets = job.pod_sets()
        running = self._expected_running_pod_sets(wl)
        if running is not None:
            if _compare_podsets(job_podsets, running, wlpkg.is_admitted(wl)):
                return True
            return job.is_suspended() and _compare_podsets(
                job_podsets, wl.spec.pod_sets, wlpkg.is_admitted(wl))
        return _compare_podsets(job_podsets, wl.spec.pod_sets, wlpkg.is_admitted(wl))

    def _expected_running_pod_sets(self, wl: api.Workload):
        """The pod sets as they look with admission info injected
        (reference: expectedRunningPodSets :724-751)."""
        if not wlpkg.has_quota_reservation(wl):
            return None
        try:
            infos = self._podsets_info_from_status(wl)
        except podsetpkg.PermanentError:
            return None
        info_map = {i.name: i for i in infos}
        out = []
        partial_ok = any(ps.min_count is not None for ps in wl.spec.pod_sets)
        for ps in wl.spec.pod_sets:
            info = info_map.get(ps.name)
            if info is None:
                return None
            clone = api.PodSet(name=ps.name, count=ps.count, min_count=ps.min_count,
                               template=_copy_template(ps.template))
            try:
                podsetpkg.merge_into_template(clone.template, info)
            except podsetpkg.PermanentError:
                return None
            if partial_ok and ps.min_count is not None:
                clone.count = info.count
            out.append(clone)
        return out

    def _update_workload_to_match(self, job: GenericJob, obj, wl: api.Workload):
        new_wl = self._construct_workload(job, obj)
        self._prepare_workload(job, new_wl)
        wl.spec = new_wl.spec
        self.store.update(wl)
        self.recorder.event(obj, "Normal", "UpdatedWorkload",
                            f"Updated not matching Workload for suspended job: "
                            f"{wlpkg.key(wl)}")
        return wl

    def _ensure_prebuilt_ownership(self, wl: api.Workload, obj) -> bool:
        if any(o.controller and o.uid == obj.metadata.uid
               for o in wl.metadata.owner_references):
            return True
        if any(o.controller for o in wl.metadata.owner_references):
            return False  # controlled by someone else
        wl.metadata.owner_references.append(OwnerReference(
            kind=self.integration.kind, name=obj.metadata.name,
            uid=obj.metadata.uid, controller=True))
        wl.metadata.labels[JOB_UID_LABEL] = obj.metadata.uid
        self.store.update(wl)
        return True

    def _prebuilt_in_sync(self, wl: api.Workload, job: GenericJob) -> bool:
        return self._equivalent_to_workload(job, wl)

    # -- construct / start / stop ---------------------------------------

    def _handle_job_with_no_workload(self, job: GenericJob, obj):
        if prebuilt_workload_for(job) is not None:
            self._stop_job(job, None, STOP_REASON_NO_MATCHING_WORKLOAD,
                           "missing workload")
            return None
        # wait for the job's pods to terminate before re-creating
        # (reference: handleJobWithNoWorkload waits on IsActive)
        if not job.is_suspended() and job.is_active():
            return 1.0
        if isinstance(job, ComposableJob):
            wl = job.construct_composable_workload(self.store, self.recorder)
            if wl is None:
                return None
        else:
            wl = self._construct_workload(job, obj)
        self._prepare_workload(job, wl)
        from kueue_tpu_torch.sim import AlreadyExists, Invalid
        try:
            self.store.create(wl)
        except AlreadyExists:
            return True  # lost a race -> immediate retry
        except Invalid as exc:
            # webhook rejection: retrying won't change the outcome
            # (reference: unretryable error handling, reconciler.go:384-395)
            self.recorder.event(obj, "Warning", "FailedCreateWorkload", str(exc))
            return None
        self.recorder.event(obj, "Normal", "CreatedWorkload",
                            f"Created Workload: {wlpkg.key(wl)}")
        return None

    def _construct_workload(self, job: GenericJob, obj) -> api.Workload:
        from kueue_tpu_torch.api.meta import ObjectMeta
        wl = api.Workload(metadata=ObjectMeta(
            name=workload_name_for_owner(obj.metadata.name, obj.metadata.uid,
                                         job.gvk()),
            namespace=obj.metadata.namespace,
            labels={k: v for k, v in obj.metadata.labels.items()
                    if k in self.label_keys_to_copy},
            finalizers=[api.RESOURCE_IN_USE_FINALIZER],
            owner_references=[OwnerReference(
                kind=self.integration.kind, name=obj.metadata.name,
                uid=obj.metadata.uid, controller=True)]))
        wl.metadata.labels[JOB_UID_LABEL] = obj.metadata.uid
        wl.spec.pod_sets = job.pod_sets()
        wl.spec.queue_name = queue_name(job)
        return wl

    def _prepare_workload(self, job: GenericJob, wl: api.Workload) -> None:
        """Priority: WorkloadPriorityClass > job PriorityClass > pod
        PriorityClass (reference: :936-962)."""
        pod_pc = ""
        if hasattr(job, "priority_class"):
            pod_pc = job.priority_class()
        if not pod_pc:
            for ps in wl.spec.pod_sets:
                if ps.template.spec.priority_class_name:
                    pod_pc = ps.template.spec.priority_class_name
                    break
        wpcs = {w.metadata.name: w for w in self.store.list(
            "WorkloadPriorityClass", copy_objects=False)}
        pcs = {p.metadata.name: p for p in self.store.list(
            "PriorityClass", copy_objects=False)}
        source, name, value = prioritypkg.priority_from_classes(
            pod_pc, workload_priority_class_name(job), wpcs, pcs)
        wl.spec.priority_class_source = source
        wl.spec.priority_class_name = name
        wl.spec.priority = value

    def _podsets_info_from_status(self, wl: api.Workload) -> list:
        """reference: getPodSetsInfoFromStatus (:964-1000)."""
        if wl.status.admission is None:
            return []
        flavors = {rf.metadata.name: rf for rf in self.store.list(
            "ResourceFlavor", copy_objects=False)}
        counts = {ps.name: ps.count for ps in wl.spec.pod_sets}
        infos = []
        for psa in wl.status.admission.pod_set_assignments:
            info = podsetpkg.from_assignment(psa, flavors, counts.get(psa.name, 0))
            for check in wl.status.admission_checks:
                for update in check.pod_set_updates:
                    if update.name == info.name:
                        info = podsetpkg.merge(info, podsetpkg.from_update(update))
                        break
            infos.append(info)
        return infos

    def _start_job(self, job: GenericJob, obj, wl: api.Workload):
        try:
            infos = self._podsets_info_from_status(wl)
        except podsetpkg.PermanentError as exc:
            self._fail_workload_start(wl, str(exc))
            return None
        msg = f"Admitted by clusterQueue {wl.status.admission.cluster_queue}"
        if isinstance(job, ComposableJob):
            job.run(self.store, infos, self.recorder, msg)
            return None
        try:
            job.run_with_podsets_info(infos)
        except podsetpkg.PermanentError as exc:
            self._fail_workload_start(wl, str(exc))
            return None
        self.store.update(job.object())
        self.recorder.event(obj, "Normal", "Started", msg)
        return None

    def _fail_workload_start(self, wl: api.Workload, message: str) -> None:
        set_condition(wl.status.conditions, Condition(
            type=api.WORKLOAD_FINISHED, status="True",
            reason=FAILED_TO_START_REASON, message=message,
            observed_generation=wl.metadata.generation), self.clock.now())
        self.store.update(wl)

    def _stop_job(self, job: GenericJob, wl: Optional[api.Workload],
                  reason: str, msg: str) -> None:
        infos = _podsets_info_from_workload(wl)
        if isinstance(job, ComposableJob):
            stopped = job.stop(self.store, infos, reason, msg)
            for o in stopped:
                self.recorder.event(o, "Normal", "Stopped", msg)
            return
        if hasattr(job, "stop"):
            if job.stop(self.store, infos, reason, msg):
                self.recorder.event(job.object(), "Normal", "Stopped", msg)
            return
        if job.is_suspended():
            return
        job.suspend()
        if infos:
            job.restore_podsets_info(infos)
        self.store.update(job.object())
        self.recorder.event(job.object(), "Normal", "Stopped", msg)

    def _finalize_job(self, job: GenericJob) -> None:
        if hasattr(job, "finalize"):
            job.finalize(self.store)

    def _remove_workload_finalizer(self, wl: api.Workload) -> None:
        if api.RESOURCE_IN_USE_FINALIZER in wl.metadata.finalizers:
            wl.metadata.finalizers.remove(api.RESOURCE_IN_USE_FINALIZER)
            try:
                self.store.update(wl)
            except KeyError:
                pass

    def _pods_ready_condition(self, job: GenericJob, wl: api.Workload) -> Condition:
        if wlpkg.is_admitted(wl) and (job.is_suspended() or not job.pods_ready()):
            return Condition(type=api.WORKLOAD_PODS_READY, status="False",
                             reason="PodsReady", message="Not all pods are ready or succeeded",
                             observed_generation=wl.metadata.generation)
        return Condition(type=api.WORKLOAD_PODS_READY,
                         status="True" if wlpkg.is_admitted(wl) else "False",
                         reason="PodsReady",
                         message="All pods were ready or succeeded since the workload admission"
                         if wlpkg.is_admitted(wl) else "Not all pods are ready or succeeded",
                         observed_generation=wl.metadata.generation)


def _podsets_info_from_workload(wl: Optional[api.Workload]) -> list:
    """The restore-side info: the original pod templates recorded in the
    workload spec (reference: GetPodSetsInfoFromWorkload)."""
    if wl is None:
        return []
    return [podsetpkg.snapshot_template(ps.name, ps.count, ps.template)
            for ps in wl.spec.pod_sets]


def _reclaimable_as_dict(pods: list) -> dict:
    return {rp.name: rp.count for rp in pods}


def _compare_podsets(a: list, b: list, admitted: bool) -> bool:
    """equality.ComparePodSetSlices: counts may differ pre-admission only
    via reclaim; templates compared on the scheduling-relevant fields."""
    if len(a) != len(b):
        return False
    for ps_a, ps_b in zip(a, b):
        if ps_a.name != ps_b.name:
            return False
        if admitted:
            if ps_a.count < ps_b.count:
                return False
        elif ps_a.count != ps_b.count:
            return False
        sa, sb = ps_a.template.spec, ps_b.template.spec
        if [(_c.requests, _c.limits) for _c in sa.containers] != \
           [(_c.requests, _c.limits) for _c in sb.containers]:
            return False
    return True


def _copy_template(template):
    import copy
    return copy.deepcopy(template)
