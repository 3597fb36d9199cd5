"""Admission-time defaulting + validation for core types and jobs.

The port's copy of kueue_tpu/webhooks.py, with the same rules and the
same Invalid messages. Equivalent of the reference's pkg/webhooks (workload_webhook.go:333,
clusterqueue_webhook.go:231, resourceflavor_webhook.go:130) and the
per-job webhooks in pkg/controller/jobs/*/\\*_webhook.go (suspend
enforcement on create, queue-name immutability while unsuspended, pod
scheduling-gate injection — pod_webhook.go:180-190). All rules are pure
functions returning error-string lists; `setup_webhooks` installs them
as sim-store admission hooks so writes are rejected the way a real
webhook would.
"""

from __future__ import annotations

import re
from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.sim import Invalid, Store

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
MAX_PODSETS = 8
MAX_RESOURCE_GROUPS = 16
MAX_FLAVORS_PER_GROUP = 16
MAX_RESOURCES_PER_GROUP = 16


def _valid_name(name: str) -> bool:
    return bool(name) and len(name) <= 63 and _DNS1123.match(name) is not None


# ---------------------------------------------------------------------------
# Workload (reference: workload_webhook.go)
# ---------------------------------------------------------------------------

def default_workload(wl: api.Workload) -> None:
    """reference: WorkloadWebhook.Default (:57-75) — name the only
    podset "main"."""
    if len(wl.spec.pod_sets) == 1 and not wl.spec.pod_sets[0].name:
        wl.spec.pod_sets[0].name = api.DEFAULT_PODSET_NAME


def validate_workload(wl: api.Workload) -> list:
    errs = []
    variable_count = 0
    names = set()
    if not wl.spec.pod_sets:
        errs.append("spec.podSets: at least one podSet is required")
    if len(wl.spec.pod_sets) > MAX_PODSETS:
        errs.append(f"spec.podSets: must have at most {MAX_PODSETS} podSets")
    for i, ps in enumerate(wl.spec.pod_sets):
        path = f"spec.podSets[{i}]"
        if not _valid_name(ps.name):
            errs.append(f"{path}.name: invalid podSet name {ps.name!r}")
        if ps.name in names:
            errs.append(f"{path}.name: duplicate podSet name {ps.name!r}")
        names.add(ps.name)
        if ps.count < 0:
            errs.append(f"{path}.count: must be >= 0")
        if ps.min_count is not None:
            variable_count += 1
            if not (0 < ps.min_count <= ps.count):
                errs.append(f"{path}.minCount: must be in (0, count]")
        for c in ps.template.spec.containers + ps.template.spec.init_containers:
            if "pods" in c.requests:
                errs.append(f"{path}: the 'pods' resource is reserved for "
                            "internal kueue use")
    if variable_count > 1:
        errs.append("spec.podSets: at most one podSet can use minCount")
    if wlpkg.has_quota_reservation(wl):
        errs.extend(_validate_admission(wl))
    errs.extend(_validate_reclaimable(wl))
    return errs


def _validate_admission(wl: api.Workload) -> list:
    errs = []
    adm = wl.status.admission
    if adm is None:
        return ["status.admission: required once QuotaReserved"]
    ps_by_name = {ps.name: ps for ps in wl.spec.pod_sets}
    if {psa.name for psa in adm.pod_set_assignments} != set(ps_by_name):
        errs.append("status.admission.podSetAssignments: must have one "
                    "assignment per podSet")
        return errs
    for psa in adm.pod_set_assignments:
        ps = ps_by_name[psa.name]
        count = psa.count if psa.count is not None else ps.count
        for res, usage in psa.resource_usage.items():
            if count and usage % count != 0:
                # usage must be divisible by pod count (reference: :234)
                errs.append(
                    f"status.admission.podSetAssignments[{psa.name}]."
                    f"resourceUsage[{res}]: {usage} is not a multiple of {count}")
    return errs


def _validate_reclaimable(wl: api.Workload) -> list:
    errs = []
    counts = {ps.name: ps.count for ps in wl.spec.pod_sets}
    for rp in wl.status.reclaimable_pods:
        if rp.count < 0:
            errs.append(f"status.reclaimablePods[{rp.name}].count: must be >= 0")
        if rp.name not in counts:
            errs.append(f"status.reclaimablePods[{rp.name}]: no such podSet")
        elif rp.count > counts[rp.name]:
            errs.append(f"status.reclaimablePods[{rp.name}].count: should be "
                        f"less or equal to {counts[rp.name]}")
    return errs


def validate_workload_update(new: api.Workload, old: api.Workload) -> list:
    """reference: ValidateWorkloadUpdate (:269-287)."""
    errs = validate_workload(new)
    if wlpkg.has_quota_reservation(old) and \
            _podsets_shape(new.spec.pod_sets) != _podsets_shape(old.spec.pod_sets):
        errs.append("spec.podSets: field is immutable while quota is reserved")
    if (new.status.admission is not None and old.status.admission is not None
            and new.status.admission != old.status.admission):
        errs.append("status.admission: field is immutable; it can only be "
                    "set or unset")
    if wlpkg.has_quota_reservation(new) and wlpkg.has_quota_reservation(old):
        old_counts = {rp.name: rp.count for rp in old.status.reclaimable_pods}
        for rp in new.status.reclaimable_pods:
            floor = old_counts.get(rp.name, 0)
            if rp.count < floor:
                errs.append(f"status.reclaimablePods[{rp.name}].count: cannot "
                            f"be less than {floor}")
    return errs


def _podsets_shape(pod_sets: list) -> list:
    return [(ps.name, ps.count, ps.min_count) for ps in pod_sets]


# ---------------------------------------------------------------------------
# ClusterQueue (reference: clusterqueue_webhook.go)
# ---------------------------------------------------------------------------

def validate_cluster_queue(cq: api.ClusterQueue) -> list:
    errs = []
    spec = cq.spec
    if spec.cohort and not _valid_name(spec.cohort):
        errs.append(f"spec.cohort: invalid cohort name {spec.cohort!r}")
    if spec.queueing_strategy not in (api.STRICT_FIFO, api.BEST_EFFORT_FIFO):
        errs.append(f"spec.queueingStrategy: unsupported value "
                    f"{spec.queueing_strategy!r}")
    # reclaimWithinCohort=Never is incompatible with borrowWithinCohort
    # (reference: validatePreemption :121-129)
    p = spec.preemption
    if (p.reclaim_within_cohort == api.PREEMPTION_NEVER
            and p.borrow_within_cohort is not None
            and p.borrow_within_cohort.policy != api.BORROW_WITHIN_COHORT_NEVER):
        errs.append("spec.preemption: reclaimWithinCohort=Never and "
                    "borrowWithinCohort.Policy!=Never")
    # checks XOR strategy (reference: validateCQAdmissionChecks :131-138)
    if spec.admission_checks and spec.admission_checks_strategy:
        errs.append("spec: either admissionChecks or admissionChecksStrategy "
                    "can be set, but not both")
    errs.extend(_validate_resource_groups(spec))
    if spec.fair_sharing is not None and spec.fair_sharing.weight < 0:
        errs.append("spec.fairSharing.weight: must be >= 0")
    return errs


def _validate_resource_groups(spec: api.ClusterQueueSpec) -> list:
    errs = []
    if len(spec.resource_groups) > MAX_RESOURCE_GROUPS:
        errs.append(f"spec.resourceGroups: must have at most "
                    f"{MAX_RESOURCE_GROUPS} groups")
    seen_resources = set()
    seen_flavors = set()
    for i, rg in enumerate(spec.resource_groups):
        path = f"spec.resourceGroups[{i}]"
        if not rg.covered_resources:
            errs.append(f"{path}.coveredResources: at least one resource required")
        if len(rg.covered_resources) > MAX_RESOURCES_PER_GROUP:
            errs.append(f"{path}.coveredResources: at most "
                        f"{MAX_RESOURCES_PER_GROUP} resources")
        if len(rg.flavors) > MAX_FLAVORS_PER_GROUP:
            errs.append(f"{path}.flavors: at most {MAX_FLAVORS_PER_GROUP} flavors")
        for res in rg.covered_resources:
            if res in seen_resources:
                errs.append(f"{path}.coveredResources: resource {res!r} already "
                            "covered by another resource group")
            seen_resources.add(res)
        for j, fq in enumerate(rg.flavors):
            fpath = f"{path}.flavors[{j}]"
            if fq.name in seen_flavors:
                errs.append(f"{fpath}.name: flavor {fq.name!r} already used in "
                            "another resource group")
            seen_flavors.add(fq.name)
            quota_names = [q.name for q in fq.resources]
            if quota_names != list(rg.covered_resources):
                errs.append(f"{fpath}.resources: must match coveredResources "
                            "in the same order")
            for q in fq.resources:
                qpath = f"{fpath}.resources[{q.name}]"
                if q.nominal_quota < 0:
                    errs.append(f"{qpath}.nominalQuota: must be >= 0")
                if q.borrowing_limit is not None:
                    if q.borrowing_limit < 0:
                        errs.append(f"{qpath}.borrowingLimit: must be >= 0")
                    if not spec.cohort:
                        errs.append(f"{qpath}.borrowingLimit: must be nil when "
                                    "cohort is empty")
                if q.lending_limit is not None:
                    if q.lending_limit < 0:
                        errs.append(f"{qpath}.lendingLimit: must be >= 0")
                    if not spec.cohort:
                        errs.append(f"{qpath}.lendingLimit: must be nil when "
                                    "cohort is empty")
                    elif q.lending_limit > q.nominal_quota:
                        errs.append(f"{qpath}.lendingLimit: must be less than "
                                    "or equal to the nominalQuota")
    return errs


# ---------------------------------------------------------------------------
# ResourceFlavor / LocalQueue (reference: resourceflavor_webhook.go:130)
# ---------------------------------------------------------------------------

def validate_resource_flavor(rf: api.ResourceFlavor) -> list:
    errs = []
    for k, v in rf.spec.node_labels.items():
        if not k:
            errs.append("spec.nodeLabels: empty label key")
        if len(v) > 63:
            errs.append(f"spec.nodeLabels[{k}]: label value too long")
    for i, taint in enumerate(rf.spec.node_taints):
        if not taint.key:
            errs.append(f"spec.nodeTaints[{i}].key: required")
        if taint.effect not in ("NoSchedule", "PreferNoSchedule", "NoExecute"):
            errs.append(f"spec.nodeTaints[{i}].effect: unsupported value "
                        f"{taint.effect!r}")
    return errs


def validate_local_queue(lq: api.LocalQueue) -> list:
    errs = []
    if not _valid_name(lq.spec.cluster_queue):
        errs.append(f"spec.clusterQueue: invalid name {lq.spec.cluster_queue!r}")
    return errs


def validate_local_queue_update(new: api.LocalQueue, old: api.LocalQueue) -> list:
    errs = validate_local_queue(new)
    if new.spec.cluster_queue != old.spec.cluster_queue:
        errs.append("spec.clusterQueue: field is immutable")
    return errs


# ---------------------------------------------------------------------------
# Job webhooks (reference: pkg/controller/jobs/*/\*_webhook.go)
# ---------------------------------------------------------------------------

def default_batch_job(job) -> None:
    """Jobs with a queue label are created suspended
    (reference: job_webhook.go Default)."""
    if job.metadata.labels.get(api.QUEUE_LABEL):
        job.spec.suspend = True


def validate_batch_job_update(new, old) -> list:
    """Queue name is immutable while unsuspended
    (reference: job_webhook.go ValidateUpdate)."""
    errs = []
    old_q = old.metadata.labels.get(api.QUEUE_LABEL, "")
    new_q = new.metadata.labels.get(api.QUEUE_LABEL, "")
    if old_q != new_q and not old.spec.suspend:
        errs.append("metadata.labels[kueue.x-k8s.io/queue-name]: must not be "
                    "changed while the job is not suspended")
    return errs


def default_pod(pod, namespace_excludes: Optional[list] = None) -> None:
    """Gate queue-labeled pods at creation
    (reference: pod_webhook.go:180-190)."""
    excludes = namespace_excludes or []
    if pod.metadata.namespace in excludes:
        return
    if not pod.metadata.labels.get(api.QUEUE_LABEL):
        return
    if pod.status.phase not in ("", "Pending"):
        return
    pod.metadata.labels[api.MANAGED_LABEL] = "true"
    if api.ADMISSION_GATE not in pod.spec.scheduling_gates:
        pod.spec.scheduling_gates.append(api.ADMISSION_GATE)


def propagate_queue_label(deployment) -> bool:
    """Deployment defaulting: copy the queue-name label to the pod
    template (reference: deployment_webhook.go:112; the JAX package keeps
    it in controller/jobs/deployment.py, whose integration waits for
    ROADMAP item 5b). Returns True if changed."""
    q = deployment.metadata.labels.get(api.QUEUE_LABEL)
    if not q:
        return False
    if deployment.spec.template.labels.get(api.QUEUE_LABEL) == q:
        return False
    deployment.spec.template.labels[api.QUEUE_LABEL] = q
    return True


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------

def _raise_if(errs: list, kind: str, name: str) -> None:
    if errs:
        raise Invalid(f"{kind} {name!r} is invalid: " + "; ".join(errs))


def setup_webhooks(store: Store, cfg=None) -> None:
    """Install the defaulting/validating hooks on the sim store
    (reference: webhooks.Setup, webhooks.go:25-37 + per-job
    SetupWebhook calls in jobframework.setup)."""

    def workload_hook(op, obj, old):
        default_workload(obj)
        errs = (validate_workload(obj) if op == "CREATE"
                else validate_workload_update(obj, old))
        _raise_if(errs, "Workload", obj.metadata.name)

    def cluster_queue_hook(op, obj, old):
        _raise_if(validate_cluster_queue(obj), "ClusterQueue", obj.metadata.name)

    def resource_flavor_hook(op, obj, old):
        _raise_if(validate_resource_flavor(obj), "ResourceFlavor",
                  obj.metadata.name)

    def local_queue_hook(op, obj, old):
        errs = (validate_local_queue(obj) if op == "CREATE"
                else validate_local_queue_update(obj, old))
        _raise_if(errs, "LocalQueue", obj.metadata.name)

    def job_hook(op, obj, old):
        if op == "CREATE":
            default_batch_job(obj)
        else:
            _raise_if(validate_batch_job_update(obj, old), "Job",
                      obj.metadata.name)

    excludes = list(cfg.integrations.pod_options.namespace_selector_exclude) \
        if cfg is not None else []

    def pod_hook(op, obj, old):
        if op == "CREATE":
            default_pod(obj, excludes)

    def deployment_hook(op, obj, old):
        propagate_queue_label(obj)

    store.add_admission_hook("Workload", workload_hook)
    store.add_admission_hook("ClusterQueue", cluster_queue_hook)
    store.add_admission_hook("ResourceFlavor", resource_flavor_hook)
    store.add_admission_hook("LocalQueue", local_queue_hook)
    store.add_admission_hook("Job", job_hook)
    store.add_admission_hook("Pod", pod_hook)
    store.add_admission_hook("Deployment", deployment_hook)
