"""Core kueue API types.

Equivalents of the reference CRDs:
- Workload / Admission / PodSetAssignment: apis/kueue/v1beta1/workload_types.go
- ClusterQueue / ResourceGroup / quotas / preemption / flavorFungibility:
  apis/kueue/v1beta1/clusterqueue_types.go
- LocalQueue: apis/kueue/v1beta1/localqueue_types.go
- ResourceFlavor: apis/kueue/v1beta1/resourceflavor_types.go
- AdmissionCheck: apis/kueue/v1beta1/admissioncheck_types.go
- WorkloadPriorityClass: apis/kueue/v1beta1/workloadpriorityclass_types.go
- Cohort (hierarchical): apis/kueue/v1alpha1/cohort_types.go
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.corev1 import PodTemplateSpec, ResourceList, Taint, Toleration
from kueue_tpu_torch.api.meta import Condition, LabelSelector, ObjectMeta

# --- constants (reference: apis/kueue/v1beta1/workload_types.go:295-434,
#     pkg/constants) ---

QUEUE_LABEL = "kueue.x-k8s.io/queue-name"
PRIORITY_CLASS_LABEL = "kueue.x-k8s.io/priority-class"
PREBUILT_WORKLOAD_LABEL = "kueue.x-k8s.io/prebuilt-workload-name"
MANAGED_LABEL = "kueue.x-k8s.io/managed"
ADMISSION_GATE = "kueue.x-k8s.io/admission"
RESOURCE_IN_USE_FINALIZER = "kueue.x-k8s.io/resource-in-use"
DEFAULT_PODSET_NAME = "main"
WORKLOAD_PRIORITY_CLASS_SOURCE = "kueue.x-k8s.io/workloadpriorityclass"
POD_PRIORITY_CLASS_SOURCE = "scheduling.k8s.io/priorityclass"

# Workload condition types
WORKLOAD_QUOTA_RESERVED = "QuotaReserved"
WORKLOAD_ADMITTED = "Admitted"
WORKLOAD_FINISHED = "Finished"
WORKLOAD_PODS_READY = "PodsReady"
WORKLOAD_EVICTED = "Evicted"
WORKLOAD_PREEMPTED = "Preempted"
WORKLOAD_REQUEUED = "Requeued"
WORKLOAD_DEACTIVATION_TARGET = "DeactivationTarget"

# Eviction reasons
EVICTED_BY_PREEMPTION = "Preempted"
EVICTED_BY_PODS_READY_TIMEOUT = "PodsReadyTimeout"
EVICTED_BY_ADMISSION_CHECK = "AdmissionCheck"
EVICTED_BY_CLUSTER_QUEUE_STOPPED = "ClusterQueueStopped"
EVICTED_BY_LOCAL_QUEUE_STOPPED = "LocalQueueStopped"
EVICTED_BY_DEACTIVATION = "InactiveWorkload"

# Preemption reasons (reference: workload_types.go, preemption.go:187-192)
IN_CLUSTER_QUEUE_REASON = "InClusterQueue"
IN_COHORT_RECLAMATION_REASON = "InCohortReclamation"
IN_COHORT_FAIR_SHARING_REASON = "InCohortFairSharing"
IN_COHORT_RECLAIM_WHILE_BORROWING_REASON = "InCohortReclaimWhileBorrowing"

# ClusterQueue condition
CLUSTER_QUEUE_ACTIVE = "Active"
LOCAL_QUEUE_ACTIVE = "Active"

# Queueing strategies
STRICT_FIFO = "StrictFIFO"
BEST_EFFORT_FIFO = "BestEffortFIFO"

# Preemption policies
PREEMPTION_NEVER = "Never"
PREEMPTION_LOWER_PRIORITY = "LowerPriority"
PREEMPTION_LOWER_OR_NEWER_EQUAL_PRIORITY = "LowerOrNewerEqualPriority"
PREEMPTION_ANY = "Any"

# BorrowWithinCohort policies
BORROW_WITHIN_COHORT_NEVER = "Never"
BORROW_WITHIN_COHORT_LOWER_PRIORITY = "LowerPriority"

# FlavorFungibility policies
TRY_NEXT_FLAVOR = "TryNextFlavor"
BORROW = "Borrow"
PREEMPT = "Preempt"

# StopPolicy
STOP_POLICY_NONE = "None"
HOLD = "Hold"
HOLD_AND_DRAIN = "HoldAndDrain"

# AdmissionCheck states (reference: admissioncheck_types.go)
CHECK_STATE_RETRY = "Retry"
CHECK_STATE_REJECTED = "Rejected"
CHECK_STATE_READY = "Ready"
CHECK_STATE_PENDING = "Pending"

# AdmissionCheck condition
ADMISSION_CHECK_ACTIVE = "Active"

# Requeued condition reasons (reference: workload_types.go:380-410,
# pkg/controller/core/workload_controller.go:160-200)
WORKLOAD_REACTIVATED = "Reactivated"
WORKLOAD_BACKOFF_FINISHED = "BackoffFinished"
WORKLOAD_LOCAL_QUEUE_RESTARTED = "LocalQueueRestarted"
WORKLOAD_CLUSTER_QUEUE_RESTARTED = "ClusterQueueRestarted"
WORKLOAD_REQUEUING_LIMIT_EXCEEDED = "RequeuingLimitExceeded"

# Workload inadmissible reason (workload_controller.go:285-330)
WORKLOAD_INADMISSIBLE = "Inadmissible"


# --- Workload (reference: workload_types.go:26-293) ---

@dataclass
class PodSet:
    name: str = DEFAULT_PODSET_NAME
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    count: int = 1
    min_count: Optional[int] = None  # enables partial admission when set


@dataclass
class PodSetAssignment:
    name: str = ""
    flavors: dict[str, str] = field(default_factory=dict)  # resource -> flavor name
    resource_usage: ResourceList = field(default_factory=dict)
    count: Optional[int] = None


@dataclass
class Admission:
    cluster_queue: str = ""
    pod_set_assignments: list[PodSetAssignment] = field(default_factory=list)


@dataclass
class PodSetUpdate:
    """Admission-check-injected pod template tweaks
    (reference: workload_types.go:226-284)."""
    name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[Toleration] = field(default_factory=list)


@dataclass
class AdmissionCheckState:
    name: str = ""
    state: str = CHECK_STATE_PENDING
    message: str = ""
    last_transition_time: float = 0.0
    pod_set_updates: list[PodSetUpdate] = field(default_factory=list)


@dataclass
class ReclaimablePod:
    name: str = ""
    count: int = 0


@dataclass
class RequeueState:
    count: int = 0
    requeue_at: Optional[float] = None


@dataclass
class WorkloadSpec:
    pod_sets: list[PodSet] = field(default_factory=list)
    queue_name: str = ""
    priority_class_name: str = ""
    priority: Optional[int] = None
    priority_class_source: str = ""
    active: bool = True


@dataclass
class WorkloadStatus:
    conditions: list[Condition] = field(default_factory=list)
    admission: Optional[Admission] = None
    requeue_state: Optional[RequeueState] = None
    reclaimable_pods: list[ReclaimablePod] = field(default_factory=list)
    admission_checks: list[AdmissionCheckState] = field(default_factory=list)


@dataclass
class Workload:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: WorkloadSpec = field(default_factory=WorkloadSpec)
    status: WorkloadStatus = field(default_factory=WorkloadStatus)

    KIND = "Workload"


def _clone_meta(m: ObjectMeta) -> ObjectMeta:
    from dataclasses import replace as _r
    return ObjectMeta(
        name=m.name, namespace=m.namespace, uid=m.uid,
        generation=m.generation, resource_version=m.resource_version,
        creation_timestamp=m.creation_timestamp,
        deletion_timestamp=m.deletion_timestamp,
        labels=dict(m.labels), annotations=dict(m.annotations),
        finalizers=list(m.finalizers),
        owner_references=[_r(o) for o in m.owner_references])


def _clone_flavor_usage(lst: list) -> list:
    return [FlavorUsage(name=f.name,
                        resources=[ResourceUsage(name=r.name, total=r.total,
                                                 borrowed=r.borrowed)
                                   for r in f.resources])
            for f in lst]


def clone_cluster_queue(cq: "ClusterQueue") -> "ClusterQueue":
    """Hand-rolled deep copy (see clone_workload): ClusterQueues carry up
    to 16 FlavorQuotas x resources in spec plus the same again in status
    usage lists — generic deepcopy of one costs more than a whole
    scheduling decision at the 2k-CQ scale."""
    from dataclasses import replace as _r
    from kueue_tpu_torch.api.meta import LabelSelector, LabelSelectorRequirement
    s = cq.spec
    sel = s.namespace_selector
    if sel is not None:
        sel = LabelSelector(
            match_labels=dict(sel.match_labels),
            match_expressions=[LabelSelectorRequirement(
                key=e.key, operator=e.operator, values=list(e.values))
                for e in sel.match_expressions])
    pre = s.preemption
    pre = ClusterQueuePreemption(
        reclaim_within_cohort=pre.reclaim_within_cohort,
        borrow_within_cohort=(_r(pre.borrow_within_cohort)
                              if pre.borrow_within_cohort is not None
                              else None),
        within_cluster_queue=pre.within_cluster_queue)
    st = cq.status
    return ClusterQueue(
        metadata=_clone_meta(cq.metadata),
        spec=ClusterQueueSpec(
            resource_groups=[ResourceGroup(
                covered_resources=list(rg.covered_resources),
                flavors=[FlavorQuotas(name=fq.name,
                                      resources=[_r(q) for q in fq.resources])
                         for fq in rg.flavors])
                for rg in s.resource_groups],
            cohort=s.cohort,
            queueing_strategy=s.queueing_strategy,
            namespace_selector=sel,
            flavor_fungibility=_r(s.flavor_fungibility),
            preemption=pre,
            admission_checks=list(s.admission_checks),
            admission_checks_strategy=[
                AdmissionCheckStrategyRule(name=r.name,
                                           on_flavors=list(r.on_flavors))
                for r in s.admission_checks_strategy],
            fair_sharing=(_r(s.fair_sharing)
                          if s.fair_sharing is not None else None),
            stop_policy=s.stop_policy),
        status=ClusterQueueStatus(
            conditions=[_r(c) for c in st.conditions],
            flavors_reservation=_clone_flavor_usage(st.flavors_reservation),
            flavors_usage=_clone_flavor_usage(st.flavors_usage),
            pending_workloads=st.pending_workloads,
            reserving_workloads=st.reserving_workloads,
            admitted_workloads=st.admitted_workloads,
            fair_sharing_weighted_share=st.fair_sharing_weighted_share))


def clone_local_queue(lq: "LocalQueue") -> "LocalQueue":
    """Hand-rolled deep copy (see clone_workload)."""
    from dataclasses import replace as _r
    st = lq.status
    return LocalQueue(
        metadata=_clone_meta(lq.metadata),
        spec=LocalQueueSpec(cluster_queue=lq.spec.cluster_queue,
                            stop_policy=lq.spec.stop_policy),
        status=LocalQueueStatus(
            conditions=[_r(c) for c in st.conditions],
            pending_workloads=st.pending_workloads,
            reserving_workloads=st.reserving_workloads,
            admitted_workloads=st.admitted_workloads,
            flavors_reservation=_clone_flavor_usage(st.flavors_reservation),
            flavors_usage=_clone_flavor_usage(st.flavors_usage)))


def clone_workload(wl: Workload) -> Workload:
    """Hand-rolled deep copy of a Workload: semantically identical to
    copy.deepcopy but ~10x faster (no memo bookkeeping / reflection).
    Workloads are the store's hottest kind — every reconciler read and
    every status write copies one, which dominated the control-plane
    profile at the 50k-workload scale. Field lists mirror the dataclasses
    above; tests pin equality against copy.deepcopy."""
    from dataclasses import replace as _r
    from kueue_tpu_torch.api.corev1 import (
        Affinity, Container, NodeAffinity, NodeSelector,
        NodeSelectorRequirement, NodeSelectorTerm, PodSpec, PodTemplateSpec)

    def clone_pod_spec(s):
        aff = s.affinity
        if aff is not None:
            na = aff.node_affinity
            if na is not None and na.required is not None:
                req = NodeSelector(node_selector_terms=[
                    NodeSelectorTerm(match_expressions=[
                        NodeSelectorRequirement(key=e.key, operator=e.operator,
                                                values=list(e.values))
                        for e in t.match_expressions])
                    for t in na.required.node_selector_terms])
                na = NodeAffinity(required=req)
            elif na is not None:
                na = NodeAffinity(required=None)
            aff = Affinity(node_affinity=na)
        return PodSpec(
            containers=[Container(name=c.name, requests=dict(c.requests),
                                  limits=dict(c.limits))
                        for c in s.containers],
            init_containers=[Container(name=c.name, requests=dict(c.requests),
                                       limits=dict(c.limits))
                             for c in s.init_containers],
            node_selector=dict(s.node_selector),
            tolerations=[_r(t) for t in s.tolerations],
            affinity=aff,
            priority_class_name=s.priority_class_name,
            priority=s.priority,
            scheduling_gates=list(s.scheduling_gates),
            restart_policy=s.restart_policy,
            overhead=dict(s.overhead))

    st = wl.status
    return Workload(
        metadata=_clone_meta(wl.metadata),
        spec=WorkloadSpec(
            pod_sets=[PodSet(name=ps.name,
                             template=PodTemplateSpec(
                                 labels=dict(ps.template.labels),
                                 annotations=dict(ps.template.annotations),
                                 spec=clone_pod_spec(ps.template.spec)),
                             count=ps.count, min_count=ps.min_count)
                      for ps in wl.spec.pod_sets],
            queue_name=wl.spec.queue_name,
            priority_class_name=wl.spec.priority_class_name,
            priority=wl.spec.priority,
            priority_class_source=wl.spec.priority_class_source,
            active=wl.spec.active),
        status=WorkloadStatus(
            conditions=[_r(c) for c in st.conditions],
            admission=(Admission(
                cluster_queue=st.admission.cluster_queue,
                pod_set_assignments=[
                    PodSetAssignment(name=a.name, flavors=dict(a.flavors),
                                     resource_usage=dict(a.resource_usage),
                                     count=a.count)
                    for a in st.admission.pod_set_assignments])
                if st.admission is not None else None),
            requeue_state=(_r(st.requeue_state)
                           if st.requeue_state is not None else None),
            reclaimable_pods=[_r(p) for p in st.reclaimable_pods],
            admission_checks=[AdmissionCheckState(
                name=s.name, state=s.state, message=s.message,
                last_transition_time=s.last_transition_time,
                pod_set_updates=[PodSetUpdate(
                    name=u.name, labels=dict(u.labels),
                    annotations=dict(u.annotations),
                    node_selector=dict(u.node_selector),
                    tolerations=[_r(t) for t in u.tolerations])
                    for u in s.pod_set_updates])
                for s in st.admission_checks]))


# --- ClusterQueue (reference: clusterqueue_types.go) ---

@dataclass
class ResourceQuota:
    name: str = ""  # resource name
    nominal_quota: int = 0
    borrowing_limit: Optional[int] = None
    lending_limit: Optional[int] = None


@dataclass
class FlavorQuotas:
    name: str = ""  # flavor name
    resources: list[ResourceQuota] = field(default_factory=list)


@dataclass
class ResourceGroup:
    covered_resources: list[str] = field(default_factory=list)
    flavors: list[FlavorQuotas] = field(default_factory=list)


@dataclass
class BorrowWithinCohort:
    policy: str = BORROW_WITHIN_COHORT_NEVER
    max_priority_threshold: Optional[int] = None


@dataclass
class ClusterQueuePreemption:
    reclaim_within_cohort: str = PREEMPTION_NEVER
    borrow_within_cohort: Optional[BorrowWithinCohort] = None
    within_cluster_queue: str = PREEMPTION_NEVER


@dataclass
class FlavorFungibility:
    when_can_borrow: str = BORROW
    when_can_preempt: str = TRY_NEXT_FLAVOR


@dataclass
class FairSharing:
    # weight in milli-units (reference stores resource.Quantity; 1000 == weight 1)
    weight: int = 1000


@dataclass
class AdmissionCheckStrategyRule:
    name: str = ""
    on_flavors: list[str] = field(default_factory=list)  # empty = all flavors


@dataclass
class ClusterQueueSpec:
    resource_groups: list[ResourceGroup] = field(default_factory=list)
    cohort: str = ""
    queueing_strategy: str = BEST_EFFORT_FIFO
    # None matches nothing; empty selector matches all namespaces.
    namespace_selector: Optional[LabelSelector] = None
    flavor_fungibility: FlavorFungibility = field(default_factory=FlavorFungibility)
    preemption: ClusterQueuePreemption = field(default_factory=ClusterQueuePreemption)
    admission_checks: list[str] = field(default_factory=list)
    admission_checks_strategy: list[AdmissionCheckStrategyRule] = field(default_factory=list)
    fair_sharing: Optional[FairSharing] = None
    stop_policy: str = STOP_POLICY_NONE


@dataclass
class ResourceUsage:
    name: str = ""
    total: int = 0
    borrowed: int = 0


@dataclass
class FlavorUsage:
    name: str = ""
    resources: list[ResourceUsage] = field(default_factory=list)


@dataclass
class ClusterQueueStatus:
    conditions: list[Condition] = field(default_factory=list)
    flavors_reservation: list[FlavorUsage] = field(default_factory=list)
    flavors_usage: list[FlavorUsage] = field(default_factory=list)
    pending_workloads: int = 0
    reserving_workloads: int = 0
    admitted_workloads: int = 0
    fair_sharing_weighted_share: int = 0


@dataclass
class ClusterQueue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterQueueSpec = field(default_factory=ClusterQueueSpec)
    status: ClusterQueueStatus = field(default_factory=ClusterQueueStatus)

    KIND = "ClusterQueue"


# --- Cohort (reference: apis/kueue/v1alpha1/cohort_types.go) ---

@dataclass
class CohortSpec:
    parent: str = ""
    resource_groups: list[ResourceGroup] = field(default_factory=list)


@dataclass
class Cohort:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CohortSpec = field(default_factory=CohortSpec)

    KIND = "Cohort"


# --- LocalQueue (reference: localqueue_types.go) ---

@dataclass
class LocalQueueSpec:
    cluster_queue: str = ""
    stop_policy: str = STOP_POLICY_NONE


@dataclass
class LocalQueueStatus:
    conditions: list[Condition] = field(default_factory=list)
    pending_workloads: int = 0
    reserving_workloads: int = 0
    admitted_workloads: int = 0
    flavors_reservation: list[FlavorUsage] = field(default_factory=list)
    flavors_usage: list[FlavorUsage] = field(default_factory=list)


@dataclass
class LocalQueue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LocalQueueSpec = field(default_factory=LocalQueueSpec)
    status: LocalQueueStatus = field(default_factory=LocalQueueStatus)

    KIND = "LocalQueue"


# --- ResourceFlavor (reference: resourceflavor_types.go:39-90) ---

@dataclass
class ResourceFlavorSpec:
    node_labels: dict[str, str] = field(default_factory=dict)
    node_taints: list[Taint] = field(default_factory=list)
    tolerations: list[Toleration] = field(default_factory=list)


@dataclass
class ResourceFlavor:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceFlavorSpec = field(default_factory=ResourceFlavorSpec)

    KIND = "ResourceFlavor"


# --- AdmissionCheck (reference: admissioncheck_types.go:48-137) ---

@dataclass
class AdmissionCheckParametersReference:
    api_group: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class AdmissionCheckSpec:
    controller_name: str = ""
    parameters: Optional[AdmissionCheckParametersReference] = None


@dataclass
class AdmissionCheckStatus:
    conditions: list[Condition] = field(default_factory=list)


@dataclass
class AdmissionCheck:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: AdmissionCheckSpec = field(default_factory=AdmissionCheckSpec)
    status: AdmissionCheckStatus = field(default_factory=AdmissionCheckStatus)

    KIND = "AdmissionCheck"


# --- WorkloadPriorityClass (reference: workloadpriorityclass_types.go:31) ---

@dataclass
class WorkloadPriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    description: str = ""

    KIND = "WorkloadPriorityClass"


# k8s scheduling.k8s.io PriorityClass analogue (pod priority source)
@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    description: str = ""

    KIND = "PriorityClass"
