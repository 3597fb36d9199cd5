"""In-memory Workload wrapper (`Info`) plus all status/condition transitions.

Equivalent of the reference's pkg/workload/workload.go:
- Info / PodSetResources (:144-177), NewInfo (:179), ScaledTo (:165)
- FlavorResourceUsage (:209), request totaling (:287-344)
- SetQuotaReservation (:440), SetEvictedCondition (:489)
- Ordering.GetQueueOrderTimestamp (:531-554)
- admission-check state helpers (admissionchecks.go)
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import (
    Condition,
    find_condition,
    is_condition_true,
    set_condition,
)
from kueue_tpu_torch.core.resources import (
    FlavorResource,
    pod_effective_requests,
    scale_requests,
)


def key(wl: api.Workload) -> str:
    return f"{wl.metadata.namespace}/{wl.metadata.name}"


def queue_key(wl: api.Workload) -> str:
    return f"{wl.metadata.namespace}/{wl.spec.queue_name}"


@dataclass(slots=True)
class PodSetResources:
    name: str
    requests: dict  # resource -> total quantity for the whole podset
    count: int
    flavors: dict = field(default_factory=dict)  # resource -> flavor name

    def scaled_to(self, new_count: int) -> "PodSetResources":
        # scale down to per-pod then up, in integer arithmetic, matching
        # the reference's scaleDown/scaleUp (workload.go:336-344)
        per_pod = {k: v // self.count for k, v in self.requests.items()} if self.count else dict(self.requests)
        return PodSetResources(
            name=self.name,
            requests=scale_requests(per_pod, new_count),
            count=new_count,
            flavors=dict(self.flavors),
        )


@dataclass(slots=True)
class AssignmentClusterQueueState:
    """Flavor-fungibility resume state (reference: workload.go /
    flavorassigner LastTriedFlavorIdx)."""

    last_tried_flavor_idx: list = field(default_factory=list)  # per podset: dict[resource -> int]
    cluster_queue_generation: int = 0
    cohort_generation: int = 0

    def next_flavor_to_try(self, ps_idx: int, resource: str) -> int:
        if ps_idx >= len(self.last_tried_flavor_idx):
            return 0
        return self.last_tried_flavor_idx[ps_idx].get(resource, -1) + 1

    def pending_flavors(self) -> bool:
        """True if a next flavor remains to try (reference:
        AssignmentClusterQueueState.PendingFlavors)."""
        for ps in self.last_tried_flavor_idx:
            for idx in ps.values():
                if idx != -1:
                    return True
        return False


def _reclaimable_counts(wl: api.Workload) -> dict:
    return {rp.name: rp.count for rp in wl.status.reclaimable_pods}


def pod_sets_counts_after_reclaim(wl: api.Workload) -> dict:
    reclaim = _reclaimable_counts(wl)
    return {ps.name: ps.count - reclaim.get(ps.name, 0) for ps in wl.spec.pod_sets}


class Info:
    """Pre-processed view of a Workload (reference: workload.Info)."""

    # Class-level defaults so partially-constructed instances
    # (from_assignment, the partial-admission shadow probes) resolve the
    # lazy caches without per-path initialization.
    _key_cache = None
    _arena_slot = -1  # encode-arena slot hint (solver/arena.py)

    def __init__(self, wl: api.Workload, cluster_queue: str = "",
                 excluded_resource_prefixes: Optional[list] = None):
        self.obj = wl
        self.cluster_queue = cluster_queue
        self.last_assignment: Optional[AssignmentClusterQueueState] = None
        self._fru_cache: Optional[dict] = None
        self._fr_keys_cache: Optional[frozenset] = None
        if wl.status.admission is not None:
            self.cluster_queue = wl.status.admission.cluster_queue
            self.total_requests = _total_requests_from_admission(wl)
        else:
            self.total_requests = _total_requests_from_pod_sets(wl)
        if excluded_resource_prefixes:
            for psr in self.total_requests:
                psr.requests = {
                    r: q for r, q in psr.requests.items()
                    if not any(r.startswith(p) for p in excluded_resource_prefixes)
                }

    def update(self, wl: api.Workload) -> None:
        self.obj = wl

    @classmethod
    def from_assignment(cls, wl: api.Workload, cluster_queue: str,
                        assignment) -> "Info":
        """Fast path for assume: the scheduler already computed the
        per-podset requests/flavors (the admission it just wrote came
        from them), so skip re-parsing the admission. The preset usage
        cache also guarantees the cache journal entry equals the solver's
        device-applied usage bit-for-bit."""
        info = cls.__new__(cls)
        info.obj = wl
        info.cluster_queue = cluster_queue
        info.last_assignment = None
        info.total_requests = [
            PodSetResources(
                name=ps.name,
                requests=dict(ps.requests),
                count=ps.count,
                flavors={res: f.name for res, f in (ps.flavors or {}).items()})
            for ps in assignment.pod_sets]
        info._fru_cache = dict(assignment.usage)
        info._fr_keys_cache = None
        return info

    @property
    def key(self) -> str:
        # Memoized: namespace/name are fixed for an Info's lifetime
        # (update() only ever swaps in the same workload's new object),
        # and the f-string build showed up in every per-entry hot loop
        # (arena ensure, preemption scans, requeue bookkeeping).
        k = self._key_cache
        if k is None:
            k = self._key_cache = key(self.obj)
        return k

    def can_be_partially_admitted(self) -> bool:
        return any(ps.count > (ps.min_count if ps.min_count is not None else ps.count)
                   for ps in self.obj.spec.pod_sets)

    def flavor_resource_usage(self) -> dict:
        """FlavorResource -> quantity, memoized: total_requests is fixed
        at Info construction and preemption scans call this per candidate
        per cycle."""
        total = self._fru_cache
        if total is None:
            total = {}
            for psr in self.total_requests:
                for res, q in psr.requests.items():
                    fr = FlavorResource(psr.flavors.get(res, ""), res)
                    total[fr] = total.get(fr, 0) + q
            self._fru_cache = total
        return total

    def flavor_resource_keys(self) -> frozenset:
        """The FlavorResources this workload occupies (memoized)."""
        keys = self._fr_keys_cache
        if keys is None:
            keys = self._fr_keys_cache = frozenset(self.flavor_resource_usage())
        return keys


def _total_requests_from_pod_sets(wl: api.Workload) -> list:
    counts = pod_sets_counts_after_reclaim(wl)
    out = []
    for ps in wl.spec.pod_sets:
        count = counts[ps.name]
        per_pod = pod_effective_requests(ps.template.spec)
        out.append(PodSetResources(name=ps.name, requests=scale_requests(per_pod, count), count=count))
    return out


def _total_requests_from_admission(wl: api.Workload) -> list:
    counts = pod_sets_counts_after_reclaim(wl)
    totals = {ps.name: ps.count for ps in wl.spec.pod_sets}
    out = []
    for psa in wl.status.admission.pod_set_assignments:
        cnt = psa.count if psa.count is not None else totals.get(psa.name, 0)
        psr = PodSetResources(name=psa.name, requests=dict(psa.resource_usage),
                              count=cnt, flavors=dict(psa.flavors))
        if counts.get(psa.name, cnt) != cnt:
            psr = psr.scaled_to(counts[psa.name])
        out.append(psr)
    return out


def mk_request_vector(info: "Info", covers_pods: bool) -> dict:
    """Per-resource totals of an Info's pod sets, with the pods
    resource folded in when the CQ covers it — the ONE request vector
    the MultiKueue capacity-column machinery uses: the
    placement scoring (scheduler's flush / the fused solve's encode)
    and the controller's in-flight capacity debit MUST consume the
    same vector, or consecutive cycles would score against capacity
    the debit never consumed."""
    from kueue_tpu_torch.api.corev1 import RESOURCE_PODS
    tot: dict = {}
    for psr in info.total_requests:
        for r, v in psr.requests.items():
            tot[r] = tot.get(r, 0) + v
        if covers_pods:
            tot[RESOURCE_PODS] = tot.get(RESOURCE_PODS, 0) + psr.count
    return tot


# --- status transitions (reference: workload.go:346-623) ---

def is_active(wl: api.Workload) -> bool:
    return wl.spec.active


def has_quota_reservation(wl: api.Workload) -> bool:
    return is_condition_true(wl.status.conditions, api.WORKLOAD_QUOTA_RESERVED)


def is_admitted(wl: api.Workload) -> bool:
    return is_condition_true(wl.status.conditions, api.WORKLOAD_ADMITTED)


def is_finished(wl: api.Workload) -> bool:
    return is_condition_true(wl.status.conditions, api.WORKLOAD_FINISHED)


def is_evicted(wl: api.Workload) -> bool:
    return is_condition_true(wl.status.conditions, api.WORKLOAD_EVICTED)


def is_evicted_by_pods_ready_timeout(wl: api.Workload) -> Optional[Condition]:
    cond = find_condition(wl.status.conditions, api.WORKLOAD_EVICTED)
    if cond and cond.status == "True" and cond.reason == api.EVICTED_BY_PODS_READY_TIMEOUT:
        return cond
    return None


# lifecycle phases (reference: pkg/workload/workload.go Status())
STATUS_PENDING = "pending"
STATUS_QUOTA_RESERVED = "quotaReserved"
STATUS_ADMITTED = "admitted"
STATUS_FINISHED = "finished"


def status(wl: api.Workload) -> str:
    if is_finished(wl):
        return STATUS_FINISHED
    if is_admitted(wl):
        return STATUS_ADMITTED
    if has_quota_reservation(wl):
        return STATUS_QUOTA_RESERVED
    return STATUS_PENDING


def set_quota_reservation(wl: api.Workload, admission: api.Admission, now: float) -> None:
    wl.status.admission = admission
    msg = f"Quota reserved in ClusterQueue {admission.cluster_queue}"
    set_condition(wl.status.conditions, Condition(
        type=api.WORKLOAD_QUOTA_RESERVED, status="True", reason="QuotaReserved",
        message=msg, observed_generation=wl.metadata.generation), now)
    # reset eviction/preemption state (reference: SetQuotaReservation)
    for ctype in (api.WORKLOAD_EVICTED, api.WORKLOAD_PREEMPTED):
        cond = find_condition(wl.status.conditions, ctype)
        if cond and cond.status == "True":
            cond.status = "False"
            cond.reason = "QuotaReserved"
            cond.message = "Previously: " + cond.message
            cond.last_transition_time = now


def unset_quota_reservation_with_condition(wl: api.Workload, reason: str, message: str,
                                           now: float) -> bool:
    """Returns True if anything changed (reference:
    UnsetQuotaReservationWithCondition)."""
    cond = find_condition(wl.status.conditions, api.WORKLOAD_QUOTA_RESERVED)
    changed = wl.status.admission is not None
    wl.status.admission = None
    if cond is None or cond.status != "False" or cond.reason != reason or cond.message != message:
        changed = True
    set_condition(wl.status.conditions, Condition(
        type=api.WORKLOAD_QUOTA_RESERVED, status="False", reason=reason, message=message,
        observed_generation=wl.metadata.generation), now)
    if is_admitted(wl):
        set_condition(wl.status.conditions, Condition(
            type=api.WORKLOAD_ADMITTED, status="False", reason="NoReservation",
            message="The workload has no reservation",
            observed_generation=wl.metadata.generation), now)
        changed = True
    return changed


def pending_patch_needed(wl: api.Workload, reason: str, message: str) -> bool:
    """Pure predicate: would unset_quota_reservation_with_condition change
    anything? Lets the requeue path skip the status clone entirely for
    the (dominant, at scale) already-Pending re-requeue case."""
    if wl.status.admission is not None or is_admitted(wl):
        return True
    cond = find_condition(wl.status.conditions, api.WORKLOAD_QUOTA_RESERVED)
    return (cond is None or cond.status != "False" or cond.reason != reason
            or cond.message != message)


def set_evicted_condition(wl: api.Workload, reason: str, message: str, now: float) -> None:
    set_condition(wl.status.conditions, Condition(
        type=api.WORKLOAD_EVICTED, status="True", reason=reason, message=message,
        observed_generation=wl.metadata.generation), now)


def set_preempted_condition(wl: api.Workload, reason: str, message: str, now: float) -> None:
    set_condition(wl.status.conditions, Condition(
        type=api.WORKLOAD_PREEMPTED, status="True", reason=reason, message=message,
        observed_generation=wl.metadata.generation), now)


def set_deactivation_target(wl: api.Workload, reason: str, message: str, now: float) -> None:
    """reference: workload.SetDeactivationTarget — marks the workload for
    deactivation by its own reconciler (workload_controller.go:528-534)."""
    set_condition(wl.status.conditions, Condition(
        type=api.WORKLOAD_DEACTIVATION_TARGET, status="True", reason=reason,
        message=message, observed_generation=wl.metadata.generation), now)


def set_requeued_condition(wl: api.Workload, reason: str, message: str, status: bool,
                           now: float) -> None:
    set_condition(wl.status.conditions, Condition(
        type=api.WORKLOAD_REQUEUED, status="True" if status else "False",
        reason=reason, message=message,
        observed_generation=wl.metadata.generation), now)


def sync_admitted_condition(wl: api.Workload, now: float) -> bool:
    """Admitted := QuotaReserved AND all admission checks Ready
    (reference: SyncAdmittedCondition)."""
    admitted = has_quota_reservation(wl) and all(
        acs.state == api.CHECK_STATE_READY for acs in wl.status.admission_checks)
    if admitted == is_admitted(wl):
        return False
    if admitted:
        cond = Condition(type=api.WORKLOAD_ADMITTED, status="True", reason="Admitted",
                         message="The workload is admitted",
                         observed_generation=wl.metadata.generation)
    else:
        cond = Condition(type=api.WORKLOAD_ADMITTED, status="False", reason="NoChecks",
                         message="The workload lost its admission checks readiness",
                         observed_generation=wl.metadata.generation)
    set_condition(wl.status.conditions, cond, now)
    return True


# --- admission check state (reference: pkg/workload/admissionchecks.go) ---

def find_admission_check(wl: api.Workload, name: str) -> Optional[api.AdmissionCheckState]:
    for acs in wl.status.admission_checks:
        if acs.name == name:
            return acs
    return None


def set_admission_check_state(states: list, new: api.AdmissionCheckState, now: float) -> None:
    existing = None
    for acs in states:
        if acs.name == new.name:
            existing = acs
            break
    if existing is None:
        new.last_transition_time = now
        states.append(new)
        return
    if existing.state != new.state:
        existing.last_transition_time = now
    existing.state = new.state
    existing.message = new.message
    existing.pod_set_updates = new.pod_set_updates


def sync_admission_check_conditions(wl: api.Workload, check_names: set, now: float) -> bool:
    """Seed Pending states for newly-relevant checks, drop obsolete ones
    (reference: workload_controller.go:354-365 + SyncAdmittedCondition)."""
    changed = False
    existing = {acs.name for acs in wl.status.admission_checks}
    for name in check_names:
        if name not in existing:
            set_admission_check_state(wl.status.admission_checks, api.AdmissionCheckState(
                name=name, state=api.CHECK_STATE_PENDING), now)
            changed = True
    before = len(wl.status.admission_checks)
    wl.status.admission_checks = [a for a in wl.status.admission_checks if a.name in check_names]
    return changed or len(wl.status.admission_checks) != before


def reset_checks_after_eviction(wl: api.Workload, now: float) -> bool:
    """Once an eviction completes (the quota reservation is gone),
    Retry and stale Ready check states return to Pending so the next
    admission re-runs every check (reference:
    workload.ResetChecksOnEviction). Without this a MultiKueue Retry
    after worker-cluster loss would re-trigger check-based eviction the
    moment the workload re-reserves (an evict/requeue livelock), and a
    stale Ready naming the LOST cluster would admit the re-reserved
    workload with no worker actually holding it. Rejected states are
    left alone — they drive deactivation."""
    changed = False
    for acs in list(wl.status.admission_checks):
        if acs.state in (api.CHECK_STATE_RETRY, api.CHECK_STATE_READY):
            set_admission_check_state(
                wl.status.admission_checks,
                api.AdmissionCheckState(
                    name=acs.name, state=api.CHECK_STATE_PENDING,
                    message="Reset to Pending after eviction"), now)
            changed = True
    return changed


def has_all_checks(wl: api.Workload, check_names: set) -> bool:
    existing = {acs.name for acs in wl.status.admission_checks}
    return check_names <= existing


def has_all_checks_ready(wl: api.Workload) -> bool:
    return all(acs.state == api.CHECK_STATE_READY for acs in wl.status.admission_checks)


def has_retry_checks(wl: api.Workload) -> bool:
    return any(acs.state == api.CHECK_STATE_RETRY for acs in wl.status.admission_checks)


def has_rejected_checks(wl: api.Workload) -> bool:
    return any(acs.state == api.CHECK_STATE_REJECTED for acs in wl.status.admission_checks)


def admission_checks_for_workload(wl: api.Workload, cq_checks: dict) -> set:
    """Resolve the set of checks that apply to this workload, honoring
    per-flavor admissionChecksStrategy (reference: workload.go:625).

    cq_checks: dict[check name -> set of flavor names (empty = all flavors)].
    """
    if wl.status.admission is None:
        # Not yet assigned flavors: all checks whose flavor set is unrestricted
        # apply; restricted ones can't be resolved yet.
        return {name for name, flavors in cq_checks.items() if not flavors}
    assigned = set()
    for psa in wl.status.admission.pod_set_assignments:
        assigned.update(psa.flavors.values())
    out = set()
    for name, flavors in cq_checks.items():
        if not flavors or assigned & flavors:
            out.add(name)
    return out


@dataclass
class Ordering:
    """Queue-order timestamp policy (reference: workload.go:531-554).
    pods_ready_requeuing_timestamp: "Eviction" (default) or "Creation"."""

    pods_ready_requeuing_timestamp: str = "Eviction"

    def queue_order_timestamp(self, wl: api.Workload) -> float:
        if self.pods_ready_requeuing_timestamp == "Eviction":
            cond = is_evicted_by_pods_ready_timeout(wl)
            if cond is not None:
                return cond.last_transition_time
        return wl.metadata.creation_timestamp or 0.0


def queued_wait_time(wl: api.Workload, now: float) -> float:
    """Time since last queued: creation, or latest PodsReadyTimeout
    re-queue (reference: workload.QueuedWaitTime)."""
    queued_at = wl.metadata.creation_timestamp or 0.0
    cond = is_evicted_by_pods_ready_timeout(wl)
    if cond is not None:
        queued_at = max(queued_at, cond.last_transition_time)
    return now - queued_at


def deepcopy(wl: api.Workload) -> api.Workload:
    return copy.deepcopy(wl)


def _clone_admission(adm: Optional[api.Admission]) -> Optional[api.Admission]:
    if adm is None:
        return None
    return api.Admission(
        cluster_queue=adm.cluster_queue,
        pod_set_assignments=[
            api.PodSetAssignment(name=a.name, flavors=dict(a.flavors),
                                 resource_usage=dict(a.resource_usage),
                                 count=a.count)
            for a in adm.pod_set_assignments])


def _clone_check_state(c: api.AdmissionCheckState) -> api.AdmissionCheckState:
    return api.AdmissionCheckState(
        name=c.name, state=c.state, message=c.message,
        last_transition_time=c.last_transition_time,
        pod_set_updates=[
            api.PodSetUpdate(name=u.name, labels=dict(u.labels),
                             annotations=dict(u.annotations),
                             node_selector=dict(u.node_selector),
                             tolerations=[copy.copy(t) for t in u.tolerations])
            for u in c.pod_set_updates])


def clone_status(st: api.WorkloadStatus) -> api.WorkloadStatus:
    """Explicit deep clone of WorkloadStatus. Equivalent to copy.deepcopy
    but ~10x faster: every leaf is a flat dataclass of scalars, so the
    generic deepcopy machinery (memo dicts, reduce protocol) is pure
    overhead on the admit hot path."""
    return api.WorkloadStatus(
        conditions=[copy.copy(c) for c in st.conditions],
        admission=_clone_admission(st.admission),
        requeue_state=(copy.copy(st.requeue_state)
                       if st.requeue_state is not None else None),
        reclaimable_pods=[copy.copy(p) for p in st.reclaimable_pods],
        admission_checks=[_clone_check_state(c) for c in st.admission_checks])


def clone_for_status_update(wl: api.Workload) -> api.Workload:
    """Clone for a status-only write: fresh metadata + deep-copied status,
    shared (immutable on this path) spec. The scheduler's admission /
    eviction / pending patches mutate only status; a full deepcopy of the
    pod templates dominated the admit hot path."""
    out = copy.copy(wl)
    out.metadata = copy.copy(wl.metadata)
    out.status = clone_status(wl.status)
    return out
